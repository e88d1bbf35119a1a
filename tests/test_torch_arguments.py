"""The port's CLI against the JAX package's: the four model flags of the
JAX parser that the port's model implements (Llama-3.1 rope scaling, the
post-LN alias, the Xavier init and the fp32 softmax toggle) parse in
both, and lower into ``TransformerConfig``s that are equal on every
field the two configs share."""

import dataclasses

import pytest

from megatron_llm_tpu import arguments as jax_arguments
from megatron_llm_torch import arguments
from megatron_llm_torch.config import transformer_config_from_args

# arguments both parsers need to lower a config
BASE = ["--num_layers=2", "--hidden_size=64", "--num_attention_heads=4",
        "--seq_length=32", "--max_position_embeddings=32",
        "--micro_batch_size=1", "--global_batch_size=1",
        "--padded_vocab_size=128",
        "--position_embedding_type=rotary", "--use_rms_norm"]

FLAG_ARGVS = [
    ["--rope_llama3_scaling", "8", "1", "4", "8192"],
    ["--apply_residual_connection_post_layernorm"],
    ["--init_method_xavier_uniform"],
    ["--no_attention_softmax_in_fp32"],
    ["--lima_dropout", "--hidden_dropout", "0.2"],
    ["--recompute_granularity", "selective", "--recompute_num_layers", "2"],
    ["--recompute_activations"],
    ["--fused_lm_cross_entropy", "--fused_ce_chunk_size", "4096"],
    ["--no_fused_lm_cross_entropy"],
]


def _jax_config(argv):
    args = jax_arguments.build_base_parser().parse_args(argv)
    args = jax_arguments.validate_args(args, world_size=1)
    return jax_arguments.transformer_config_from_args(args)


def _torch_config(argv):
    args = arguments.build_parser().parse_args(argv)
    return transformer_config_from_args(arguments.validate_args(args))


def _shared_fields(a, b):
    names = ({f.name for f in dataclasses.fields(a)}
             & {f.name for f in dataclasses.fields(b)})
    return sorted(names)


def _value(v):
    # the position type is an enum of each package; compare by name
    return getattr(v, "name", v)


@pytest.mark.parametrize("flags", FLAG_ARGVS,
                         ids=lambda f: f[0].lstrip("-"))
def test_model_flags_lower_as_in_the_jax_package(flags):
    argv = BASE + flags
    want, got = _jax_config(argv), _torch_config(argv)
    fields = _shared_fields(want, got)
    assert len(fields) > 30
    diff = {n: (_value(getattr(want, n)), _value(getattr(got, n)))
            for n in fields
            if _value(getattr(want, n)) != _value(getattr(got, n))}
    assert diff == {}


def test_each_flag_reaches_its_field():
    rope = _torch_config(BASE + FLAG_ARGVS[0])
    assert rope.rope_llama3_scaling == (8.0, 1.0, 4.0, 8192.0)
    assert _torch_config(BASE).rope_llama3_scaling is None
    assert _torch_config(BASE + FLAG_ARGVS[1]).use_post_ln is True
    assert _torch_config(BASE + FLAG_ARGVS[2]).init_method_xavier_uniform
    assert _torch_config(BASE).attention_softmax_in_fp32 is True
    assert _torch_config(BASE + FLAG_ARGVS[3]).attention_softmax_in_fp32 \
        is False
    assert _torch_config(
        BASE + ["--attention_softmax_in_fp32"]).attention_softmax_in_fp32
    lima = _torch_config(BASE + FLAG_ARGVS[4])
    assert lima.lima_dropout and lima.hidden_dropout == 0.2
    sel = _torch_config(BASE + FLAG_ARGVS[5])
    assert (sel.recompute_granularity, sel.recompute_num_layers) == (
        "selective", 2)
    assert _torch_config(BASE + FLAG_ARGVS[6]).recompute_granularity \
        == "selective"
    fused = _torch_config(BASE + FLAG_ARGVS[7])
    assert fused.fused_lm_cross_entropy and fused.fused_ce_chunk_size == 4096
    # the policy leaves a 128-entry vocabulary unfused
    assert _torch_config(BASE).fused_lm_cross_entropy is False


# the checkpoint, evaluation, data, tokenizer, dropout, recompute, fused
# cross-entropy and loop flags the port's trainer reads: flag -> a value
# other than its default (None: a store flag)
NEW_FLAGS = {
    "--lima_dropout": None, "--recompute_num_layers": "4",
    "--recompute_activations": None, "--recompute_method": "block",
    "--fused_lm_cross_entropy": None, "--no_fused_lm_cross_entropy": None,
    "--fused_ce_chunk_size": "1024", "--bias_dropout_fusion": None,
    "--eval_only": None, "--log_params_norm": None,
    "--log_num_zeros_in_grad": None, "--exit_duration_in_mins": "30",
    "--save_interval": "5", "--async_save": None, "--load_iters": "3",
    "--finetune": None, "--use_checkpoint_args": None,
    "--no_save_optim": None, "--no_load_optim": None,
    "--save_total_limit": "3", "--eval_iters": "7", "--eval_interval": "9",
    "--split": "98,2,0", "--data_impl": "infer", "--num_workers": "4",
    "--tokenizer_type": "GPT2BPETokenizer", "--vocab_file": "vocab.json",
    "--merge_file": "merges.txt", "--tokenizer_path": "tok",
    "--tokenizer_model": "tok.model", "--vocab_extra_ids_list": "a,b",
    "--vocab_extra_ids": "2", "--no_new_tokens": None,
    "--variable_seq_lengths": None, "--scalar_loss_mask": "0.5",
    "--data_type": "instruction", "--dataloader_type": "cyclic",
    "--make_vocab_size_divisible_by": "64",
}


def _parsed(argv):
    want = jax_arguments.build_base_parser().parse_args(argv)
    got = arguments.build_parser().parse_args(argv)
    return want, got


@pytest.mark.parametrize("flag", sorted(NEW_FLAGS))
def test_new_flags_parse_as_in_the_jax_package(flag):
    value = NEW_FLAGS[flag]
    argv = [flag] if value is None else [flag, value]
    for args in ([], argv):
        want, got = _parsed(args)
        dests = {a.dest for a in arguments.build_parser()._actions
                 if flag in a.option_strings}
        assert len(dests) == 1
        dest = dests.pop()
        assert getattr(got, dest) == getattr(want, dest), (args, dest)
    assert getattr(got, dest) != getattr(_parsed([])[1], dest)
