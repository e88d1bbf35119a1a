"""The port's correctness harness (``megatron_llm_torch.verify_correctness``,
the twin of the repo's ``verify_correctness.py``) on the CPU: an HF golden
model converted by the port's converter passes within ``--atol``, and the
same checkpoint with two query heads' QKV columns swapped fails with exit
code 1, so the harness is a real check."""

import pytest
import torch

from megatron_llm_torch import checkpointing, verify_correctness
from megatron_llm_torch.weights_conversion import hf_to_megatron

transformers = pytest.importorskip("transformers")

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def converted(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("verify")
    torch.manual_seed(0)
    hf = transformers.LlamaForCausalLM(transformers.LlamaConfig(
        vocab_size=128, hidden_size=64, intermediate_size=176,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        max_position_embeddings=128, rms_norm_eps=1e-5, rope_theta=5e5,
        rope_scaling={"rope_type": "llama3", "factor": 8.0,
                      "low_freq_factor": 1.0, "high_freq_factor": 4.0,
                      "original_max_position_embeddings": 32},
        tie_word_embeddings=False)).eval()
    hf.save_pretrained(str(tmp / "hf"))
    hf_to_megatron.main(["llama3", "--model_path", str(tmp / "hf"), "--out",
                         str(tmp / "ck")])
    return tmp


def _argv(tmp, ck):
    # examples/verify.sh's flags, smaller, on the CPU
    return ["--model_name=llama3", "--load", str(tmp / ck),
            "--huggingface_path", str(tmp / "hf"), "--iters", "2",
            "--batch", "2", "--seq_length", "64", "--device", "cpu"]


def test_converted_checkpoint_passes(converted, capsys):
    res = verify_correctness.run(_argv(converted, "ck"))
    assert res["ok"] and res["max_abs_err"] < 1e-4
    assert res["max_loss_delta"] < 1e-5
    out = capsys.readouterr().out
    assert "mean max-abs logits error over 2 iters" in out and " OK" in out
    verify_correctness.main(_argv(converted, "ck"))


def test_swapped_heads_fail(converted, capsys):
    params, _, meta = checkpointing.load_checkpoint(str(converted / "ck"),
                                                    device="cpu")
    qkv = params["transformer"]["layers"]["attention"]["query_key_value"]
    d = 16          # columns [ng, q heads + 2, d]: swap q heads 0 and 1
    k = qkv["kernel"].clone()
    k[:, :, :d], k[:, :, d:2 * d] = qkv["kernel"][:, :, d:2 * d], \
        qkv["kernel"][:, :, :d]
    qkv["kernel"] = k
    checkpointing.save_checkpoint(str(converted / "bad"), 0, params,
                                  args=meta["args"], release=True)
    with pytest.raises(SystemExit) as exc:
        verify_correctness.main(_argv(converted, "bad"))
    assert exc.value.code == 1
    out = capsys.readouterr().out
    assert " FAIL" in out


def test_converted_mixtral_passes(tmp_path, capsys):
    """``--model_name=mixtral`` through MODEL_REGISTRY: the converter
    records the dropless capacity, so the port's logits are HF's."""
    torch.manual_seed(1)
    hf = transformers.MixtralForCausalLM(transformers.MixtralConfig(
        vocab_size=128, hidden_size=64, intermediate_size=96,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        num_local_experts=4, num_experts_per_tok=2,
        max_position_embeddings=128, tie_word_embeddings=False)).eval()
    hf.save_pretrained(str(tmp_path / "hf"))
    hf_to_megatron.main(["mixtral", "--model_path", str(tmp_path / "hf"),
                         "--out", str(tmp_path / "ck")])
    argv = [a.replace("llama3", "mixtral") for a in _argv(tmp_path, "ck")]
    res = verify_correctness.run(argv)
    assert res["ok"] and res["max_abs_err"] < 1e-4, res
    assert " OK" in capsys.readouterr().out
