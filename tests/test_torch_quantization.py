"""Weight-only int8 (``megatron_llm_torch/quantization.py``) against the
JAX package's ``quantization.py``, on the same params (the JAX init,
carried across by ``weights.params_from_jax``), in fp32 on the CPU:

* the quantised tree: every ``*_q`` equal bit for bit and every
  ``*_scale`` equal, the same leaves kept float (Llama; Mixtral with its
  router intact and its expert banks quantised), and
  ``quantized_weight_bytes`` equal;
* ``dequantize_weight``: equal to the JAX function's in fp32 and in its
  default bf16;
* the quantised model's fp32 logits within 1e-4 of the JAX quantised
  model's (Llama and Mixtral), and the decode over int8 weights;
* ``consume`` frees the float leaves as it goes and gives the same tree;
* the server's ``--int8_weights``: the JAX tool's bytes line, an engine
  over the quantised tree, and its greedy tokens equal to a no-cache
  forward over the same tree.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from megatron_llm_tpu import quantization as jq
from megatron_llm_tpu.models.llama import LlamaModel as JaxLlama
from megatron_llm_tpu.models.llama import llama_config as jax_llama_config
from megatron_llm_tpu.models.mixtral import MixtralModel as JaxMixtral
from megatron_llm_tpu.models.mixtral import (
    mixtral_config as jax_mixtral_config)
from megatron_llm_torch import quantization as tq
from megatron_llm_torch.models.llama import LlamaModel, llama_config
from megatron_llm_torch.models.mixtral import MixtralModel, mixtral_config
from megatron_llm_torch.tree import tree_leaves_with_path
from megatron_llm_torch.weights import params_from_jax

torch.set_num_threads(1)
KW = dict(num_layers=2, hidden_size=64, num_attention_heads=4,
          ffn_hidden_size=160, padded_vocab_size=96, seq_length=64,
          max_position_embeddings=64, use_flash_attn=False)


def _pair(family):
    if family == "llama":
        jmodel = JaxLlama(jax_llama_config("tiny", **KW))
        tmodel = LlamaModel(llama_config("tiny", **KW), device="cpu")
    else:
        kw = dict(KW, num_attention_heads_kv=2, num_experts=4,
                  moe_capacity_factor=2.0)
        jmodel = JaxMixtral(jax_mixtral_config("tiny", **kw))
        tmodel = MixtralModel(mixtral_config("tiny", **kw), device="cpu")
    jparams = jmodel.init(jax.random.PRNGKey(0))
    tparams = params_from_jax(jax.device_get(jparams), tmodel.cfg,
                              device="cpu")
    return jmodel, jparams, tmodel, tparams


@pytest.fixture(scope="module", params=["llama", "mixtral"])
def pair(request):
    return (request.param,) + _pair(request.param)


def _flat_jax(tree):
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        key = "/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                       for p in path)
        out[key] = np.asarray(leaf)
    return out


def _flat_torch(tree):
    return {"/".join(str(p) for p in path): leaf.numpy()
            for path, leaf in tree_leaves_with_path(tree)}


def test_quantized_tree_equals_jax_bit_for_bit(pair):
    family, jmodel, jparams, tmodel, tparams = pair
    want = _flat_jax(jq.quantize_linear_weights_int8(jparams))
    got = _flat_torch(tq.quantize_linear_weights_int8(tparams))
    assert sorted(got) == sorted(want)
    names = [k for k in got if k.endswith("_q")]
    assert any(k.endswith("kernel_q") for k in names)
    for key, val in got.items():
        assert val.dtype == want[key].dtype, key
        np.testing.assert_array_equal(val, want[key], err_msg=key)
    if family == "mixtral":
        # the router stays float, the expert banks are int8
        assert any(k.endswith("router/kernel") for k in got)
        assert not any("router" in k and k.endswith("_q") for k in got)
        assert any(k.endswith("experts/w_in_q") for k in got)
        assert any(k.endswith("experts/w_out_q") for k in got)
    assert tq.quantized_weight_bytes(tq.quantize_linear_weights_int8(
        tparams)) == jq.quantized_weight_bytes(
        jq.quantize_linear_weights_int8(jparams))


@pytest.mark.parametrize("dtype", [None, "fp32"])
def test_dequantize_weight_equals_jax(dtype):
    rng = np.random.default_rng(0)
    k = rng.standard_normal((3, 96, 40)).astype(np.float32)
    k[1, :, 5] = 0.0                        # an all-zero channel: scale 1
    jp = jq.quantize_linear_weights_int8({"kernel": jnp.asarray(k)})
    tp = tq.quantize_linear_weights_int8({"kernel": torch.from_numpy(k)})
    want = jq.dequantize_kernel(jp, None if dtype is None else jnp.float32)
    got = tq.dequantize_kernel(tp, None if dtype is None else torch.float32)
    assert got.dtype == (torch.bfloat16 if dtype is None else torch.float32)
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want, np.float32))


def test_quantized_forward_equals_jax(pair):
    family, jmodel, jparams, tmodel, tparams = pair
    toks = np.random.default_rng(1).integers(0, 96, (2, 12)).astype(
        np.int32)
    jq_params = jq.quantize_linear_weights_int8(jparams)
    tq_params = tq.quantize_linear_weights_int8(tparams)
    want = jmodel(jq_params, jnp.asarray(toks), train=False)
    with torch.no_grad():
        got = tmodel(tq_params, torch.from_numpy(toks).long())
    if family == "mixtral":
        want, got = want[0], got[0]         # the routing aux
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-4)
    # within the JAX test's drift bound of the float model
    with torch.no_grad():
        plain = tmodel(tparams, torch.from_numpy(toks).long())
    if family == "mixtral":
        plain = plain[0]
    assert float((got - plain).abs().max() / plain.std()) < 0.15


def test_quantized_forward_is_the_float_forward_over_dequantised_weights(
        pair):
    """The int8 forward adds nothing to the weights' rounding: its fp32
    logits equal, within 1e-6, the float forward's over a tree whose
    weights are the int8 values times their scales (built here by hand,
    not through ``dequantize_weight``).  ``chip_smoke.py`` holds the same
    at Llama-2-7B's width on the card."""
    family, jmodel, jparams, tmodel, tparams = pair
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, 96, (2, 12))).long()
    qparams = tq.quantize_linear_weights_int8(tparams)

    def dequantised(node):
        if not isinstance(node, dict):
            return node
        out = {k: dequantised(v) for k, v in node.items()
               if not k.endswith(("_q", "_scale"))}
        for k in node:
            if k.endswith("_q"):
                name = k[:-2]
                out[name] = (node[k].float()
                             * node[f"{name}_scale"].float()[..., None, :])
        return out

    deq = dequantised(qparams)
    assert sorted(_flat_torch(deq)) == sorted(_flat_torch(tparams))
    with torch.no_grad():
        got = tmodel(qparams, toks)
        want = tmodel(deq, toks)
    if family == "mixtral":
        got, want = got[0], want[0]
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                               atol=1e-6)


def test_consume_frees_float_leaves_and_gives_the_same_tree():
    _, _, tmodel, tparams = _pair("llama")
    want = _flat_torch(tq.quantize_linear_weights_int8(tparams))
    layers = tparams["transformer"]["layers"]
    got = _flat_torch(tq.quantize_linear_weights_int8(tparams,
                                                      consume=True))
    assert sorted(got) == sorted(want)
    for key in got:
        np.testing.assert_array_equal(got[key], want[key])
    # the float kernels are gone from the source tree
    assert "kernel" not in layers["attention"]["query_key_value"]
    assert "kernel" not in layers["mlp"]["dense_h_to_4h"]
    with pytest.raises(NotImplementedError, match="item 15"):
        tq.quantize_param_specs({}, {})


def test_server_int8_weights_serves_the_quantized_tree(capsys):
    import json
    import threading
    import urllib.request

    from megatron_llm_torch.run_text_generation_server import (
        build_parser,
        build_server,
    )

    class Tok:
        vocab_size, eod, pad = 64, 63, 0

        def tokenize(self, text):
            return [int(t) % 64 for t in text.split()]

        def detokenize(self, ids):
            return " ".join(str(i) for i in ids)

    argv = ["--model_name", "llama2", "--num_layers", "2", "--hidden_size",
            "64", "--num_attention_heads", "4", "--ffn_hidden_size", "96",
            "--padded_vocab_size", "64", "--seq_length", "64",
            "--max_position_embeddings", "64", "--device", "cpu",
            "--serve_num_slots", "2", "--serve_block_size", "8",
            "--serve_prefill_chunk", "16", "--seed", "0", "--serve_engine",
            "--int8_weights"]
    server = build_server(build_parser().parse_args(argv), Tok())
    out = capsys.readouterr().out
    line = [ln for ln in out.splitlines() if "int8 weights:" in ln]
    qb, fb = tq.quantized_weight_bytes(server.engine.params)
    assert line == [f" int8 weights: {qb/1e6:.1f} MB int8 + "
                    f"{fb/1e6:.1f} MB float"]
    qkv = server.engine.params["transformer"]["layers"]["attention"][
        "query_key_value"]
    assert qkv["kernel_q"].dtype == torch.int8 and "kernel" not in qkv
    httpd = server.make_httpd("127.0.0.1", 0)
    t = threading.Thread(target=server.run, daemon=True)
    t.start()
    try:
        prompt = [3, 14, 15, 9, 2, 6, 5]
        req = urllib.request.Request(
            f"http://127.0.0.1:{httpd.server_address[1]}/api",
            data=json.dumps({"prompts": [" ".join(map(str, prompt))],
                             "tokens_to_generate": 6,
                             "temperature": 0.0}).encode(), method="PUT")
        with urllib.request.urlopen(req, timeout=60) as resp:
            got = json.loads(resp.read())["tokens"][0]
        toks = list(prompt)
        with torch.no_grad():
            for _ in range(6):
                logits = server.engine.model(server.engine.params,
                                             torch.tensor([toks]))
                toks.append(int(logits[0, -1].argmax()))
        assert got == toks
    finally:
        server.shutdown()
        server.engine.stop()
        t.join(10)
