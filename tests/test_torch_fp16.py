"""fp16 in the port against the JAX package on the CPU.

* The plain versions of kernels A, A' (paged attention over fp16 and int8
  pools), B/C (RMSNorm), D/E (LayerNorm) and F/G/H (flash attention, a
  length that takes the fused backward and one that takes the two-pass
  backward) in fp16, against the JAX functions with the Pallas kernels in
  interpret mode.
* A 2-layer narrow Llama trained in fp16 from the default loss scale
  2^32 through ``build_train_step`` in both packages: the same loss-scale
  and skipped-step sequences, the applied losses, grad norms, params and
  masters within the tolerances below, and every applied step clear of
  fp16's overflow by more than one rounding (the margins are printed).
* GPT and BERT through ``pretrain_entry`` in fp16: fp16 params, fp32
  masters and moments, the scale's trajectory, and every skipped step
  leaving params, masters, moments and the Adam step count unchanged.
* An fp16 ``finetune`` save and resume, bit for bit with the scaler's
  state.
* Greedy fp16 serving equal to the port's no-cache fp16 argmax, and the
  port's fp16 logits against the JAX forward's.

Tolerances: fp16 outputs within FP16_TOL (an eighth of bf16's 2e-2:
fp16 keeps 3 more mantissa bits) or one fp16 step at the output's largest
magnitude where that is more (the two sides round fp32 values that differ
in their last bits).
"""

import io
import math
import os
import re
from contextlib import redirect_stdout

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import megatron_llm_tpu.ops.pallas.flash_attention as JF
import megatron_llm_tpu.ops.pallas.layernorm as JLN
import megatron_llm_tpu.ops.pallas.rmsnorm as JR
from megatron_llm_tpu.config import ParallelConfig as JaxParallelConfig
from megatron_llm_tpu.config import TrainConfig as JaxTrainConfig
from megatron_llm_tpu.models.language_model import (
    language_model_forward as jax_forward)
from megatron_llm_tpu.models.llama import LlamaModel as JaxLlama
from megatron_llm_tpu.models.llama import llama_config as jax_llama_config
from megatron_llm_tpu.ops.pallas import paged_attention as jpa
from megatron_llm_tpu.optimizer import MegatronOptimizer as JaxOptimizer
from megatron_llm_tpu.quantization import absmax_quantize_int8 as jax_quantize
from megatron_llm_tpu.training import build_train_step as jax_train_step
from megatron_llm_torch import finetune, pretrain_bert, pretrain_gpt, training
from megatron_llm_torch.config import ParallelConfig, TrainConfig
from megatron_llm_torch.models.language_model import language_model_forward
from megatron_llm_torch.models.llama import LlamaModel, llama_config
from megatron_llm_torch.ops.kernels import flash_attention as tfa
from megatron_llm_torch.ops.kernels import layernorm as tln
from megatron_llm_torch.ops.kernels import paged_attention as tpa
from megatron_llm_torch.ops.kernels import rmsnorm as trms
from megatron_llm_torch.optimizer import MegatronOptimizer
from megatron_llm_torch.serving import (
    EngineConfig,
    InferenceEngine,
    SamplingParams,
)
from megatron_llm_torch.training import build_train_step
from megatron_llm_torch.tree import tree_leaves, tree_leaves_with_path
from megatron_llm_torch.weights import params_from_jax, params_to_numpy

torch.set_num_threads(1)
FP16_TOL = 2e-2 / 8
FP16_MAX = 65504.0


@pytest.fixture(autouse=True)
def _interpret():
    mods = (JF, JLN, JR, jpa)
    old = [m._INTERPRET for m in mods]
    for m in mods:
        m._INTERPRET = True
    yield
    for m, o in zip(mods, old):
        m._INTERPRET = o


def _f32(a):
    return np.asarray(a, np.float32)


def _assert_fp16_close(got, want, what=""):
    """Within FP16_TOL, or one fp16 step at ``want``'s largest |value|."""
    got, want = _f32(got), _f32(want)
    m = float(np.abs(want).max())
    tol = max(FP16_TOL, 2.0 ** (math.floor(math.log2(m)) - 10) if m else 0)
    np.testing.assert_allclose(got, want, atol=tol, rtol=0, err_msg=what)


# ---------------------------------------------------------------------------
# the kernels' plain versions in fp16
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("param_dtype", [np.float16, np.float32],
                         ids=["fp16_params", "fp32_params"])
@pytest.mark.parametrize("norm", ["rms", "layer"])
def test_norms_match_the_jax_kernels_in_fp16(norm, param_dtype):
    """B/C and D/E (the autograd function's plain versions) against the
    Pallas kernels' forward and VJP, fp16 rows; parameters in fp16 (the
    models') or fp32."""
    rng = np.random.default_rng(3 if norm == "rms" else 4)
    n, h = 37, 256
    x = rng.standard_normal((n, h)).astype(np.float16)
    g = rng.standard_normal((n, h)).astype(np.float16)
    s = (0.5 + 0.5 * rng.random(h)).astype(param_dtype)
    b = (0.1 * rng.standard_normal(h)).astype(param_dtype)
    if norm == "rms":
        want_y, vjp = jax.vjp(lambda a, c: JR.fused_rms_norm(a, c, 1e-5),
                              jnp.asarray(x), jnp.asarray(s))
        leaves = [torch.from_numpy(t).requires_grad_(True) for t in (x, s)]
        y = trms.fused_rms_norm(*leaves, 1e-5)
    else:
        want_y, vjp = jax.vjp(
            lambda a, c, d: JLN.fused_layer_norm(a, c, d, 1e-5),
            *map(jnp.asarray, (x, s, b)))
        leaves = [torch.from_numpy(t).requires_grad_(True)
                  for t in (x, s, b)]
        y = tln.fused_layer_norm(*leaves, 1e-5)
    want_g = vjp(jnp.asarray(g))
    assert y.dtype == torch.float16
    got_g = torch.autograd.grad(y, leaves, torch.from_numpy(g))
    _assert_fp16_close(y.detach().numpy(), want_y, "y")
    for name, a, w in zip(("dx", "dscale", "dbias"), got_g, want_g):
        assert a.dtype == {np.float16: torch.float16,
                           np.float32: torch.float32}[np.dtype(w.dtype).type]
        _assert_fp16_close(a.numpy(), w, name)


@pytest.mark.parametrize("s,nh,ng", [(128, 4, 2), (96, 4, 1)],
                         ids=["fused_G", "two_pass_H"])
def test_flash_attention_matches_the_jax_kernels_in_fp16(s, nh, ng):
    """F and G (s 128) or H (s 96): the autograd function's plain forward
    and backward against the Pallas forward and VJP, fp16 q, k, v, dO."""
    rng = np.random.default_rng(s + ng)
    d, scale = 32, 0.125
    q = (rng.standard_normal((1, s, nh, d)) * 0.5).astype(np.float16)
    k = (rng.standard_normal((1, s, ng, d)) * 0.5).astype(np.float16)
    v = rng.standard_normal((1, s, ng, d)).astype(np.float16)
    do = rng.standard_normal((1, s, nh, d)).astype(np.float16)

    def jflash(q_, k_, v_):
        return JF.flash_attention(q_, k_, v_, causal=True,
                                  softmax_scale=scale, block_q=32,
                                  block_k=32)

    want_o, vjp = jax.vjp(jflash, *map(jnp.asarray, (q, k, v)))
    want = vjp(jnp.asarray(do))
    leaves = [torch.from_numpy(t).requires_grad_(True) for t in (q, k, v)]
    o = tfa.flash_attention(*leaves, causal=True, softmax_scale=scale)
    assert o.dtype == torch.float16
    got = torch.autograd.grad(o, leaves, torch.from_numpy(do))
    _assert_fp16_close(o.detach().numpy(), want_o, "o")
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == torch.float16
        _assert_fp16_close(a.numpy(), w, name)


def _paged_case(rng, S, M, bs, g, d, live):
    P = 1 + S * M
    k = (rng.standard_normal((P, bs, g, d)) * 30).astype(np.float16)
    v = (rng.standard_normal((P, bs, g, d)) * 30).astype(np.float16)
    bt = (1 + rng.permutation(S * M)).reshape(S, M).astype(np.int32)
    for s in range(S):
        for j in range(-(-int(live[s]) // bs)):
            k[bt[s, j]] = rng.standard_normal((bs, g, d))
            v[bt[s, j]] = rng.standard_normal((bs, g, d))
    return k, v, bt


@pytest.mark.parametrize("quantized", [False, True], ids=["fp16", "int8"])
@pytest.mark.parametrize("kind", ["decode", "prefill"])
def test_paged_attention_matches_the_jax_kernel_in_fp16(kind, quantized):
    """A (fp16 pools) and A' (int8 pools with fp32 scales) with fp16 q:
    the plain version against the Pallas kernel in interpret mode."""
    rng = np.random.default_rng(7 + quantized)
    S, M, bs, nh, g, d = 4, 6, 8, 4, 2, 16
    ctx = np.asarray([0, 5, 17, 31], np.int32)
    C = 1 if kind == "decode" else 16
    q = rng.standard_normal((S, C, nh, d)).astype(np.float16)
    kp, vp, bt = _paged_case(rng, S, M, bs, g, d, ctx + C)
    jk, jv, ks, vs = jnp.asarray(kp), jnp.asarray(vp), None, None
    if quantized:
        jk, ks = jax_quantize(jk, axis=-1)
        jv, vs = jax_quantize(jv, axis=-1)
    tk, tv = (torch.from_numpy(np.asarray(t)) for t in (jk, jv))
    tks, tvs = ((torch.from_numpy(np.asarray(t)) for t in (ks, vs))
                if quantized else (None, None))
    targs = (torch.from_numpy(bt), torch.from_numpy(ctx))
    if kind == "decode":
        want = jpa.paged_attention_decode(
            jnp.asarray(q[:, 0]), jk, jv, jnp.asarray(bt), jnp.asarray(ctx),
            k_scales=ks, v_scales=vs)
        got = tpa.paged_attention_decode(
            torch.from_numpy(q[:, 0].copy()), tk, tv, *targs, k_scales=tks,
            v_scales=tvs)
    else:
        want = jpa.paged_attention_prefill(
            jnp.asarray(q), jk, jv, jnp.asarray(bt), jnp.asarray(ctx),
            k_scales=ks, v_scales=vs)
        got = tpa.paged_attention_prefill(
            torch.from_numpy(q), tk, tv, *targs, k_scales=tks, v_scales=tvs)
    assert got.dtype == torch.float16
    _assert_fp16_close(got.numpy(), want)


# ---------------------------------------------------------------------------
# training in fp16 against the JAX package
# ---------------------------------------------------------------------------

VOCAB, SEQ = 64, 16
STEPS = 24
KW = dict(num_layers=2, hidden_size=64, num_attention_heads=4,
          ffn_hidden_size=96, padded_vocab_size=VOCAB, seq_length=SEQ,
          max_position_embeddings=SEQ, use_flash_attn=True,
          params_dtype="fp16", compute_dtype="fp16")
# applied steps: the lm loss and the grad norm within 2e-4 and 2e-4 of
# the grad norm (the two frameworks round fp16 activations at different
# places: XLA fuses where PyTorch runs op by op), the params after the
# last step within FP16_TOL; the fp32 masters' distance from each other
# within 2e-2 of the distance they moved from their common start, and
# each element within two Adam steps (2 lr) per applied step: Adam
# divides each grad by its own running size, so an element whose grads
# sit at fp16's rounding noise can step the other way (the word
# embedding's worst element: 0.0013 of a 0.0081 move)
LOSS_ATOL, GRAD_NORM_RTOL, MASTER_RTOL = 2e-4, 2e-4, 2e-2
# every applied step's largest |grad| (the port's, where its optimizer
# reads them) at least this far below fp16's largest value: no applied
# step is one rounding from an overflow (an fp16 step is 2^-10 of the
# value), so the equal skip sequences are not decided by a rounding
OVERFLOW_MARGIN = 1 + 2.0 ** -7


def _batch(seed):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, VOCAB, (2, 2, SEQ)).astype(np.int32)
    return {"tokens": toks, "labels": np.roll(toks, -1, axis=-1),
            "loss_mask": (rng.random((2, 2, SEQ)) > 0.2).astype(np.float32)}


def _flat(tree):
    return {"/".join(p): np.asarray(v, np.float32)
            for p, v in tree_leaves_with_path(tree)}


def _jflat(tree):
    return {"/".join(str(getattr(k, "key", k)) for k in p):
            np.asarray(v, np.float32)
            for p, v in jax.tree_util.tree_leaves_with_path(
                jax.device_get(tree))}


def test_fp16_train_steps_match_jax_from_the_default_scale():
    jmodel = JaxLlama(jax_llama_config("tiny", **KW))
    jparams = jmodel.init(jax.random.PRNGKey(7))
    assert {str(t.dtype) for t in jax.tree_util.tree_leaves(jparams)} == \
        {"float16"}
    tcfg = llama_config("tiny", **KW)
    tparams = params_from_jax(jax.device_get(jparams), tcfg, device="cpu")
    kw = dict(micro_batch_size=2, global_batch_size=4, train_iters=STEPS,
              lr=1e-3, weight_decay=0.01, clip_grad=1.0, fp16=True)
    jopt = JaxOptimizer(JaxTrainConfig(**kw), params_dtype=jnp.float16)
    topt = MegatronOptimizer(TrainConfig(**kw), params_dtype=torch.float16)
    jstep = jax_train_step(jmodel, jopt, JaxParallelConfig(), 2)
    tstep = build_train_step(LlamaModel(tcfg, device="cpu"), topt,
                             ParallelConfig(), 2)
    # the largest |grad| of each port step, read where the optimizer gets
    # the grads
    peaks = []
    real = topt.step

    def step(params, grads, state, *a, **k):
        finite = [g.abs().max().item() for g in tree_leaves(grads)
                  if bool(torch.isfinite(g).all())]
        peaks.append(max(finite) if len(finite) == len(tree_leaves(grads))
                     else math.inf)
        return real(params, grads, state, *a, **k)

    topt.step = step
    jp = jax.tree_util.tree_map(jnp.array, jparams)
    js, ts = jopt.init(jp), topt.init(tparams)
    init = _jflat(js.master_params)
    rows = []
    for it in range(STEPS):
        b = _batch(100 + it)
        jp, js, jm = jstep(jp, js, {k: jnp.asarray(v) for k, v in b.items()},
                           jax.random.PRNGKey(it), 1e-3, 0.01)
        tparams, ts, tm = tstep(tparams, ts,
                                {k: torch.from_numpy(v)
                                 for k, v in b.items()}, None, 1e-3, 0.01)
        rows.append((float(jm["loss_scale"]), float(tm["loss_scale"]),
                     int(jm["skipped_iter"]), int(tm["skipped_iter"]),
                     float(jm["lm loss"]), float(tm["lm loss"]),
                     float(jm["grad_norm"]), float(tm["grad_norm"]),
                     peaks[-1]))
    scales_j, scales_t = [r[0] for r in rows], [r[1] for r in rows]
    skip_j, skip_t = [r[2] for r in rows], [r[3] for r in rows]
    assert scales_t == scales_j and skip_t == skip_j, rows
    assert scales_j[0] == 2.0 ** 32 and 5 <= skip_j.count(0) < STEPS
    margins = []
    for r in rows:
        if r[3]:
            continue
        np.testing.assert_allclose(r[5], r[4], atol=LOSS_ATOL, rtol=0)
        np.testing.assert_allclose(r[7], r[6], rtol=GRAD_NORM_RTOL, atol=0)
        margins.append(FP16_MAX / r[8])
    print(f"\nfp16 steps (scale, skipped, loss JAX/port, applied step's "
          f"margin 65504 / max|grad|): "
          + "; ".join(f"{r[0]:g} {r[2]} {r[4]:.5f}/{r[5]:.5f}"
                      for r in rows)
          + f"\nmargins of the applied steps: "
          + ", ".join(f"{m:.3f}" for m in margins))
    assert min(margins) >= OVERFLOW_MARGIN, margins
    got, want = _flat(params_to_numpy(tparams)), _jflat(jp)
    assert got.keys() == want.keys()
    for k in want:
        _assert_fp16_close(got[k], want[k], k)
    m_got = _flat(params_to_numpy(ts.master_params))
    m_want = _jflat(js.master_params)
    assert m_got.keys() == m_want.keys()
    n_applied = skip_j.count(0)
    for k in m_want:
        diff = m_got[k] - m_want[k]
        moved = m_want[k] - init[k]
        assert (np.linalg.norm(diff) <= MASTER_RTOL
                * np.linalg.norm(moved)), k
        assert np.abs(diff).max() <= 2 * 1e-3 * n_applied, k
    assert ts.step == int(js.step) == skip_j.count(0)
    assert float(ts.grad_scaler.scale) == float(js.grad_scaler.scale)


# ---------------------------------------------------------------------------
# the entry points in fp16
# ---------------------------------------------------------------------------

def _scaler_rule(skipped, initial=2.0 ** 32, hysteresis=2, window=1000):
    """The scale of each step under the dynamic scaler's rule for the
    steps' skipped flags (an overflow takes one from the hysteresis and
    halves the scale once it is spent; a clean step restores it)."""
    scale, hys, growth, out = initial, hysteresis, 0, []
    for s in skipped:
        out.append(scale)
        if s:
            hys, growth = hys - 1, 0
            if hys <= 0:
                scale = max(scale / 2, 1.0)
        else:
            hys, growth = hysteresis, growth + 1
            if growth >= window:
                scale, growth = scale * 2, 0
    return out


def _watch_steps(monkeypatch):
    """Wrap ``MegatronOptimizer.step``: record each step's found_inf and
    the dtypes of the params and of the masters and moments, and hold a
    skipped step to its contract: every param, master and moment keeps
    its bits and the Adam step count stays."""
    record = []
    real = MegatronOptimizer.step

    def step(self, params, grads, state, *a, **kw):
        leaves = (tree_leaves(params) + tree_leaves(state.master_params)
                  + tree_leaves(state.exp_avg)
                  + tree_leaves(state.exp_avg_sq))
        before = [t.clone() for t in leaves]
        out = real(self, params, grads, state, *a, **kw)
        new_state, stats = out[1], out[2]
        if stats["found_inf"]:
            assert all(torch.equal(x, y) for x, y in zip(leaves, before))
            assert new_state.step == state.step
        else:
            assert new_state.step == state.step + 1
        record.append((bool(stats["found_inf"]),
                       {t.dtype for t in tree_leaves(params)},
                       {t.dtype for t in leaves[len(tree_leaves(params)):]}))
        return out

    monkeypatch.setattr(MegatronOptimizer, "step", step)
    return record


def _log_lines(capsys):
    return [ln for ln in capsys.readouterr().out.splitlines()
            if ln.startswith(" iteration")]


def _field(line, name):
    return float(re.search(rf"{name}: ([-+0-9.eEnaif]+)", line).group(1))


ENTRY_ARGV = ["--num_layers", "2", "--hidden_size", "64",
              "--num_attention_heads", "4", "--seq_length", "32",
              "--max_position_embeddings", "32", "--micro_batch_size", "2",
              "--global_batch_size", "4", "--lr", "1e-4", "--vocab_size",
              "128", "--log_interval", "1", "--device", "cpu", "--fp16",
              "--train_iters", "24"]


@pytest.mark.parametrize("entry", [pretrain_gpt, pretrain_bert],
                         ids=["gpt", "bert"])
def test_pretrain_entry_trains_in_fp16(entry, capsys, monkeypatch):
    """GPT (``finetune``'s loop) and BERT (``pretrain_entry.run``) from the
    default scale 2^32: fp16 params, fp32 masters and moments, the logged
    scales follow the scaler's rule, at least 5 steps apply with finite
    losses, and every skipped step keeps the state (``_watch_steps``)."""
    record = _watch_steps(monkeypatch)
    assert entry.main(ENTRY_ARGV) == 24
    lines = _log_lines(capsys)
    assert len(lines) == 24 == len(record)
    scales = [_field(ln, "loss scale") for ln in lines]
    skipped = [int(_field(ln, "skipped iterations")) for ln in lines]
    assert skipped == [int(r[0]) for r in record]
    assert scales == _scaler_rule(skipped)
    applied = [_field(ln, "lm loss") for ln, s in zip(lines, skipped)
               if not s]
    assert len(applied) >= 5 and all(math.isfinite(x) for x in applied)
    assert all(r[1] == {torch.float16} and r[2] == {torch.float32}
               for r in record)


def _corpus(tmp_path, vocab=128, docs=120):
    from megatron_llm_torch.data.indexed_dataset import make_builder

    prefix = str(tmp_path / "corpus_text_document")
    rng = np.random.RandomState(1234)
    b = make_builder(prefix + ".bin", vocab_size=vocab)
    for _ in range(docs):
        b.add_item(rng.randint(0, vocab, rng.randint(5, 80)))
        b.end_document()
    b.finalize(prefix + ".idx")
    return prefix


def _train(argv, monkeypatch):
    """finetune.main(argv) -> (iteration, {iteration: exact lm loss})."""
    losses = {}
    real = training.training_log

    def log_line(iteration, train_iters, metrics, *a, **kw):
        losses[iteration] = (metrics["lm loss"], metrics["loss_scale"])
        return real(iteration, train_iters, metrics, *a, **kw)

    monkeypatch.setattr(training, "training_log", log_line)
    with redirect_stdout(io.StringIO()):
        it = finetune.main(argv)
    return it, losses


def _tree(ckpt, it, part):
    from megatron_llm_torch import checkpointing

    return checkpointing._read_tree(
        os.path.join(ckpt, f"iter_{it:07d}", part), "cpu")


def test_fp16_resume_reproduces_the_uninterrupted_run(tmp_path, monkeypatch):
    """An fp16 run of 20 iterations saved at 10, and a run resumed from
    that save: the same losses and scales at 11-20 and the same
    checkpoint at 20 bit for bit, the scaler's state included (the save
    at 10 falls while the scale is still coming down from 2^32)."""
    prefix = _corpus(tmp_path)
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    flags = ["--model_name=llama2", "--num_layers=2", "--hidden_size=64",
             "--num_attention_heads=4", "--seq_length=32",
             "--max_position_embeddings=32", "--micro_batch_size=2",
             "--global_batch_size=4", "--lr=1e-4", "--vocab_size=128",
             "--log_interval=1", "--device", "cpu", "--fp16",
             "--train_iters=20", "--data_path", prefix, "--split",
             "90,10,0"]
    it, run_a = _train(flags + ["--save", a, "--save_interval", "10"],
                       monkeypatch)
    assert it == 20 and run_a[1][1] == 2.0 ** 32
    assert 1.0 < run_a[10][1] < 2.0 ** 32
    it, run_b = _train(flags + ["--load", a, "--load_iters", "10",
                                "--save", b, "--save_interval", "10"],
                       monkeypatch)
    assert it == 20 and sorted(run_b) == list(range(11, 21))
    assert all(run_b[i] == run_a[i] for i in run_b)
    for part in ("model", "optim"):
        ta, tb = _tree(a, 20, part), _tree(b, 20, part)
        assert sorted(ta) == sorted(tb)
        for k in ta:
            assert ta[k].dtype == tb[k].dtype, k
            assert torch.equal(ta[k].reshape(-1).view(torch.uint8),
                               tb[k].reshape(-1).view(torch.uint8)), k
    model = _tree(a, 20, "model")
    assert {t.dtype for t in model.values()} == {torch.float16}
    assert any("scale" in k for k in _tree(a, 20, "optim"))


# ---------------------------------------------------------------------------
# serving in fp16
# ---------------------------------------------------------------------------

SERVE_KW = dict(num_layers=2, seq_length=64, max_position_embeddings=64,
                padded_vocab_size=64, params_dtype="fp16",
                compute_dtype="fp16")
# the port's fp16 logits against the JAX forward's on the same fp16
# params: 2e-2 (the logits reach ~1; each package rounds the fp16
# activations of 2 layers at its own places)
LOGIT_ATOL = 2e-2


@pytest.mark.parametrize("int8_kv", [False, True], ids=["fp16", "int8"])
def test_fp16_serving_is_the_no_cache_argmax_and_jax_logits(int8_kv):
    """The engine over fp16 (or int8) pools serves greedy tokens that are
    the port's no-cache fp16 argmax at every position whose top-2 margin
    exceeds the two paths' largest logit difference, and the no-cache fp16
    logits agree with the JAX package's forward on the same params."""
    jmodel = JaxLlama(jax_llama_config("tiny", use_flash_attn=False,
                                       **SERVE_KW))
    jparams = jmodel.init(jax.random.PRNGKey(0))
    cfg = llama_config("tiny", **SERVE_KW)
    params = params_from_jax(jax.device_get(jparams), cfg, device="cpu")
    assert {t.dtype for t in tree_leaves(params)} == {torch.float16}
    engine = InferenceEngine(
        LlamaModel(cfg, device="cpu"), params,
        EngineConfig(num_slots=4, block_size=8, prefill_chunk=16,
                     max_model_len=64, int8_kv_cache=int8_kv))
    pools = {t.dtype for t in engine._st.pages[0].values()}
    assert pools == ({torch.int8, torch.float32} if int8_kv
                     else {torch.float16})
    prompts = [[(5 * i + 3) % 60 + 1 for i in range(n)]
               for n in (3, 17, 30, 9)]
    reqs = [engine.submit(p, SamplingParams(max_new_tokens=12,
                                            temperature=0.0))
            for p in prompts]
    for _ in range(2000):
        if all(r.state == "done" for r in reqs):
            break
        engine.step()
    checked = 0
    for p, r in zip(prompts, reqs):
        toks = torch.tensor([r.tokens[:-1]])
        with torch.no_grad():
            logits = language_model_forward(params, toks, None, None,
                                             cfg)[0].float()
        want = np.asarray(jax_forward(jparams, jnp.asarray(toks.numpy()),
                                      None, None, jmodel.cfg)[0],
                          np.float32)
        np.testing.assert_allclose(logits.numpy(), want, atol=LOGIT_ATOL,
                                   rtol=0)
        gen = logits[len(p) - 1:]
        top2 = torch.topk(gen, 2, dim=-1).values
        sure = (top2[:, 0] - top2[:, 1]) > 2 * LOGIT_ATOL
        served = torch.tensor(r.tokens[len(p):])
        assert bool((gen.argmax(-1) == served)[sure].all())
        checked += int(sure.sum())
    assert checked >= 10
