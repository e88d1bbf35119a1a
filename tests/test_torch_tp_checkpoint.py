"""Checkpoints of the port at tp x dp, in the one layout of a tp-1 save
(``test_restore_template.py``'s ``test_restore_on_different_mesh`` and
``test_training.py``'s ``test_checkpoint_resume_exact``, the port's way).

A world of 4 gloo ranks on the CPU (``_torch_tp_world.py``) trains a
tiny bf16 Llama (2 KV groups) at tp 2 x dp 2 under ZeRO-1 through
``training.pretrain`` and saves at iterations 2 and 4; rank 0 writes the
one layout.  The save has the keys, shapes and dtypes of a tp-1 save,
and loads bit for bit into the tree the saving world held: at tp 1 (this
process), at tp 2 (a world of 2), at tp 4 (4 ranks sharing 2 KV groups)
and at tp 2 x dp 2 again.  A resume at tp 2 x dp 2 from iteration 2
continues the uninterrupted run bit for bit to iteration 4, and async
saves at tp 2 x dp 2 write the same payload as the synchronous ones.
The tp-1 engine serves an fp32 save of tp 2 x dp 2 with the greedy
tokens of the one-device forward over the saving world's tree.  A hang
on one rank of a tp-2 world fires the watchdogs: rank 0's writes the
rescue checkpoint from its host snapshot, and no collective runs off
the main thread; a SIGTERM to one rank makes both save at the next
boundary and leave."""

import json
import os
import threading
import urllib.request

import numpy as np
import pytest
import torch

from _torch_tp_world import _family_model, run_world
from megatron_llm_torch import checkpointing
from megatron_llm_torch.config import TrainConfig
from megatron_llm_torch.models.language_model import (
    init_language_model_params,
)
from megatron_llm_torch.optimizer import MegatronOptimizer

torch.set_num_threads(1)
SEQ = 32
BF16 = dict(num_attention_heads_kv=2, padded_vocab_size=256,
            params_dtype="bf16", compute_dtype="bf16")
FP32 = dict(num_attention_heads_kv=2, padded_vocab_size=256)
TRAIN = dict(micro_batch_size=1, global_batch_size=4, train_iters=4,
             lr=1e-3, optimizer="adam", weight_decay=0.01, clip_grad=1.0,
             bf16=True)


def _batch(seed=3):
    rng = np.random.RandomState(seed)
    toks = rng.randint(0, 256, (2, 2, SEQ)).astype(np.int32)
    return {"tokens": toks, "labels": np.roll(toks, -1, axis=-1),
            "loss_mask": np.ones(toks.shape, np.float32)}


def _op(name, op, tp, **kw):
    over = kw.pop("over", BF16)
    train = dict(TRAIN, **kw.pop("train", {}))
    return dict(name=name, op=op, tp=tp, family="llama", sp=tp > 1,
                zero1=kw.pop("zero1", True), seed=11, over=over, train=train,
                batch=_batch(), **kw)


def _payload(path):
    return {k: v.float().numpy() for k, v in torch.load(
        os.path.join(path, checkpointing.PAYLOAD),
        weights_only=True).items()}


def _dtypes(path):
    return {k: checkpointing.dtype_name(v) for k, v in torch.load(
        os.path.join(path, checkpointing.PAYLOAD),
        weights_only=True).items()}


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tp_checkpoint")
    sync, asyn, fp32 = (str(tmp / d) for d in ("sync", "async", "fp32"))
    w4 = run_world(tmp / "w4", "ck", 4, dict(tp=2, ops=[
        _op("train", "train", 2, save_interval=2, save_dir=sync),
        _op("resume", "resume", 2, dir=sync, iteration=2),
        _op("load_tp2dp2", "load", 2, dir=sync, iteration=2),
        _op("load_tp4", "load", 4, dir=sync, iteration=2),
        _op("async", "train", 2, save_interval=1, save_dir=asyn,
            **{"async": True}),
        _op("fp32", "train", 2, save_interval=2, save_dir=fp32, over=FP32,
            train=dict(train_iters=2, bf16=False))]))
    w2 = run_world(tmp / "w2", "ck", 2, dict(tp=2, ops=[
        _op("load_tp2", "load", 2, dir=sync, iteration=2, zero1=False)]))
    return dict(w4=w4, w2=w2, sync=sync, asyn=asyn, fp32=fp32, tmp=tmp)


def _iter_dir(save, it, part="model"):
    return os.path.join(checkpointing.get_checkpoint_name(save, it), part)


def _tp1_model(over=BF16):
    return _family_model("llama", False, **over)


def test_the_save_has_a_tp1_saves_keys_shapes_and_dtypes(saved, tmp_path):
    model = _tp1_model()
    params = model.init(11)
    opt = MegatronOptimizer(TrainConfig(**TRAIN),
                            params_dtype=torch.bfloat16)
    checkpointing.save_checkpoint(str(tmp_path), 2, params,
                                  opt.init(params))
    for part in ("model", "optim"):
        assert _dtypes(_iter_dir(saved["sync"], 2, part)) == \
            _dtypes(_iter_dir(str(tmp_path), 2, part))
        got = _payload(_iter_dir(saved["sync"], 2, part))
        want = _payload(_iter_dir(str(tmp_path), 2, part))
        assert {k: v.shape for k, v in got.items()} == \
            {k: v.shape for k, v in want.items()}
    with open(os.path.join(checkpointing.get_checkpoint_name(
            saved["sync"], 2), "meta.json")) as f:
        meta = json.load(f)
    assert meta["iteration"] == 2 and meta["consumed_samples"] == 8
    assert checkpointing.validate_checkpoint_dir(
        checkpointing.get_checkpoint_name(saved["sync"], 2)) == (True, "ok")


def test_the_saving_worlds_tree_is_the_payload(saved):
    """Rank 0's gather of the world's pieces after iteration 4 is the
    iteration-4 payload, bit for bit."""
    params, opt = saved["w4"][0]["train"]["trees"]
    for part, tree in (("model", params), ("optim", opt)):
        want = _payload(_iter_dir(saved["sync"], 4, part))
        assert set(tree) == set(want)
        for key, (value, _) in tree.items():
            assert np.array_equal(value, want[key]), (part, key)


@pytest.mark.parametrize("layout", ["tp1", "tp2", "tp4", "tp2dp2"])
def test_a_tp2_dp2_save_loads_bit_for_bit(saved, layout):
    want = {part: _payload(_iter_dir(saved["sync"], 2, part))
            for part in ("model", "optim")}
    if layout == "tp1":
        model = _tp1_model()
        tmpl = init_language_model_params(None, model.cfg, device="meta")
        opt = MegatronOptimizer(TrainConfig(**TRAIN),
                                params_dtype=torch.bfloat16)
        params, state, meta = checkpointing.load_checkpoint(
            saved["sync"], iteration=2, params_template=tmpl,
            opt_state_template=opt.init(tmpl), device="cpu")
        assert meta["iteration"] == 2
        got = {"model": checkpointing._flat(params),
               "optim": checkpointing._flat(
                   checkpointing._opt_state_to_tree(state))}
        got = {p: {k: v.float().numpy() for k, v in t.items()}
               for p, t in got.items()}
    else:
        world, name = {"tp2": ("w2", "load_tp2"),
                       "tp4": ("w4", "load_tp4"),
                       "tp2dp2": ("w4", "load_tp2dp2")}[layout]
        trees = saved[world][0][name]["trees"]
        got = {"model": {k: v for k, (v, _) in trees[0].items()},
               "optim": {k: v for k, (v, _) in trees[1].items()}}
    for part in ("model", "optim"):
        assert set(got[part]) == set(want[part])
        for key, value in want[part].items():
            assert np.array_equal(got[part][key], value), (layout, key)


def test_zero1_state_is_a_quarter_a_rank(saved):
    """tp 2 x dp 2 under ZeRO-1: each rank's state is about 1/(tp x dp)
    of the whole (the norms' scales stay whole on every rank), against
    the tp-1 state in the payload."""
    state = ("master_params", "exp_avg", "exp_avg_sq")
    whole = sum(v.nbytes for k, v in _payload(
        _iter_dir(saved["sync"], 2, "optim")).items()
        if checkpointing._key_path(k)[0] in state)
    for res in saved["w4"]:
        assert res["train"]["state_bytes"] < 0.27 * whole
    assert saved["w2"][0]["load_tp2"]["state_bytes"] > 0.49 * whole


def test_a_resume_continues_the_uninterrupted_run_bit_for_bit(saved):
    want = saved["w4"][0]["train"]["trees"]
    got = saved["w4"][0]["resume"]["trees"]
    for a, b in zip(want, got):
        assert set(a) == set(b)
        for key, (value, dtype) in a.items():
            assert b[key][1] == dtype and np.array_equal(value, b[key][0]), \
                key


@pytest.mark.parametrize("iteration", [1, 2, 3, 4])
def test_async_saves_at_tp2_dp2_write_the_sync_payload(saved, iteration):
    assert checkpointing.read_tracker(saved["asyn"]) == (4, False)
    for part in ("model", "optim"):
        got = _payload(_iter_dir(saved["asyn"], iteration, part))
        if iteration % 2 == 0:
            want = _payload(_iter_dir(saved["sync"], iteration, part))
            for key, value in want.items():
                assert np.array_equal(got[key], value), key
        else:
            assert all(np.isfinite(v).all() for v in got.values())
    assert not os.path.exists(checkpointing.get_checkpoint_name(
        saved["asyn"], iteration) + ".tmp")


class _Numbers:
    vocab_size = 256
    eod = 255
    pad = 0

    def tokenize(self, text):
        return [int(t) % 256 for t in text.split()]

    def detokenize(self, ids):
        return " ".join(str(i) for i in ids)


def test_the_tp1_engine_serves_a_tp2_dp2_save(saved):
    from megatron_llm_torch.run_text_generation_server import (
        build_parser,
        build_server,
    )

    args = build_parser().parse_args([
        "--model_name", "llama2", "--num_layers", "2", "--hidden_size",
        "128", "--num_attention_heads", "4", "--num_attention_heads_kv", "2",
        "--ffn_hidden_size", "352", "--padded_vocab_size", "256",
        "--seq_length", "32", "--max_position_embeddings", "32",
        "--device", "cpu", "--serve_num_slots", "2", "--serve_block_size",
        "8", "--serve_prefill_chunk", "16", "--load", saved["fp32"],
        "--serve_engine"])
    server = build_server(args, _Numbers())
    tree = {k: v for k, (v, _) in saved["w4"][0]["fp32"]["trees"][0].items()}
    served = checkpointing._flat(server.engine.params)
    assert set(served) == set(tree)
    for key, value in served.items():
        assert np.array_equal(value.numpy(), tree[key]), key
    httpd = server.make_httpd("127.0.0.1", 0)
    t = threading.Thread(target=server.run, daemon=True)
    t.start()
    prompt = [5, 17, 99, 3, 42]
    try:
        req = urllib.request.Request(
            f"http://127.0.0.1:{httpd.server_address[1]}/api",
            data=json.dumps({"prompts": [" ".join(map(str, prompt))],
                             "tokens_to_generate": 8,
                             "temperature": 0.0}).encode(),
            method="PUT", headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=60) as resp:
            body = json.loads(resp.read())
    finally:
        server.shutdown()
        server.engine.stop()
        t.join(10)
    model = _tp1_model(FP32)
    params = checkpointing._unflat({k: torch.from_numpy(v)
                                    for k, v in tree.items()})
    want = list(prompt)
    with torch.no_grad():
        for _ in range(8):
            logits = model(params, torch.tensor([want]))
            want.append(int(logits[0, -1].argmax()))
    assert body["tokens"][0] == want


# ---------------------------------------------------------------------------
# the runtime's saves at tp 2
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def runtime(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tp_runtime")
    rescue, signal = str(tmp / "rescue"), str(tmp / "signal")
    ranks = run_world(tmp / "w2", "runtime", 2, dict(tp=2, ops=[
        _op("rescue", "rescue", 2, zero1=False, save_dir=rescue,
            faults={1: "hang@3:6"}, watchdog_secs=2.0,
            train=dict(train_iters=4, global_batch_size=2)),
        _op("signal", "signal", 2, zero1=False, save_dir=signal,
            faults={1: "sigterm@3"},
            train=dict(train_iters=6, global_batch_size=2))]))
    return ranks, rescue, signal


def test_a_hung_ranks_watchdog_rescue_is_rank_0s_with_no_collective(
        runtime):
    ranks, rescue, _ = runtime
    for r, res in enumerate(ranks):
        out = res["rescue"]
        assert out["fired"] is True, r
        # every collective of the run (the step's, the snapshots'
        # gathers) ran on the main thread: none on the watchdog's
        assert out["threads"] == ["MainThread"], (r, out["threads"])
        assert out["exit"] is None
    # the snapshot before the hung step 3: iteration 2's state
    it, _ = checkpointing.read_tracker(rescue)
    assert it == 2
    d = checkpointing.get_checkpoint_name(rescue, it)
    assert checkpointing.validate_checkpoint_dir(d) == (True, "ok")
    model = _tp1_model()
    tmpl = init_language_model_params(None, model.cfg, device="meta")
    params, _, meta = checkpointing.load_checkpoint(
        rescue, iteration=it, params_template=tmpl, device="cpu")
    assert meta["iteration"] == it
    assert all(torch.isfinite(v.float()).all()
               for v in checkpointing._flat(params).values())


def test_a_sigterm_to_one_rank_saves_on_every_rank_and_exits(runtime):
    ranks, _, signal = runtime
    assert [res["signal"]["exit"] for res in ranks] == [0, 0]
    assert checkpointing.read_tracker(signal) == (3, False)
    d = checkpointing.get_checkpoint_name(signal, 3)
    assert checkpointing.validate_checkpoint_dir(d) == (True, "ok")
    assert all(res["signal"]["threads"] == ["MainThread"] for res in ranks)
