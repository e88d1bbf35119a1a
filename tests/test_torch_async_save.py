"""Asynchronous checkpoint saves (``checkpointing.save_checkpoint(...,
async_save=True)`` and ``finalize_async_saves``), the JAX package's
semantics on the port's payload: the async payload equals the
synchronous one byte for byte; the leaves are copied when the call
returns, so an in-place step right after it changes nothing saved; the
rename and the tracker wait for ``finalize_async_saves()``; an exit
before it leaves the previous tracker; ``save_io*2`` through the
resilience fault hook gives 2 retries and a valid checkpoint; a failed
background write raises at finalize and leaves no checkpoint."""

import os
import subprocess
import sys

import pytest
import torch

from megatron_llm_torch import checkpointing as ck
from megatron_llm_torch import global_vars
from megatron_llm_torch import resilience as res
from megatron_llm_torch.config import TrainConfig
from megatron_llm_torch.models.llama import LlamaModel, llama_config
from megatron_llm_torch.optimizer import MegatronOptimizer
from megatron_llm_torch.tree import tree_map

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KW = dict(seq_length=16, max_position_embeddings=16, padded_vocab_size=64,
          num_layers=2, hidden_size=32, num_attention_heads=4,
          ffn_hidden_size=64)


@pytest.fixture(autouse=True)
def _clean_state():
    ck.configure_save(total_limit=0, retries=2, retry_backoff=0.01)
    global_vars.reset_counters()
    yield
    ck.finalize_async_saves()
    res.set_save_fault_hook(None)
    ck.configure_save(total_limit=0, retries=2, retry_backoff=0.25)
    global_vars.reset_counters()


def _state():
    cfg = llama_config("tiny", **KW)
    params = tree_map(lambda t: t.to(torch.bfloat16),
                      LlamaModel(cfg, device="cpu").init(0))
    opt = MegatronOptimizer(TrainConfig(micro_batch_size=1,
                                        global_batch_size=1, lr=1e-2),
                            params_dtype=torch.bfloat16)
    state = opt.init(params)
    grads = tree_map(lambda p: torch.ones(p.shape), params)
    params, state, _ = opt.step(params, grads, state, 1e-2)
    return params, state


def _bytes(d):
    return {name: open(os.path.join(d, name), "rb").read()
            for name in ("model/tree.pt", "optim/tree.pt", "meta.json")}


def test_async_payload_equals_the_sync_one_byte_for_byte(tmp_path):
    params, state = _state()
    ck.save_checkpoint(str(tmp_path / "sync"), 1, params, state,
                       consumed_samples=8)
    ck.save_checkpoint(str(tmp_path / "async"), 1, params, state,
                       consumed_samples=8, async_save=True)
    ck.finalize_async_saves()
    assert _bytes(tmp_path / "sync" / "iter_0000001") == \
        _bytes(tmp_path / "async" / "iter_0000001")


def test_a_step_after_the_call_changes_nothing_saved(tmp_path):
    params, state = _state()
    want = {k: v.clone() for k, v in ck._flat(params).items()}
    ck.save_checkpoint(str(tmp_path), 1, params, state, async_save=True)
    for t in ck._flat(params).values():
        t.add_(1.0)                   # the in-place update of a next step
    ck.finalize_async_saves()
    got, _, _ = ck.load_checkpoint(str(tmp_path), device="cpu")
    for k, v in ck._flat(got).items():
        assert torch.equal(v, want[k]), k


def test_tracker_waits_for_finalize(tmp_path):
    params, state = _state()
    ck.save_checkpoint(str(tmp_path), 1, params, state)
    ck.save_checkpoint(str(tmp_path), 2, params, state, async_save=True)
    assert ck.read_tracker(str(tmp_path)) == (1, False)
    assert not (tmp_path / "iter_0000002").exists()
    ck.finalize_async_saves()
    assert ck.read_tracker(str(tmp_path)) == (2, False)
    assert ck.validate_checkpoint_dir(tmp_path / "iter_0000002") == \
        (True, "ok")
    # the next async save finalizes the one before it first
    ck.save_checkpoint(str(tmp_path), 3, params, state, async_save=True)
    ck.save_checkpoint(str(tmp_path), 4, params, state, async_save=True)
    assert ck.read_tracker(str(tmp_path)) == (3, False)


def test_an_exit_before_finalize_keeps_the_previous_tracker(tmp_path):
    code = f"""
import os, sys
sys.path.insert(0, {ROOT!r})
import torch
from megatron_llm_torch import checkpointing as ck
p = {{"w": torch.ones(4, 4)}}
ck.save_checkpoint({str(tmp_path)!r}, 1, p)
ck.save_checkpoint({str(tmp_path)!r}, 2, p, async_save=True)
os._exit(0)
"""
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert ck.read_tracker(str(tmp_path)) == (1, False)
    assert not (tmp_path / "iter_0000002").exists()
    _, _, meta = ck.load_checkpoint(str(tmp_path), device="cpu")
    assert meta["iteration"] == 1


def test_save_io_faults_retry_then_save(tmp_path):
    inj = res.FaultInjector.from_spec("save_io*2")
    res.set_save_fault_hook(inj.maybe_fail_save)
    params, state = _state()
    ck.save_checkpoint(str(tmp_path), 3, params, state, async_save=True)
    ck.finalize_async_saves()
    assert res.recovery_counters()["save_retries"] == 2
    assert ck.validate_checkpoint_dir(tmp_path / "iter_0000003") == \
        (True, "ok")
    assert not list(tmp_path.glob("*.tmp"))


def test_a_failed_background_write_raises_at_finalize(tmp_path,
                                                      monkeypatch):
    def broken(path, tree):
        raise OSError("disk gone")

    monkeypatch.setattr(ck, "_write_tree", broken)
    params, state = _state()
    ck.save_checkpoint(str(tmp_path), 5, params, state, async_save=True)
    with pytest.raises(RuntimeError, match="disk gone"):
        ck.finalize_async_saves()
    assert ck.read_tracker(str(tmp_path)) == (None, False)
    assert not (tmp_path / "iter_0000005").exists()
    assert res.recovery_counters()["save_retries"] == 0
    ck.finalize_async_saves()           # nothing left pending
