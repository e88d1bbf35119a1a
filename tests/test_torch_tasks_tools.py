"""The port's perf tools (``megatron_llm_torch/tools/``: ``bench_harness``,
``profile_step``, ``decode_bench``, ``mfu_sweep``) at their tiny presets
on the CPU: each runs, and what it prints parses (the Chrome trace holds
the traced step's ops, decode and end-to-end rates are positive, the MFU
line carries ms/iter and tokens/s and says n/a for the CPU's peak)."""

import inspect
import json
import re

import pytest
import torch

from megatron_llm_torch.tools import (
    bench_harness,
    decode_bench,
    mfu_sweep,
    profile_step,
)

torch.set_num_threads(1)


def test_harness_config_and_batch():
    cfg = bench_harness.make_cfg(L=2, h=128, heads=4, ffn=352, seq=64,
                                 vocab=512, remat="none", flash=False)
    assert cfg.recompute_granularity is None and not cfg.use_flash_attn
    assert cfg.params_dtype == cfg.compute_dtype == "bf16"
    assert bench_harness.make_cfg().recompute_granularity == "selective"
    assert bench_harness.BENCH_SHAPE == dict(L=10, h=2048, heads=16,
                                             ffn=5632)
    b = bench_harness.make_batch(2, 8, 64, num_micro=3, device="cpu")
    assert b["tokens"].shape == (3, 2, 8)
    assert torch.equal(b["labels"], torch.roll(b["tokens"], -1, -1))


def test_profile_step_writes_a_chrome_trace(tmp_path, capsys):
    path = profile_step.main(["--preset", "tiny", "--logdir",
                              str(tmp_path), "--steps", "2",
                              "--device", "cpu"])
    out = capsys.readouterr().out
    assert f"trace written: {path}" in out
    assert len(re.findall(r"profile_step: step \d: [0-9.]+ ms", out)) == 2
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name", "") for e in events}
    assert any("mm" in n for n in names), sorted(names)[:20]


def test_decode_bench_prints_rates(capsys):
    results = decode_bench.main(["--preset", "tiny", "--device", "cpu"])
    out = capsys.readouterr().out
    assert len(results) == 3          # bf16, int8 weights, int8 KV
    for r in results:
        assert r["prefill_tps"] > 0 and r["e2e_tps"] > 0
        assert r["decode_tps"] is None or r["decode_tps"] > 0
    assert len(re.findall(
        r"decode\s+(?:[0-9.]+ tok/s|INVALID \(t2-t1 jitter\)) \| prefill "
        r"\s*[0-9.]+ tok/s \| e2e\s+[0-9.]+ tok/s", out)) == 3
    assert re.search(r"speculative\[K\+1=5\]\s+[0-9.]+ tok/s", out)
    with pytest.raises(SystemExit):
        decode_bench.main(["--preset", "tiny", "--variants", "fp8",
                           "--device", "cpu"])


def test_mfu_sweep_prints_a_trial(capsys):
    assert mfu_sweep.main(["tiny", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    m = re.search(r"tiny L2 h128\s+n=\s*([0-9.]+)M dt=\s*([0-9.]+)ms "
                  r"tps=\s*([0-9.]+) mfu=n/a", out)
    assert m and float(m.group(2)) > 0 and float(m.group(3)) > 0
    assert mfu_sweep.main(["nosuchgroup"]) == 1
    # every group's trials take only the port's knobs, and the flash
    # trials a head dim the flash kernels take
    defaults = inspect.signature(mfu_sweep.bench_cfg).parameters
    for trials in mfu_sweep.GROUPS.values():
        for t in trials:
            assert set(t) <= set(defaults)
            kw = {k: v.default for k, v in defaults.items()
                  if k != "label"}
            kw.update(t)
            if kw["flash"]:
                assert kw["h"] // kw["heads"] in (64, 128, 256), t
