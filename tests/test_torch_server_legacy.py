"""The port's server on the legacy generate path, beside the JAX server on
the same tiny Llama params (the JAX init, carried across by
``weights.params_from_jax``), over HTTP on the CPU:

* beam search, logprobs, ``tokens_to_generate`` 0 and a greedy batch of
  ragged prompts: the bodies equal the JAX server's (texts, segments and
  tokens exactly; scores and logprobs within 1e-5);
* F5, ``--serve_engine``: without it ``build_server`` builds no engine
  and every request takes the legacy path (streaming answers 400, as the
  JAX server does); with it, plain requests go to the engine and beam
  search, logprobs and ``tokens_to_generate`` 0 still take the legacy
  path (the engine's dispatch counts do not move for them);
* F6, the replica handshake: ``python -m
  megatron_llm_torch.run_text_generation_server ... --port 0`` writes
  ``PORT <n>`` on stdout once it accepts, answers there, and exits 0 on
  SIGTERM.
"""

import json
import os
import re
import signal
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import pytest
import torch

from megatron_llm_torch.run_text_generation_server import (
    build_parser,
    build_server,
)

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = ["--model_name", "llama2", "--num_layers", "2", "--hidden_size",
        "64", "--num_attention_heads", "4", "--ffn_hidden_size", "96",
        "--padded_vocab_size", "64", "--seq_length", "64",
        "--max_position_embeddings", "64", "--device", "cpu",
        "--serve_num_slots", "4", "--serve_block_size", "8",
        "--serve_prefill_chunk", "16", "--seed", "0", "--serve_alerts", "0"]


class _Tok:
    vocab_size = 64
    eod = 63
    pad = 0

    def tokenize(self, text):
        return [int(t) % 64 for t in text.split()]

    def detokenize(self, ids):
        return " ".join(str(i) for i in ids)


def _call(port, method, path, payload=None):
    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                 data=data, method=method)
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as exc:
        return exc.code, json.loads(exc.read() or b"{}")


def _serve(server):
    t = threading.Thread(target=server.run, kwargs={"host": "127.0.0.1",
                                                    "port": 0}, daemon=True)
    t.start()
    deadline = time.monotonic() + 30
    while getattr(server, "httpd", None) is None:
        assert time.monotonic() < deadline, "the server did not bind"
        time.sleep(0.02)
    return t, server.httpd.server_address[1]


@pytest.fixture(scope="module")
def pair():
    """The port's and the JAX server, legacy path only, on one set of
    params."""
    import jax

    from megatron_llm_tpu.models.llama import LlamaModel as JaxLlama
    from megatron_llm_tpu.models.llama import llama_config as jax_cfg
    from megatron_llm_tpu.text_generation_server import (
        MegatronServer as JaxServer,
    )
    from megatron_llm_torch.models.llama import LlamaModel, llama_config
    from megatron_llm_torch.text_generation_server import MegatronServer
    from megatron_llm_torch.weights import params_from_jax

    kw = dict(num_layers=2, seq_length=64, max_position_embeddings=64,
              padded_vocab_size=64)
    jmodel = JaxLlama(jax_cfg("tiny", use_flash_attn=False, **kw))
    jparams = jmodel.init(jax.random.PRNGKey(0))
    tmodel = LlamaModel(llama_config("tiny", **kw), device="cpu")
    tparams = params_from_jax(jax.device_get(jparams), tmodel.cfg,
                              device="cpu")
    ours = MegatronServer(tmodel, tparams, _Tok())
    theirs = JaxServer(jmodel, jparams, _Tok())
    t1, p1 = _serve(ours)
    t2, p2 = _serve(theirs)
    yield p1, p2
    ours.shutdown()
    theirs.httpd.shutdown()
    theirs.httpd.server_close()
    t1.join(10)
    t2.join(10)


@pytest.mark.parametrize("payload", [
    {"prompts": ["1 2 3 4 5 6 7"], "tokens_to_generate": 6,
     "beam_width": 3},
    {"prompts": ["9 8 7 6"], "tokens_to_generate": 5, "beam_width": 2,
     "stop_token": 12, "length_penalty": 0.5},
    {"prompts": ["5 4 3 2 1", "7 7"], "tokens_to_generate": 6,
     "logprobs": True, "top_k": 1},
    {"prompts": ["3 1 4 1 5"], "tokens_to_generate": 0},
    {"prompts": ["3 1 4 1 5 9 2", "6 5", "3 5 8 9"],
     "tokens_to_generate": 7, "temperature": 0.0},
    {"prompts": ["", "2 7"], "tokens_to_generate": 3, "add_BOS": True,
     "top_k": 1, "logprobs": True},
], ids=["beam", "beam_stop_token", "logprobs", "zero_tokens",
        "greedy_batch", "bos_logprobs"])
def test_legacy_bodies_equal_the_jax_server(pair, payload):
    ours, theirs = pair
    code, got = _call(ours, "PUT", "/api", payload)
    jcode, want = _call(theirs, "PUT", "/api", payload)
    assert code == jcode == 200, (got, want)
    assert sorted(got) == sorted(want)
    for key in ("scores", "logprobs"):
        if key in want:
            a = [x for row in got.pop(key) for x in
                 (row if isinstance(row, list) else [row])]
            b = [x for row in want.pop(key) for x in
                 (row if isinstance(row, list) else [row])]
            assert len(a) == len(b)
            assert max(abs(x - y) for x, y in zip(a, b)) <= 1e-5
    assert got == want


def test_legacy_rejections_match_the_jax_server(pair):
    ours, theirs = pair
    for payload in ({"prompts": ["1", "2"], "beam_width": 2},
                    {"prompts": ["1"], "tokens_to_generate": -1}):
        assert _call(ours, "PUT", "/api", payload)[0] == \
            _call(theirs, "PUT", "/api", payload)[0] == 400
    code, body = _call(ours, "PUT", "/api/stream",
                       {"prompts": ["1 2"], "tokens_to_generate": 2})
    assert code == 400 and "--serve_engine" in body["message"]


def test_serve_engine_selects_the_path_as_in_jax():
    """F5: the flag decides whether an engine exists; with one, beam
    search, logprobs and tokens_to_generate 0 still go legacy."""
    legacy = build_server(build_parser().parse_args(TINY), _Tok())
    assert legacy.engine is None
    legacy.shutdown()
    server = build_server(build_parser().parse_args(
        TINY + ["--serve_engine"]), _Tok())
    t, port = _serve(server)
    try:
        engine = server.engine
        steps = engine.stats()["prefill_chunks"]
        for payload in ({"prompts": ["1 2 3"], "tokens_to_generate": 3,
                         "beam_width": 2},
                        {"prompts": ["1 2 3"], "tokens_to_generate": 3,
                         "logprobs": True},
                        {"prompts": ["1 2 3"], "tokens_to_generate": 0}):
            code, body = _call(port, "PUT", "/api", payload)
            assert code == 200, body
        assert engine.stats()["prefill_chunks"] == steps
        code, body = _call(port, "PUT", "/api", {
            "prompts": ["1 2 3"], "tokens_to_generate": 3,
            "temperature": 0.0})
        assert code == 200
        assert engine.stats()["prefill_chunks"] > steps
    finally:
        server.shutdown()
        engine.stop()
        t.join(10)


def test_port_zero_writes_the_replica_handshake():
    """F6: one ``PORT <n>`` line once the server accepts; SIGTERM drains
    it to exit 0."""
    proc = subprocess.Popen(
        [sys.executable, "-m",
         "megatron_llm_torch.run_text_generation_server", *TINY,
         "--vocab_size", "64", "--host", "127.0.0.1", "--port", "0"],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, env=dict(os.environ, OMP_NUM_THREADS="1"))
    lines = []
    try:
        port = None
        deadline = time.monotonic() + 60
        for line in proc.stdout:
            lines.append(line)
            m = re.fullmatch(r"PORT (\d+)\n", line)
            if m:
                port = int(m.group(1))
                break
            assert time.monotonic() < deadline
        assert port is not None, "".join(lines)
        assert _call(port, "GET", "/health")[1]["status"] == "ok"
        code, body = _call(port, "PUT", "/api", {
            "prompts": ["1 2 3"], "tokens_to_generate": 2, "top_k": 1})
        assert code == 200 and len(body["tokens"][0]) == 5
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
        proc.wait(30)
        proc.stdout.close()
