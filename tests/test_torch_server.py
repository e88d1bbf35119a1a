"""The port's HTTP server, built in-process by build_server with a tiny
Llama on the CPU and the numeric tokenizer of tests/_serve_replica.py,
on port 0: PUT /api, GET /health, GET /metrics, and the JSON 400s.  And
with ``--load`` and a GPT-2 BPE tokenizer (``build_tokenizer``): it
serves the checkpoint's params, answers a text prompt, and its greedy
tokens are the no-cache path's on those params.  Beside the JAX server
on the same params: the SSE events of ``/api/stream``, the Prometheus
text of ``/metrics``, the demo page; and the drain by ``/drain``."""

import json
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

TINY = ["--model_name", "llama2", "--num_layers", "2", "--hidden_size",
        "64", "--num_attention_heads", "4", "--ffn_hidden_size", "96",
        "--padded_vocab_size", "64", "--seq_length", "64",
        "--max_position_embeddings", "64", "--device", "cpu",
        "--serve_num_slots", "4", "--serve_block_size", "8",
        "--serve_prefill_chunk", "16", "--seed", "0"]


class _FakeTokenizer:
    """The numeric tokenizer of tests/_serve_replica.py."""
    vocab_size = 64
    eod = 63
    pad = 0

    def tokenize(self, text):
        return [int(t) % 64 for t in text.split()]

    def detokenize(self, ids):
        return " ".join(str(i) for i in ids)


@pytest.fixture(scope="module")
def port():
    server = build_server(build_parser().parse_args(TINY), _FakeTokenizer())
    httpd = server.make_httpd("127.0.0.1", 0)
    t = threading.Thread(target=server.run, daemon=True)
    t.start()
    yield httpd.server_address[1]
    server.shutdown()
    server.engine.stop()
    t.join(10)
    assert not t.is_alive()


def _call(port, method, path, payload=None):
    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                 data=data, method=method)
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as exc:
        return exc.code, json.loads(exc.read() or b"{}")


def test_put_api_generates(port):
    code, body = _call(port, "PUT", "/api", {
        "prompts": ["1 2 3 4 5", "9 8 7"], "tokens_to_generate": 6,
        "temperature": 0.0})
    assert code == 200, body
    assert set(body) == {"text", "segments", "tokens"}
    assert [len(t) for t in body["tokens"]] == [11, 9]
    assert body["tokens"][0][:5] == [1, 2, 3, 4, 5]
    assert body["text"][1].split()[:3] == ["9", "8", "7"]
    again = _call(port, "PUT", "/api", {
        "prompts": ["1 2 3 4 5"], "tokens_to_generate": 6,
        "temperature": 0.0})[1]
    assert again["tokens"][0] == body["tokens"][0]


def test_health_and_metrics(port):
    code, body = _call(port, "GET", "/health")
    assert code == 200 and body["status"] == "ok"
    _call(port, "PUT", "/api", {"prompts": ["3 4"], "tokens_to_generate": 2,
                                "temperature": 0.0})
    code, met = _call(port, "GET", "/metrics")
    assert code == 200
    assert met["requests"] >= 1
    assert met["engine"]["paged_kernel"] == "torch"
    assert met["histograms"]["ttft_secs"]["count"] >= 1


@pytest.mark.parametrize("payload", [
    {}, {"prompts": []}, {"prompts": ["1"], "tokens_to_generate": -1},
    {"prompts": ["1"], "top_p": 2.0}, {"prompts": ["1"], "logprobs": True},
    {"prompts": ["1"], "tokens_to_generate": 10000}])
def test_bad_requests_are_json_400s(port, payload):
    code, body = _call(port, "PUT", "/api", payload)
    assert code == 400 and "message" in body


def test_unported_flags_raise():
    """``--serve_speculative`` used to be refused; it now reaches the
    engine with the JAX parser's draft length."""
    args = build_parser().parse_args(TINY + ["--serve_speculative", "1",
                                             "--serve_draft_k", "3"])
    server = build_server(args, _FakeTokenizer())
    try:
        st = server.engine.stats()
        assert st["speculative"] is True and st["draft_k"] == 3
    finally:
        server.shutdown()
        server.engine.stop()


def test_load_with_a_bpe_tokenizer_answers_text(tmp_path):
    from megatron_llm_torch import checkpointing
    from megatron_llm_torch.models.llama import LlamaModel, llama_config
    from megatron_llm_torch.tokenizer import build_tokenizer
    from megatron_llm_torch.tokenizer.bpe import write_byte_bpe_vocab
    from megatron_llm_torch.tree import tree_leaves_with_path

    vf, mf = write_byte_bpe_vocab(str(tmp_path), 384)
    size = ["--num_layers", "2", "--hidden_size", "64",
            "--num_attention_heads", "4", "--ffn_hidden_size", "96",
            "--seq_length", "64", "--max_position_embeddings", "64"]
    cfg = llama_config("tiny", num_layers=2, hidden_size=64,
                       num_attention_heads=4, ffn_hidden_size=96,
                       padded_vocab_size=384, seq_length=64,
                       max_position_embeddings=64)
    model = LlamaModel(cfg, device="cpu")
    saved = model.init(5)
    checkpointing.save_checkpoint(str(tmp_path / "ck"), 6, saved,
                                  args=checkpointing.config_to_args(cfg))
    args = build_parser().parse_args(
        ["--model_name", "llama2", "--device", "cpu", "--serve_num_slots",
         "2", "--serve_block_size", "8", "--serve_prefill_chunk", "16",
         "--load", str(tmp_path / "ck"), "--tokenizer_type",
         "GPT2BPETokenizer", "--vocab_file", vf, "--merge_file", mf] + size)
    tok = build_tokenizer(args)
    assert args.padded_vocab_size == 384
    server = build_server(args, tok)
    for (path, a), (_, b) in zip(tree_leaves_with_path(saved),
                                 tree_leaves_with_path(server.engine.params)):
        assert torch.equal(a, b), path
    httpd = server.make_httpd("127.0.0.1", 0)
    t = threading.Thread(target=server.run, daemon=True)
    t.start()
    try:
        text = "hello world, the served checkpoint"
        code, body = _call(httpd.server_address[1], "PUT", "/api", {
            "prompts": [text], "tokens_to_generate": 8,
            "temperature": 0.0})
    finally:
        server.shutdown()
        server.engine.stop()
        t.join(10)
    assert code == 200, body
    prompt = tok.tokenize(text)
    served = body["tokens"][0]
    assert served[:len(prompt)] == prompt and len(served) == len(prompt) + 8
    assert body["text"][0] == tok.detokenize(served)
    assert body["text"][0].startswith(text)
    want = list(prompt)
    with torch.no_grad():
        for _ in range(8):
            logits = model(saved, torch.tensor([want]))
            want.append(int(logits[0, -1].argmax()))
    assert served == want


# ---------------------------------------------------------------------------
# the shared CLI and --use_checkpoint_args (F3)
# ---------------------------------------------------------------------------

def _jax_server_config(argv):
    """The JAX tool's parser (the base parser and the tool's server group)
    on ``argv``, then its entry point's presets, the checkpoint's
    architecture and validate_args: the model config it builds."""
    import importlib.util
    import os

    import finetune as jax_finetune
    from megatron_llm_tpu import arguments as jax_arguments

    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "tools", "run_text_generation_server.py")
    spec = importlib.util.spec_from_file_location("_jax_server_tool", path)
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    args = tool.extra_args(jax_arguments.build_base_parser()).parse_args(
        argv)
    jax_finetune._apply_model_defaults(args, argv)
    jax_finetune._apply_checkpoint_args(args)
    args = jax_arguments.validate_args(args, world_size=1)
    return args, jax_arguments.transformer_config_from_args(args)


def test_example_argv_serves_a_converted_checkpoint(tmp_path):
    """examples/run_text_generation_server.sh's argv, with llama3, a
    byte-level BPE in place of SentencePiece and the CPU, parses in both
    parsers; the port's server takes the converted checkpoint's
    architecture (--use_checkpoint_args) over its family preset and over
    the tokenizer's padded vocabulary (384 ids here, 512 in the
    checkpoint), and the model configs agree field for field."""
    import dataclasses

    transformers = pytest.importorskip("transformers")
    from test_torch_arguments import example_argv

    from megatron_llm_torch import checkpointing
    from megatron_llm_torch.tokenizer import build_tokenizer
    from megatron_llm_torch.tokenizer.bpe import write_byte_bpe_vocab
    from megatron_llm_torch.tree import tree_leaves_with_path
    from megatron_llm_torch.weights_conversion import hf_to_megatron

    torch.manual_seed(0)
    hf = transformers.LlamaForCausalLM(transformers.LlamaConfig(
        vocab_size=512, hidden_size=64, intermediate_size=176,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        max_position_embeddings=128, rope_theta=5e5,
        rope_scaling={"rope_type": "llama3", "factor": 8.0,
                      "low_freq_factor": 1.0, "high_freq_factor": 4.0,
                      "original_max_position_embeddings": 32},
        tie_word_embeddings=False))
    hf.save_pretrained(str(tmp_path / "hf"))
    ck = str(tmp_path / "ck")
    hf_to_megatron.main(["llama3", "--model_path", str(tmp_path / "hf"),
                         "--out", ck])
    vf, mf = write_byte_bpe_vocab(str(tmp_path), 384)
    entry, argv = example_argv("run_text_generation_server.sh", ck, vf,
                               tmp_path=tmp_path)
    assert entry == "tools/run_text_generation_server.py"
    argv = [{"--model_name=llama2": "--model_name=llama3",
             "SentencePieceTokenizer": "GPT2BPETokenizer"}.get(a, a)
            for a in argv] + ["--merge_file", mf, "--device", "cpu"]
    assert "--use_checkpoint_args" in argv and "--train_iters" in argv

    jax_args, want = _jax_server_config(argv)
    args = build_parser().parse_args(argv)
    tok = build_tokenizer(args)
    assert args.padded_vocab_size == 384
    server = build_server(args, tok)
    try:
        got = server.engine.model.cfg
        fields = sorted({f.name for f in dataclasses.fields(want)}
                        & {f.name for f in dataclasses.fields(got)})
        assert len(fields) > 30
        diff = {n: (getattr(want, n), getattr(got, n)) for n in fields
                if getattr(getattr(want, n), "name", getattr(want, n))
                != getattr(getattr(got, n), "name", getattr(got, n))}
        assert diff == {}
        recorded = checkpointing.load_checkpoint_args(ck)
        for key in ("padded_vocab_size", "num_layers", "hidden_size",
                    "num_attention_heads_kv", "ffn_hidden_size",
                    "rope_theta", "max_position_embeddings"):
            assert getattr(got, key) == recorded[key], key
        assert got.padded_vocab_size == 512
        assert got.rope_llama3_scaling == (8.0, 1.0, 4.0, 32)
        assert got.params_dtype == "bf16"
        params, _, _ = checkpointing.load_checkpoint(ck, device="cpu")
        for (path, a), (_, b) in zip(
                tree_leaves_with_path(params),
                tree_leaves_with_path(server.engine.params)):
            assert torch.equal(a.to(torch.bfloat16), b), path
    finally:
        server.engine.stop()
    # without --use_checkpoint_args the family preset (Llama-3-8B) stands
    plain = build_parser().parse_args(
        [a for a in argv if a != "--use_checkpoint_args"])
    from megatron_llm_torch.run_text_generation_server import (
        model_config_from_args,
    )
    assert model_config_from_args(plain).hidden_size == 4096


def test_server_flags_of_unported_features_raise():
    for flags in (["--int8_weights"], ["--profiler_port", "9012"]):
        args = build_parser().parse_args(TINY + flags)
        with pytest.raises(NotImplementedError):
            build_server(args, _FakeTokenizer())
    # the alert and restart flags are honoured now: the rules given
    # replace the defaults, --serve_alerts 0 runs no sentinel, and the
    # backoff reaches the engine
    rules = ('[{"name": "slow_ttft", "kind": "threshold", '
             '"path": "slo.ttft_secs_p95", "op": ">", "value": 5}]')
    for flags, names in (
            (["--alert_rules", rules, "--serve_restart_backoff_secs",
              "0.25"], ["slow_ttft"]),
            (["--serve_alerts", "0"], None)):
        server = build_server(build_parser().parse_args(TINY + flags),
                              _FakeTokenizer())
        try:
            alerts = server.metrics.alert_engine
            if names is None:
                assert alerts is None
            else:
                assert [r["name"] for r in alerts.rules] == names
                assert server.engine.config.restart_backoff_secs == 0.25
        finally:
            server.shutdown()
            server.engine.stop()


def test_server_serves_mixtral(tmp_path):
    """``--model_name mixtral`` (the mixture of experts) through the HTTP
    server: at the dropless capacity (E / top_k) the greedy tokens are the
    no-cache forward's argmax, whatever the engine's row layouts."""
    argv = ["--model_name", "mixtral", "--num_layers", "2", "--hidden_size",
            "64", "--num_attention_heads", "4", "--num_attention_heads_kv",
            "2", "--ffn_hidden_size", "96", "--num_experts", "4",
            "--moe_capacity_factor", "2.0", "--padded_vocab_size", "64",
            "--seq_length", "64", "--max_position_embeddings", "64",
            "--device", "cpu", "--serve_num_slots", "2",
            "--serve_block_size", "8", "--serve_prefill_chunk", "8",
            "--seed", "0"]
    server = build_server(build_parser().parse_args(argv), _FakeTokenizer())
    httpd = server.make_httpd("127.0.0.1", 0)
    t = threading.Thread(target=server.run, daemon=True)
    t.start()
    try:
        engine = server.engine
        assert type(engine.model).__name__ == "MixtralModel"
        assert engine.model.cfg.num_experts == 4
        prompt = [3, 14, 15, 9, 2, 6, 5, 35, 8, 9, 7, 9]
        code, body = _call(httpd.server_address[1], "PUT", "/api", {
            "prompts": [" ".join(map(str, prompt))],
            "tokens_to_generate": 6, "temperature": 0.0})
        assert code == 200, body
        got = body["tokens"][0]
        toks = list(prompt)
        with torch.no_grad():
            for _ in range(6):
                logits = engine.model(engine.params, torch.tensor([toks]))
                toks.append(int(logits[0, -1].argmax()))
        assert got == toks
    finally:
        server.shutdown()
        server.engine.stop()
        t.join(10)


# ---------------------------------------------------------------------------
# streaming, Prometheus text, the demo page and drain, beside the JAX
# server on the same params
# ---------------------------------------------------------------------------

def _start_jax_server(jmodel, jparams):
    from megatron_llm_tpu.serving import EngineConfig as JaxEngineConfig
    from megatron_llm_tpu.serving import InferenceEngine as JaxEngine
    from megatron_llm_tpu.text_generation_server import (
        MegatronServer as JaxServer,
    )

    engine = JaxEngine(jmodel, jparams, JaxEngineConfig(**SERVE_ENGINE_KW))
    engine.warmup()
    engine.start()
    server = JaxServer(jmodel, jparams, _FakeTokenizer(), engine=engine)
    t = threading.Thread(target=server.run, kwargs={"host": "127.0.0.1",
                                                    "port": 0}, daemon=True)
    t.start()
    deadline = time.monotonic() + 30
    while getattr(server, "httpd", None) is None:
        assert time.monotonic() < deadline, "the JAX server did not bind"
        time.sleep(0.02)
    return server, engine, t


SERVE_ENGINE_KW = dict(num_slots=4, block_size=8, prefill_chunk=16,
                       max_model_len=64)


@pytest.fixture(scope="module")
def pair():
    """The port's server and the JAX server over the same tiny Llama
    params (the JAX init, carried across by weights.py)."""
    import jax

    from megatron_llm_tpu.models.llama import LlamaModel as JaxLlama
    from megatron_llm_tpu.models.llama import llama_config as jax_cfg
    from megatron_llm_torch.models.llama import LlamaModel, llama_config
    from megatron_llm_torch.serving import EngineConfig, InferenceEngine
    from megatron_llm_torch.text_generation_server import MegatronServer
    from megatron_llm_torch.weights import params_from_jax

    kw = dict(num_layers=2, seq_length=64, max_position_embeddings=64,
              padded_vocab_size=64)
    jmodel = JaxLlama(jax_cfg("tiny", use_flash_attn=False, **kw))
    jparams = jmodel.init(jax.random.PRNGKey(0))
    tcfg = llama_config("tiny", **kw)
    engine = InferenceEngine(
        LlamaModel(tcfg, device="cpu"),
        params_from_jax(jax.device_get(jparams), tcfg, device="cpu"),
        EngineConfig(**SERVE_ENGINE_KW))
    engine.warmup()
    engine.start()
    server = MegatronServer(_FakeTokenizer(), engine)
    httpd = server.make_httpd("127.0.0.1", 0)
    t = threading.Thread(target=server.run, daemon=True)
    t.start()
    jserver, jengine, jt = _start_jax_server(jmodel, jparams)
    try:
        yield (server, httpd.server_address[1],
               jserver, jserver.httpd.server_address[1])
    finally:
        server.shutdown()
        engine.stop()
        jserver.httpd.shutdown()
        jengine.stop()
        t.join(10)
        jt.join(10)


def _sse(port, payload, path="/api/stream"):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                 data=json.dumps(payload).encode(),
                                 method="PUT")
    with urllib.request.urlopen(req, timeout=60) as resp:
        assert resp.headers["Content-Type"] == "text/event-stream"
        raw = resp.read().decode()
    events = [json.loads(block[len("data: "):])
              for block in raw.split("\n\n") if block.strip()]
    assert all(block.startswith("data: ")
               for block in raw.split("\n\n") if block.strip())
    return events


def test_sse_events_equal_the_jax_servers(pair):
    _, port, _, jport = pair
    payload = {"prompts": ["3 9 27 17 5 8"], "tokens_to_generate": 7,
               "temperature": 0.0}
    got = _sse(port, payload)
    want = _sse(jport, payload)
    assert got == want
    assert len(got) == 8 and got[-1]["done"] is True
    assert got[-1]["finish_reason"] == "length"
    assert [e["token"] for e in got[:-1]] == got[-1]["tokens"][6:]
    assert _sse(port, payload, "/generate/stream") == got
    # the JSON path serves the same tokens
    assert _call(port, "PUT", "/api", payload)[1]["tokens"][0] == \
        got[-1]["tokens"]
    # a streaming request takes one prompt
    code, body = _call(port, "PUT", "/api/stream",
                       {"prompts": ["1", "2"], "tokens_to_generate": 2})
    assert code == 400 and "single prompt" in body["message"]


def test_prometheus_text_has_the_jax_names(pair):
    from megatron_llm_tpu.telemetry import (
        prometheus_exposition as jax_exposition,
    )

    server, port, _, _ = pair
    _call(port, "PUT", "/api", {"prompts": ["4 5"], "tokens_to_generate": 2,
                                "temperature": 0.0})
    snap = server.metrics.snapshot()
    from megatron_llm_torch.telemetry import prometheus_exposition

    assert prometheus_exposition(snap) == jax_exposition(snap)

    def names(text):
        return {line.split()[2] for line in text.splitlines()
                if line.startswith("# TYPE")}

    for how in ({"path": "/metrics?format=prometheus"},
                {"path": "/metrics", "headers": {"Accept": "text/plain"}}):
        req = urllib.request.Request(f"http://127.0.0.1:{port}{how['path']}",
                                     headers=how.get("headers", {}))
        with urllib.request.urlopen(req, timeout=30) as resp:
            assert resp.headers["Content-Type"].startswith("text/plain")
            text = resp.read().decode()
        assert names(text) == names(jax_exposition(snap))
        assert "megatron_serve_engine_decode_steps" in names(text)
        assert "megatron_serve_histograms_ttft_secs" in names(text)
    # JSON stays the default
    assert "engine" in _call(port, "GET", "/metrics")[1]


def test_index_page_is_served(pair):
    _, port, _, _ = pair
    for path in ("/", "/index.html"):
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                    timeout=30) as resp:
            assert resp.status == 200
            assert resp.headers["Content-Type"].startswith("text/html")
            assert b"<html" in resp.read().lower()


def test_drain_refuses_new_requests_and_finishes_in_flight():
    """``/drain``: new requests get 503 with Retry-After, /health says
    draining, the stream already open finishes with its done record, and
    the server stops (run() returns)."""
    server = build_server(build_parser().parse_args(TINY),
                          _FakeTokenizer())
    httpd = server.make_httpd("127.0.0.1", 0)
    port = httpd.server_address[1]
    t = threading.Thread(target=server.run, daemon=True)
    t.start()
    try:
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/api/stream", method="PUT",
            data=json.dumps({"prompts": ["1 2 3 4"],
                             "tokens_to_generate": 30,
                             "temperature": 0.0}).encode())
        stream = urllib.request.urlopen(req, timeout=60)
        first = stream.readline()
        assert first.startswith(b"data: ")
        code, body = _call(port, "PUT", "/drain")
        assert code == 200 and body == {"status": "draining",
                                        "started": True}
        assert _call(port, "POST", "/drain")[1]["started"] is False
        assert _call(port, "GET", "/health")[1]["status"] == "draining"
        refused = urllib.request.Request(
            f"http://127.0.0.1:{port}/api", method="PUT",
            data=json.dumps({"prompts": ["5"]}).encode())
        with pytest.raises(urllib.error.HTTPError) as exc:
            urllib.request.urlopen(refused, timeout=30)
        assert exc.value.code == 503
        assert exc.value.headers["Retry-After"] == "1"
        assert json.loads(exc.value.read())["draining"] is True
        rest = (first + stream.read()).decode()
        stream.close()
        events = [json.loads(b[len("data: "):])
                  for b in rest.split("\n\n") if b.strip()]
        assert events[-1]["done"] is True
        assert events[-1]["finish_reason"] == "length"
        assert len(events) == 31
        t.join(30)
        assert not t.is_alive(), "the drain did not stop the server"
        assert server.metrics.snapshot()["drained"] == 1
    finally:
        server.shutdown()
        server.engine.stop()
        t.join(10)
