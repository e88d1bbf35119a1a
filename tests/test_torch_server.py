"""The port's HTTP server, built in-process by build_server with a tiny
Llama on the CPU and the numeric tokenizer of tests/_serve_replica.py,
on port 0: PUT /api, GET /health, GET /metrics, and the JSON 400s.  And
with ``--load`` and a GPT-2 BPE tokenizer (``build_tokenizer``): it
serves the checkpoint's params, answers a text prompt, and its greedy
tokens are the no-cache path's on those params."""

import json
import threading
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
    args = build_parser().parse_args(TINY + ["--serve_speculative", "1"])
    with pytest.raises(NotImplementedError):
        build_server(args, _FakeTokenizer())


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
