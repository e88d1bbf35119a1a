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
    for flags in (["--int8_weights"], ["--alert_rules", "{}"],
                  ["--wandb_logger"]):
        args = build_parser().parse_args(TINY + flags)
        with pytest.raises(NotImplementedError):
            build_server(args, _FakeTokenizer())


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
