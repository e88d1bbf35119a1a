"""The port's MSDP prompting (``megatron_llm_torch/tasks/msdp/prompt.py``,
on the port's legacy ``text_generation.api.generate``) against the root
package's, from the same JAX-initialised GPT (2 layers, h 64, seq 256,
a byte-level BPE of 300 ids; carried by ``megatron_llm_torch/weights.py``)
in fp32: the greedy tokens of every prompt equal and the output files
equal, for knowledge and response prompting; and ``tasks.main`` end to
end on the CPU: MSDP-PROMPT-KNWL from a ``--load`` checkpoint, then
MSDP-EVAL-F1 on its output.  The JAX model takes core attention."""

import copy
import json

import jax
import pytest
import torch

import megatron_llm_tpu.text_generation.api as j_api
import megatron_llm_torch.text_generation.api as p_api
import tasks.msdp.prompt as j_prompt
from megatron_llm_tpu.config import TransformerConfig as JaxConfig
from megatron_llm_tpu.models.gpt import GPTModel as JaxGPT
from megatron_llm_torch import checkpointing
from megatron_llm_torch.config import TransformerConfig
from megatron_llm_torch.models.gpt import GPTModel
from megatron_llm_torch.tasks import main as tasks_main
from megatron_llm_torch.tasks.msdp import evaluate as p_meval
from megatron_llm_torch.tasks.msdp import prompt as p_prompt
from megatron_llm_torch.tokenizer.bpe import write_byte_bpe_vocab
from megatron_llm_torch.weights import params_from_jax

torch.set_num_threads(1)
SEQ, NEW = 256, 6
TINY = dict(num_layers=2, hidden_size=64, num_attention_heads=4,
            ffn_hidden_size=128, padded_vocab_size=384, seq_length=SEQ,
            max_position_embeddings=SEQ, hidden_dropout=0.0,
            attention_dropout=0.0)
FLAGS = ["--num_layers", "2", "--hidden_size", "64",
         "--num_attention_heads", "4", "--ffn_hidden_size", "128",
         "--seq_length", str(SEQ), "--max_position_embeddings", str(SEQ),
         "--hidden_dropout", "0", "--attention_dropout", "0",
         "--out_seq_length", str(NEW), "--device", "cpu"]


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    d = tmp_path_factory.mktemp("msdp")
    vf, mf = write_byte_bpe_vocab(str(d), 300)
    (d / "kprompts.jsonl").write_text(
        json.dumps({"Cats what about cats": ["( tell me ) Cats => A cat."]})
        + "\n")
    (d / "rprompts.txt").write_text(
        "Topic: Dogs. Knowledge: Dogs bark. Context: hi Response: woof\n")
    (d / "input.tsv").write_text(
        "Cats\tyo [SEP] what about cats\tA cat purrs.\n\n"
        "Moon\tis it cheese?\tThe moon is rock.\n")
    jm = JaxGPT(JaxConfig(**TINY, use_flash_attn=False))
    jp = jm.init(jax.random.PRNGKey(9))
    tm = GPTModel(TransformerConfig(**TINY), device="cpu")
    tp = params_from_jax(jax.device_get(jp), tm.cfg, device="cpu")
    tok_flags = ["--tokenizer_type", "GPT2BPETokenizer", "--vocab_file",
                 vf, "--merge_file", mf]
    return d, jm, jp, tm, tp, tok_flags


def _recording(monkeypatch, module, tokens):
    real = module.generate

    def generate(*a, **kw):
        out = real(*a, **kw)
        tokens.append([list(map(int, t)) for t in out[1]])
        return out
    monkeypatch.setattr(module, "generate", generate)


@pytest.mark.parametrize("kind", ["knowledge", "response"])
def test_prompting_matches_jax(setup, monkeypatch, kind):
    d, jm, jp, tm, tp, tok_flags = setup
    task = {"knowledge": "MSDP-PROMPT-KNWL",
            "response": "MSDP-PROMPT-RESP"}[kind]
    prompt_file = {"knowledge": "kprompts.jsonl",
                   "response": "rprompts.txt"}[kind]
    args, tokenizer = tasks_main.parse(
        ["--task", task, "--prompt_type", kind,
         "--prompt_file", str(d / prompt_file), "--num_prompt_examples",
         "1", "--sample_input_file", str(d / "input.tsv"),
         "--sample_output_file", str(d / f"port_{kind}.txt")]
        + FLAGS + tok_flags)
    assert tokenizer.vocab_size == 300 and args.padded_vocab_size == 384
    jargs = copy.copy(args)
    jargs.sample_output_file = str(d / f"jax_{kind}.txt")
    j_tokens, p_tokens = [], []
    _recording(monkeypatch, j_api, j_tokens)
    _recording(monkeypatch, p_api, p_tokens)
    j_prompt.generate_samples_by_prompting_input_from_file(
        jm, jp, tokenizer, jargs)
    p_prompt.generate_samples_by_prompting_input_from_file(
        tm, tp, tokenizer, args)
    assert len(p_tokens) == 2 and p_tokens == j_tokens
    got = (d / f"port_{kind}.txt").read_text()
    assert got == (d / f"jax_{kind}.txt").read_text()
    assert len(got.split("\n")) == 4        # line-aligned with the input


def test_prompt_and_f1_via_main(setup, capsys):
    d, jm, jp, tm, tp, tok_flags = setup
    checkpointing.save_checkpoint(str(d / "ck"), 1, tp)
    out = d / "main_knowledge.txt"
    argv = ["--task", "MSDP-PROMPT-KNWL", "--prompt_type", "knowledge",
            "--prompt_file", str(d / "kprompts.jsonl"),
            "--sample_input_file", str(d / "input.tsv"),
            "--sample_output_file", str(out)] + FLAGS + tok_flags
    tasks_main.main(argv + ["--load", str(d / "ck")])
    assert "wrote generations to" in capsys.readouterr().out
    # the loaded params generate what the params in memory do
    args, tokenizer = tasks_main.parse(argv)
    args.sample_output_file = str(d / "direct.txt")
    p_prompt.generate_samples_by_prompting_input_from_file(
        tm, tp, tokenizer, args)
    assert out.read_text() == (d / "direct.txt").read_text()
    lines = out.read_text().split("\n")
    answers = d / "answers.txt"
    answers.write_text(f"{lines[0]} cat\nno_passages_used\nrock\n")
    got = tasks_main.main(["--task", "MSDP-EVAL-F1", "--guess_file",
                           str(out), "--answer_file", str(answers)])
    assert got == p_meval.evaluate_f1(str(out), str(answers))
    assert "Precision:" in capsys.readouterr().out
