"""The port's tokenizers (megatron_llm_torch/tokenizer/) against the JAX
package's: ``build_tokenizer(args)`` of both gives the same ids, the same
decoded text, the same special ids and the same padded vocab for GPT-2
BPE, both WordPiece cases and the numeric tokenizer, on tiny vocabularies
built in tmp_path as tests/test_tokenizer_standalone.py builds them; the
same with ``transformers`` hidden (the standalone backends) and with a
``transformers`` whose fast tokenizers ignore the vocabulary file (5.x:
the port falls back to the standalone backends);
the standalone GPT-2 BPE refuses to start without ``regex``, as the JAX
package's does; and the byte-level vocabulary that
``bpe.write_byte_bpe_vocab`` writes gives a 32000-entry tokenizer that
round-trips text."""

import builtins
import types

import pytest

from megatron_llm_tpu.tokenizer import bpe as jax_bpe
from megatron_llm_tpu.tokenizer import tokenizer as jax_tok
from megatron_llm_torch.tokenizer import bpe, build_tokenizer
from megatron_llm_torch.tokenizer import tokenizer as torch_tok

from test_tokenizer_standalone import (
    TEXTS_BPE,
    TEXTS_WP,
    WP_VOCAB,
    _mini_bpe_files,
)


def _args(**kw):
    base = dict(tokenizer_type=None, vocab_file=None, merge_file=None,
                tokenizer_path=None, tokenizer_model=None, vocab_size=None,
                vocab_extra_ids=0, make_vocab_size_divisible_by=128,
                tensor_model_parallel_size=1, padded_vocab_size=None)
    base.update(kw)
    return types.SimpleNamespace(**base)


def _files(kind, tmp_path):
    if kind == "GPT2BPETokenizer":
        vf, mf = _mini_bpe_files(tmp_path)
        return dict(vocab_file=vf, merge_file=mf), TEXTS_BPE
    if kind == "NullTokenizer":
        return dict(vocab_size=1000), ["1 2 3", "999 0 17 4", ""]
    p = tmp_path / "vocab.txt"
    p.write_text("\n".join(WP_VOCAB) + "\n")
    return dict(vocab_file=str(p)), TEXTS_WP


def _special(tok):
    out = {}
    for name in ("eod", "pad", "cls", "sep", "mask", "bos_token_id",
                 "eos_token_id"):
        try:
            out[name] = getattr(tok, name)
        except NotImplementedError:
            out[name] = None
    return out


def _both(kind, tmp_path, **extra):
    files, texts = _files(kind, tmp_path)
    a_jax = _args(tokenizer_type=kind, **files, **extra)
    a_torch = _args(tokenizer_type=kind, **files, **extra)
    return (jax_tok.build_tokenizer(a_jax), a_jax,
            build_tokenizer(a_torch), a_torch, texts)


KINDS = ["GPT2BPETokenizer", "BertWordPieceLowerCase", "BertWordPieceCase",
         "NullTokenizer"]


def _hide_transformers(monkeypatch):
    real_import = builtins.__import__

    def no_transformers(name, *a, **kw):
        if name == "transformers" or name.startswith("transformers."):
            raise ImportError("blocked for test")
        return real_import(name, *a, **kw)

    monkeypatch.setattr(builtins, "__import__", no_transformers)


@pytest.mark.parametrize("hidden", [False, True],
                         ids=["transformers", "standalone"])
@pytest.mark.parametrize("kind", KINDS)
def test_build_tokenizer_matches_jax(kind, hidden, tmp_path, monkeypatch):
    if hidden:
        _hide_transformers(monkeypatch)
    jt, ja, tt, ta, texts = _both(kind, tmp_path)
    if hidden and kind != "NullTokenizer":
        assert type(tt._tok).__module__.startswith(
            "megatron_llm_torch.tokenizer.")
    assert tt.vocab_size == jt.vocab_size
    assert ta.padded_vocab_size == ja.padded_vocab_size
    assert ta.padded_vocab_size % 128 == 0
    assert _special(tt) == _special(jt)
    for text in texts:
        ids = tt.tokenize(text)
        assert ids == jt.tokenize(text), text
        assert tt.detokenize(ids) == jt.detokenize(ids), text
    if kind != "NullTokenizer":
        assert tt.vocab == jt.vocab


def test_wordpiece_extra_ids_match_jax(tmp_path):
    jt, _, tt, _, _ = _both("BertWordPieceLowerCase", tmp_path,
                            vocab_extra_ids=3)
    assert tt.additional_special_tokens_ids == \
        jt.additional_special_tokens_ids
    assert tt.vocab_size == jt.vocab_size


@pytest.mark.parametrize("mult,tp", [(128, 1), (64, 2), (1, 1), (8, 4)])
def test_vocab_size_with_padding_matches_jax(mult, tp):
    for n in (1, 127, 128, 129, 257, 32000, 32001, 50257, 65024):
        a = _args(make_vocab_size_divisible_by=mult,
                  tensor_model_parallel_size=tp)
        assert torch_tok._vocab_size_with_padding(n, a) == \
            jax_tok._vocab_size_with_padding(n, a)


def test_padding_without_a_tp_flag_is_one_device():
    a = types.SimpleNamespace(make_vocab_size_divisible_by=128)
    assert torch_tok._vocab_size_with_padding(32001, a) == 32128


@pytest.mark.parametrize("pkg", [bpe, jax_bpe])
def test_standalone_bpe_without_regex_raises(pkg, tmp_path, monkeypatch):
    """Without ``regex`` the GPT-2 split pattern cannot be spelt exactly,
    so both packages refuse rather than split differently."""
    vf, mf = _mini_bpe_files(tmp_path)
    monkeypatch.setattr(pkg, "_re", None)
    with pytest.raises(ImportError, match="regex"):
        pkg.StandaloneGPT2BPE(vf, mf)


def test_byte_vocab_round_trips(tmp_path):
    vf, mf = bpe.write_byte_bpe_vocab(str(tmp_path), 32000)
    args = _args(tokenizer_type="GPT2BPETokenizer", vocab_file=vf,
                 merge_file=mf)
    tok = build_tokenizer(args)
    assert tok.vocab_size == 32000 and args.padded_vocab_size == 32000
    assert tok.eod == 31999
    for text in [t for t in TEXTS_BPE if t] + ["snake_case x_1 ² ½ 数字123"]:
        ids = tok.tokenize(text)
        assert ids and max(ids) < 32000
        assert tok.detokenize(ids) == text
    # every id decodes (a random model may emit any of them)
    assert isinstance(tok.detokenize(list(range(32000))), str)


@pytest.mark.parametrize("kind", ["GPT2BPETokenizer",
                                  "BertWordPieceLowerCase"])
def test_a_transformers_that_ignores_the_file_falls_back(kind, tmp_path,
                                                         monkeypatch):
    """transformers 5.x's fast tokenizers take the vocabulary, not its
    file: built the 4.x way they hold their special tokens alone.  The
    port then takes its standalone backend, as the JAX package does
    without transformers."""
    transformers = pytest.importorskip("transformers")

    class IgnoresTheFile:
        def __init__(self, *a, **kw):
            pass

        def __len__(self):
            return 1

    for name in ("GPT2TokenizerFast", "BertTokenizerFast"):
        monkeypatch.setattr(transformers, name, IgnoresTheFile)
    files, texts = _files(kind, tmp_path)
    tt = build_tokenizer(_args(tokenizer_type=kind, **files))
    assert type(tt._tok).__module__.startswith(
        "megatron_llm_torch.tokenizer.")
    _hide_transformers(monkeypatch)
    jt = jax_tok.build_tokenizer(_args(tokenizer_type=kind, **files))
    assert tt.vocab_size == jt.vocab_size
    for text in texts:
        assert tt.tokenize(text) == jt.tokenize(text), text
