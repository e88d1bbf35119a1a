"""Tokenizers of the PyTorch port (copies of ``megatron_llm_tpu/tokenizer/``
with their imports changed): ``build_tokenizer(args)`` builds the one
``--tokenizer_type`` names and sets ``args.padded_vocab_size``.
``NullTokenizer`` (whitespace-separated integer ids) needs no vocabulary
file."""

from megatron_llm_torch.tokenizer.tokenizer import (  # noqa: F401
    _NullTokenizer as NullTokenizer,
    build_tokenizer,
)
