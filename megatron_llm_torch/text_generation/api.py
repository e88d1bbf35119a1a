"""Token-id stop and ban rules for the server's eol knobs (the
counterpart of ``resolve_stop_rules`` in
``megatron_llm_tpu/text_generation/api.py``).  The batch ``generate``
path and beam search of that module belong to a later slice."""

from __future__ import annotations

import warnings


def _single_token_id(tokenizer, text, quiet=False):
    """The single token id ``text`` produces mid-sequence, or None."""
    ids = tokenizer.tokenize(text)
    if len(ids) == 1:
        return ids[0]
    # retry with a leading anchor: if 'a'+text adds exactly one id over
    # 'a', that id is the mid-sequence encoding; int-only tokenizers
    # raise on alphabetic input, which disables the rule
    try:
        anchor = tokenizer.tokenize("a")
        ctx = tokenizer.tokenize("a" + text)
    except (ValueError, KeyError, TypeError):
        anchor = ctx = None
    if ctx is not None and len(ctx) == len(anchor) + 1 \
            and ctx[:len(anchor)] == anchor:
        return ctx[-1]
    if not quiet:
        warnings.warn(
            f"tokenizer encodes {text!r} to {len(ids)} ids "
            f"({ids}); stop/ban rules targeting it are "
            + ("disabled" if not ids
               else "approximate (using last id)"))
    return ids[-1] if ids else None


def resolve_stop_rules(tokenizer, stop_on_eol=False,
                       stop_on_double_eol=False,
                       prevent_newline_after_colon=False):
    """(extra_stop_ids, stop_pairs, ban_pairs) for the eol knobs."""
    extra_stop, stop_pairs, ban_pairs = [], [], []
    if stop_on_eol or stop_on_double_eol:
        eol = _single_token_id(tokenizer, "\n")
        if stop_on_eol and eol is not None:
            extra_stop.append(eol)
        if stop_on_double_eol:
            dbl = _single_token_id(tokenizer, "\n\n", quiet=True)
            if dbl is not None and dbl != eol:
                extra_stop.append(dbl)
            if eol is not None:
                stop_pairs.append((eol, eol))
    if prevent_newline_after_colon:
        colon = _single_token_id(tokenizer, ":")
        eol = _single_token_id(tokenizer, "\n")
        if colon is not None and eol is not None:
            ban_pairs.append((colon, eol))
    return tuple(extra_stop), tuple(stop_pairs), tuple(ban_pairs)
