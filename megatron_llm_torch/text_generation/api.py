"""The high-level generation API (the counterpart of
``megatron_llm_tpu/text_generation/api.py``): ``generate``,
``generate_and_post_process`` and ``beam_search_and_post_process`` with
the reference's signatures, and the token-id stop and ban rules of the
server's eol knobs (``resolve_stop_rules``), which the serving engine
shares."""

from __future__ import annotations

import warnings
from typing import Optional, Sequence

import torch

from megatron_llm_torch.text_generation.generation import (
    beam_search,
    generate_tokens,
)


def _tokenize_prompts(tokenizer, prompts: Sequence[str], pad_id: int,
                      add_bos: bool = False, device="cuda"):
    """Prompts -> (tokens [n, longest] right-padded with ``pad_id``,
    lengths [n]) on ``device``; ``add_bos`` prepends the tokenizer's BOS
    id (its eod where it has none, as the reference does)."""
    tokenized = [tokenizer.tokenize(p) for p in prompts]
    if add_bos:
        bos = getattr(tokenizer, "bos_token_id", None)
        if bos is None:
            bos = tokenizer.eod
        tokenized = [[bos] + list(t) for t in tokenized]
    lengths = [len(t) for t in tokenized]
    arr = torch.full((len(prompts), max(lengths)), pad_id, dtype=torch.long)
    for i, t in enumerate(tokenized):
        arr[i, :len(t)] = torch.tensor(list(t), dtype=torch.long)
    return arr.to(device), torch.tensor(lengths, dtype=torch.long,
                                        device=device)


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


def generate(model, params, tokenizer, prompts: Sequence[str],
             tokens_to_generate: int = 64, *, top_k: int = 0,
             top_p: float = 0.0, temperature: float = 1.0,
             greedy: bool = False, seed: int = 0,
             return_log_probs: bool = False,
             batch_times_seqlen_threshold: int = 512, add_bos: bool = False,
             top_p_decay: float = 0.0, top_p_bound: float = 0.0,
             stop_on_eol: bool = False, stop_on_double_eol: bool = False,
             prevent_newline_after_colon: bool = False,
             rolling_cache: Optional[bool] = None,
             cache_len: Optional[int] = None, int8_kv_cache: bool = False):
    """Returns (texts, token lists, log_probs [n, total] or None).

    ``rolling_cache`` None turns the ring cache on exactly when it saves
    memory: a sliding-window model decoding past its window (the logits
    are the same either way).  ``int8_kv_cache`` is then ignored, with a
    note, since the ring has no int8 variant.  Each row is cut after its
    first stop (eod, an extra stop id or a stop bigram) past its
    prompt."""
    dev = model.device
    pad = getattr(tokenizer, "pad", 0) or 0
    eod = getattr(tokenizer, "eod", None)
    toks, lens = _tokenize_prompts(tokenizer, prompts, pad, add_bos,
                                   device=dev)
    if rolling_cache is None:
        window = model.cfg.sliding_window_size
        rolling_cache = (window is not None
                         and toks.shape[1] + tokens_to_generate > window)
    if int8_kv_cache and rolling_cache:
        print(" > NOTE: int8_kv_cache is ignored for this request — the "
              "rolling (sliding-window) cache engaged and has no int8 "
              "variant; KV stays bf16", flush=True)
    extra_stop, stop_pairs, ban_pairs = resolve_stop_rules(
        tokenizer, stop_on_eol=stop_on_eol,
        stop_on_double_eol=stop_on_double_eol,
        prevent_newline_after_colon=prevent_newline_after_colon)
    gen = torch.Generator(device=dev).manual_seed(seed)
    out_tokens, _, log_probs = generate_tokens(
        model, params, toks, lens, gen,
        max_new_tokens=tokens_to_generate,
        min_prompt_len=int(lens.min()),
        top_k=top_k, top_p=top_p, temperature=temperature, greedy=greedy,
        eod_id=eod, return_log_probs=return_log_probs,
        batch_times_seqlen_threshold=batch_times_seqlen_threshold,
        top_p_decay=top_p_decay, top_p_bound=top_p_bound,
        extra_stop_ids=tuple(extra_stop), stop_pairs=tuple(stop_pairs),
        ban_pairs=tuple(ban_pairs), rolling_cache=bool(rolling_cache),
        cache_len=cache_len,
        int8_kv_cache=int8_kv_cache and not rolling_cache)
    stop_set = set(extra_stop)
    if eod is not None:
        stop_set.add(eod)
    pair_set = set(stop_pairs)
    texts, token_lists = [], []
    for i, row in enumerate(out_tokens.tolist()):
        # cut at the first stop after the prompt: a row frozen by a stop
        # keeps zeros after it, which must not reach the caller
        start = int(lens[i])
        end = len(row)
        for j in range(start, len(row)):
            if row[j] in stop_set or (j > 0
                                      and (row[j - 1], row[j]) in pair_set):
                end = j + 1
                break
        row = row[:end]
        token_lists.append(row)
        texts.append(tokenizer.detokenize(row))
    return texts, token_lists, (log_probs.cpu().numpy() if return_log_probs
                                else None)


def generate_and_post_process(model, params, tokenizer, prompts,
                              tokens_to_generate: int = 64,
                              return_output_log_probs: bool = False,
                              top_k_sampling: int = 0,
                              top_p_sampling: float = 0.0,
                              temperature: float = 1.0,
                              random_seed: int = 0,
                              batch_times_seqlen_threshold: int = 512,
                              add_BOS: bool = False,
                              top_p_decay: float = 0.0,
                              top_p_bound: float = 0.0,
                              stop_on_eol: bool = False,
                              stop_on_double_eol: bool = False,
                              prevent_newline_after_colon: bool = False,
                              int8_kv_cache: bool = False, **_unused):
    """The reference's signature: (texts, segments, log_probs, tokens)."""
    texts, tokens, log_probs = generate(
        model, params, tokenizer, prompts, tokens_to_generate,
        top_k=top_k_sampling, top_p=top_p_sampling, temperature=temperature,
        greedy=(top_k_sampling == 1), seed=random_seed,
        return_log_probs=return_output_log_probs,
        batch_times_seqlen_threshold=batch_times_seqlen_threshold,
        add_bos=add_BOS, top_p_decay=top_p_decay, top_p_bound=top_p_bound,
        stop_on_eol=stop_on_eol, stop_on_double_eol=stop_on_double_eol,
        prevent_newline_after_colon=prevent_newline_after_colon,
        int8_kv_cache=int8_kv_cache)
    segments = [[tokenizer.detokenize([t]) for t in row] for row in tokens]
    return texts, segments, log_probs, tokens


def beam_search_and_post_process(model, params, tokenizer, prompts,
                                 tokens_to_generate: int = 64,
                                 beam_size: int = 4,
                                 length_penalty: float = 1.0,
                                 stop_token=None, add_BOS: bool = False,
                                 **_unused):
    """The reference's signature (one prompt): (texts, scores), best
    first; ``stop_token`` takes eod's place as the beams' end."""
    assert len(prompts) == 1, "beam search supports a single prompt"
    dev = model.device
    toks, _ = _tokenize_prompts(tokenizer, prompts,
                                getattr(tokenizer, "pad", 0) or 0, add_BOS,
                                device=dev)
    beams, scores = beam_search(
        model, params, toks[:1], beam_size=beam_size,
        max_new_tokens=tokens_to_generate,
        eod_id=(int(stop_token) if stop_token is not None
                else tokenizer.eod),
        length_penalty=length_penalty)
    texts = [tokenizer.detokenize(b) for b in beams.tolist()]
    return texts, scores.cpu().numpy()
