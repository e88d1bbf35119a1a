"""Megatron ``mp_rank`` checkpoint interop (torch format, both ways): the
twin of the repo's ``weights_conversion/megatron_ckpt.py``, between the
reference layout and the port's param tree of torch tensors.

Reference layout (``megatron/checkpointing.py:77-140,340-411``)::

    <dir>/latest_checkpointed_iteration.txt        ("release" or an int)
    <dir>/iter_XXXXXXX/mp_rank_TT/model_optim_rng.pt          (pp == 1)
    <dir>/iter_XXXXXXX/mp_rank_TT_PPP/model_optim_rng.pt      (pp > 1)

with the payload::

    sd['model']['language_model']['embedding']['word_embeddings']['weight']
    sd['model']['language_model']['encoder']['layers.N.<module>.weight']
    sd['model']['language_model']['lm_head']
    sd['checkpoint_version']  (0 / 1.0 / 2.0 / 3.0)
    sd['iteration'], sd['args']

Import merges TP shards (column-parallel dim 0, row-parallel dim 1,
GLU halves re-interleaved per shard) and PP stages (local layer indices
offset by stage), applies the v<2.0 query_key_value row-reordering fixups
(``fix_query_key_value_ordering`` / ``_transpose_first_dim``,
checkpointing.py:340-411), and converts the reference's weight layout to
the port's param tree (``megatron_llm_torch/weights.py``):

* kernels here are stored ``[in, out]`` (the JAX package's convention)
  — transpose;
* the reference packs GLU ``dense_h_to_4h`` as ``[up(w3); gate(w1)]``
  (``weights_conversion/hf_to_megatron.py:162-165``) while the port
  packs ``[gate; up]`` (``util.pack_glu_ffn``) — halves swap;
* the grouped-GQA QKV layout and interleaved rotary rows are identical on
  both sides, so QKV needs only the transpose.

This goes beyond the reference's own converters, which require
``checkpoint_util.py`` unsharding before any conversion
(``megatron_to_hf.py:95``): TP/PP-sharded checkpoints import directly.

Covers the llama family (llama/llama2/codellama/mistral — the reference's
headline finetune workflow).  Falcon/GPT reference checkpoints differ only
in key names and can be added to ``_LAYER_KEYS``.
"""

from __future__ import annotations

import os
import re
from types import SimpleNamespace
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

CHECKPOINT_VERSION = 3.0


# ---------------------------------------------------------------------------
# shared helpers
# ---------------------------------------------------------------------------

def _tracker_path(root: str) -> str:
    return os.path.join(root, "latest_checkpointed_iteration.txt")


def read_tracker(root: str) -> str:
    with open(_tracker_path(root)) as f:
        return f.read().strip()


def _iter_dirname(iteration) -> str:
    if iteration == "release":
        return "release"
    return f"iter_{int(iteration):07d}"


def _rank_dirs(iter_dir: str) -> List[str]:
    out = sorted(d for d in os.listdir(iter_dir)
                 if re.fullmatch(r"mp_rank_\d\d(_\d\d\d)?", d))
    if not out:
        raise FileNotFoundError(f"no mp_rank_* dirs under {iter_dir}")
    return out


def _parse_rank(name: str) -> Tuple[int, int]:
    parts = name.split("_")           # mp, rank, TT[, PPP]
    tp = int(parts[2])
    pp = int(parts[3]) if len(parts) > 3 else 0
    return tp, pp


def _np32(t) -> np.ndarray:
    """A tensor (any dtype and device) or an array as an fp32 numpy copy
    on the host."""
    if isinstance(t, torch.Tensor):
        return t.detach().to("cpu").float().numpy().copy()
    return np.array(t, np.float32)


# ---------------------------------------------------------------------------
# v<2.0 fixups (reference checkpointing.py:340-411)
# ---------------------------------------------------------------------------

def fix_qkv_ordering(w: np.ndarray, version: float, num_heads: int,
                     num_heads_kv: int, head_dim: int) -> np.ndarray:
    """Reorder the first dim of a query_key_value weight/bias saved by a
    v<2.0 reference build into the v2 grouped layout [np, 3, hn, ...].

    Multi-query/grouped attention checkpoints never need the fixup
    (reference fix_query_key_value_ordering skips when
    num_attention_heads_kv != num_attention_heads)."""
    if version >= 2.0 or num_heads != num_heads_kv:
        return w
    trailing = w.shape[1:]
    if version == 0:
        # [3*np*hn, ...] -> [3, np, hn, ...] -> [np, 3, hn, ...]
        x = w.reshape((3, num_heads, head_dim) + trailing)
        x = np.swapaxes(x, 0, 1)
    elif version == 1.0:
        # [np*hn*3, ...] -> [np, hn, 3, ...] -> [np, 3, hn, ...]
        x = w.reshape((num_heads, head_dim, 3) + trailing)
        x = np.swapaxes(x, 1, 2)
    else:
        raise ValueError(f"invalid checkpoint version {version}")
    return np.ascontiguousarray(x.reshape(w.shape))


# ---------------------------------------------------------------------------
# import: reference mp_rank checkpoint -> the port's param tree
# ---------------------------------------------------------------------------

def _merge_tp(tensors: List[np.ndarray], kind: str) -> np.ndarray:
    """Merge TP shards of one weight.  kind: column (dim 0), row (dim 1),
    glu (per-shard [up_i; gate_i] halves re-grouped), replicated."""
    if len(tensors) == 1 and kind != "glu":
        return tensors[0]
    if kind == "column":
        return np.concatenate(tensors, axis=0)
    if kind == "row":
        return np.concatenate(tensors, axis=1)
    if kind == "glu":
        ups, gates = [], []
        for t in tensors:
            half = t.shape[0] // 2
            ups.append(t[:half])
            gates.append(t[half:])
        return np.concatenate(ups + gates, axis=0)
    return tensors[0]                  # replicated


_LAYER_KEYS = {
    # megatron encoder key suffix -> (our path, tp kind); the qkv bias key
    # is optional (qwen2-style models only)
    "attention.query_key_value.weight": (
        ("attention", "query_key_value", "kernel"), "column"),
    "attention.query_key_value.bias": (
        ("attention", "query_key_value", "bias"), "column"),
    "attention.dense.weight": (("attention", "dense", "kernel"), "row"),
    "mlp.dense_h_to_4h.weight": (
        ("mlp", "dense_h_to_4h", "kernel"), "glu"),
    "mlp.dense_4h_to_h.weight": (("mlp", "dense_4h_to_h", "kernel"), "row"),
    "input_layernorm.weight": (("input_norm", "scale"), "replicated"),
    "post_attention_layernorm.weight": (
        ("post_attention_norm", "scale"), "replicated"),
}


def _language_model(sd: dict) -> dict:
    lm = sd["model"]["language_model"]
    if "encoder" not in lm and "transformer" in lm:
        lm = dict(lm)
        lm["encoder"] = lm["transformer"]
    return lm


def _word_embeddings(lm: dict) -> np.ndarray:
    emb = lm["embedding"]
    if "word_embeddings" in emb:
        return _np32(emb["word_embeddings"]["weight"])
    return _np32(emb["word_embeddings.weight"])


def load_reference_checkpoint(load_dir: str,
                              iteration: Optional[int] = None,
                              dtype=None):
    """Read a reference-layout checkpoint tree -> (params, config, meta).

    params is the port's llama-family param tree of CPU tensors in
    ``dtype`` (fp32 by default; what ``models.llama.LlamaModel.init``
    produces); config is a dict of TransformerConfig overrides recovered
    from the checkpoint args; meta carries {'iteration',
    'checkpoint_version', 'args'}.
    """
    if dtype is None:
        dtype = torch.float32
    if iteration is None:
        iteration = read_tracker(load_dir)
    iter_dir = os.path.join(load_dir, _iter_dirname(iteration))
    ranks = _rank_dirs(iter_dir)
    by_pp: Dict[int, Dict[int, dict]] = {}
    version = None
    args = None
    for name in ranks:
        tp, pp = _parse_rank(name)
        # weights_only=False: the payload's 'args' is an argparse Namespace
        sd = torch.load(os.path.join(iter_dir, name, "model_optim_rng.pt"),
                        map_location="cpu", weights_only=False)
        by_pp.setdefault(pp, {})[tp] = sd
        if version is None:
            version = float(sd.get("checkpoint_version", 0))
            args = sd.get("args")

    nh = getattr(args, "num_attention_heads", None)
    ng = getattr(args, "num_attention_heads_kv", nh)
    hidden = getattr(args, "hidden_size", None)

    # merged[key] = full tensor, with layer indices made global across pp
    pp_stages = sorted(by_pp)
    merged: Dict[str, np.ndarray] = {}
    layer_offset = 0
    layer_re = re.compile(r"layers\.(\d+)\.(.+)")
    for stage in pp_stages:
        shards = [by_pp[stage][tp] for tp in sorted(by_pp[stage])]
        lms = [_language_model(s) for s in shards]
        encs = [lm["encoder"] for lm in lms]
        stage_layers = set()
        suffixes = set()
        for key in encs[0]:
            m = layer_re.fullmatch(key)
            if m:
                stage_layers.add(int(m.group(1)))
                suffixes.add(m.group(2))
        for li in sorted(stage_layers):
            for suffix in suffixes:
                if suffix not in _LAYER_KEYS:
                    continue
                _, kind = _LAYER_KEYS[suffix]
                shards = [_np32(e[f"layers.{li}.{suffix}"]) for e in encs]
                if suffix in ("attention.query_key_value.weight",
                              "attention.query_key_value.bias") and nh:
                    # the v<2.0 reordering is per-rank (each shard holds
                    # nh/tp heads in the old layout), so fix before
                    # merging; applies to weight AND bias (the reference
                    # fixes both, checkpointing.py:388-391)
                    nh_local = nh // len(shards)
                    # GQA (ng != nh) skips the fixup entirely; signal that
                    # by passing unequal local head counts
                    ng_local = nh_local if ng == nh else 0
                    if shards[0].ndim > 1:       # weight [3*nh_l*d, hid]
                        d_fix = (hidden or shards[0].shape[1]) // nh
                    else:                        # bias [3*nh_l*d]
                        d_fix = shards[0].shape[0] // (3 * nh_local)
                    shards = [fix_qkv_ordering(
                        s, version, nh_local, ng_local, d_fix)
                        for s in shards]
                merged[f"layers.{layer_offset + li}.{suffix}"] = _merge_tp(
                    shards, kind)
        if stage == pp_stages[0] and "embedding" in lms[0]:
            merged["word_embeddings"] = _merge_tp(
                [_word_embeddings(lm) for lm in lms], "column")
        if stage == pp_stages[-1]:
            if "final_layernorm.weight" in encs[0]:
                merged["final_layernorm"] = _np32(
                    encs[0]["final_layernorm.weight"])
            if "lm_head" in lms[0]:
                merged["lm_head"] = _merge_tp(
                    [_np32(lm["lm_head"]) for lm in lms], "column")
        layer_offset += len(stage_layers)

    num_layers = layer_offset

    def tensor(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dtype)

    def stack(suffix, transform):
        return tensor(np.stack([
            transform(merged[f"layers.{i}.{suffix}"])
            for i in range(num_layers)
        ]))

    def to_kernel(w):                   # torch [out, in] -> kernel [in, out]
        return np.ascontiguousarray(w.T)

    def glu_to_kernel(w):               # [up; gate] -> kernel of [gate; up]
        half = w.shape[0] // 2
        return np.ascontiguousarray(
            np.concatenate([w[half:], w[:half]], axis=0).T)

    params = {
        "embedding": {"word": {"embedding": tensor(
            merged["word_embeddings"])}},
        "transformer": {
            "layers": {
                "input_norm": {
                    "scale": stack("input_layernorm.weight", lambda w: w)},
                "attention": {
                    "query_key_value": {
                        "kernel": stack(
                            "attention.query_key_value.weight", to_kernel),
                        # optional (qwen2-style models)
                        **({"bias": stack(
                            "attention.query_key_value.bias", lambda w: w)}
                           if "layers.0.attention.query_key_value.bias"
                           in merged else {}),
                    },
                    "dense": {"kernel": stack(
                        "attention.dense.weight", to_kernel)},
                },
                "post_attention_norm": {
                    "scale": stack("post_attention_layernorm.weight",
                                   lambda w: w)},
                "mlp": {
                    "dense_h_to_4h": {"kernel": stack(
                        "mlp.dense_h_to_4h.weight", glu_to_kernel)},
                    "dense_4h_to_h": {"kernel": stack(
                        "mlp.dense_4h_to_h.weight", to_kernel)},
                },
            },
            "final_norm": {"scale": tensor(merged["final_layernorm"])},
        },
    }
    if "lm_head" in merged:
        params["lm_head"] = {"weight": tensor(merged["lm_head"])}

    ffn = merged["layers.0.mlp.dense_h_to_4h.weight"].shape[0] // 2
    config = {
        "num_layers": num_layers,
        "hidden_size": merged["layers.0.attention.dense.weight"].shape[0],
        "padded_vocab_size": merged["word_embeddings"].shape[0],
        "ffn_hidden_size": ffn,
        "tie_embed_logits": "lm_head" not in merged,
        "add_qkv_bias":
            "layers.0.attention.query_key_value.bias" in merged,
    }
    for field, attr in [
        ("num_attention_heads", "num_attention_heads"),
        ("num_attention_heads_kv", "num_attention_heads_kv"),
        ("seq_length", "seq_length"),
        ("max_position_embeddings", "max_position_embeddings"),
        ("layernorm_epsilon", "layernorm_epsilon"),
        ("rope_theta", "rope_theta"),
    ]:
        val = getattr(args, attr, None)
        if val is not None:
            config[field] = val
    meta = {"iteration": iteration, "checkpoint_version": version,
            "args": args}
    return params, config, meta


# ---------------------------------------------------------------------------
# export: the port's param tree -> reference mp_rank checkpoint
# ---------------------------------------------------------------------------

def _split_tp(w: np.ndarray, tp: int, kind: str) -> List[np.ndarray]:
    if tp == 1:
        return [w]
    if kind == "column":
        return [np.ascontiguousarray(s) for s in np.split(w, tp, axis=0)]
    if kind == "row":
        return [np.ascontiguousarray(s) for s in np.split(w, tp, axis=1)]
    if kind == "glu":
        half = w.shape[0] // 2
        ups = np.split(w[:half], tp, axis=0)
        gates = np.split(w[half:], tp, axis=0)
        return [np.ascontiguousarray(np.concatenate([u, g], axis=0))
                for u, g in zip(ups, gates)]
    return [w] * tp                     # replicated


def save_reference_checkpoint(save_dir: str, iteration, params, cfg,
                              tensor_parallel: int = 1):
    """Write the param tree (tensors or arrays) as a reference-layout
    torch checkpoint.

    cfg: anything exposing num_layers / hidden_size / num_attention_heads /
    num_attention_heads_kv / ffn_hidden_size / padded_vocab_size (the
    port's TransformerConfig qualifies).  ``tensor_parallel`` > 1
    writes TP-sharded mp_rank_00..NN files the reference can load rank-wise.
    """
    def get(attr, default=None):
        if isinstance(cfg, dict):
            return cfg.get(attr, default)
        return getattr(cfg, attr, default)

    tp = tensor_parallel
    layers = params["transformer"]["layers"]
    if "experts" in layers["mlp"]:
        raise NotImplementedError(
            "MoE params cannot be exported to a reference Megatron "
            "checkpoint: the reference has no MoE layout (its mlp is "
            "dense_h_to_4h/dense_4h_to_h)")
    # .shape on the stacked kernel directly: no copy to read one dim
    num_layers = int(
        layers["attention"]["query_key_value"]["kernel"].shape[0])

    def kernel_to_w(k):                # kernel [in, out] -> torch [out, in]
        return np.ascontiguousarray(_np32(k).T)

    def glu_kernel_to_w(k):            # kernel of [gate; up] -> [up; gate]
        w = np.ascontiguousarray(_np32(k).T)
        half = w.shape[0] // 2
        return np.ascontiguousarray(np.concatenate([w[half:], w[:half]]))

    encoders = [dict() for _ in range(tp)]
    for li in range(num_layers):
        per_key = {
            "attention.query_key_value.weight": _split_tp(
                kernel_to_w(layers["attention"]["query_key_value"]["kernel"][li]),
                tp, "column"),
            **({"attention.query_key_value.bias": _split_tp(
                _np32(layers["attention"]["query_key_value"]["bias"][li]),
                tp, "column")}
               if "bias" in layers["attention"]["query_key_value"] else {}),
            "attention.dense.weight": _split_tp(
                kernel_to_w(layers["attention"]["dense"]["kernel"][li]),
                tp, "row"),
            "mlp.dense_h_to_4h.weight": _split_tp(
                glu_kernel_to_w(layers["mlp"]["dense_h_to_4h"]["kernel"][li]),
                tp, "glu"),
            "mlp.dense_4h_to_h.weight": _split_tp(
                kernel_to_w(layers["mlp"]["dense_4h_to_h"]["kernel"][li]),
                tp, "row"),
            "input_layernorm.weight": _split_tp(
                _np32(layers["input_norm"]["scale"][li]), tp, "replicated"),
            "post_attention_layernorm.weight": _split_tp(
                _np32(layers["post_attention_norm"]["scale"][li]), tp,
                "replicated"),
        }
        for suffix, shards in per_key.items():
            for r, s in enumerate(shards):
                # np.array: one owned, writable copy a shard
                encoders[r][f"layers.{li}.{suffix}"] = torch.from_numpy(
                    np.array(s))

    final_norm = _np32(params["transformer"]["final_norm"]["scale"])
    emb = _np32(params["embedding"]["word"]["embedding"])
    emb_shards = _split_tp(np.ascontiguousarray(emb), tp, "column")
    head_shards = None
    if "lm_head" in params:
        head = np.ascontiguousarray(_np32(params["lm_head"]["weight"]))
        head_shards = _split_tp(head, tp, "column")

    args = SimpleNamespace(
        num_layers=get("num_layers", num_layers),
        hidden_size=get("hidden_size"),
        num_attention_heads=get("num_attention_heads"),
        num_attention_heads_kv=get("num_attention_heads_kv",
                                   get("num_attention_heads")),
        ffn_hidden_size=get("ffn_hidden_size"),
        padded_vocab_size=get("padded_vocab_size"),
        seq_length=get("seq_length"),
        max_position_embeddings=get("max_position_embeddings"),
        layernorm_epsilon=get("layernorm_epsilon", 1e-5),
        rope_theta=get("rope_theta", 10000.0),
        tensor_model_parallel_size=tp,
        pipeline_model_parallel_size=1,
        use_distributed_optimizer=False,
    )

    iter_dir = os.path.join(save_dir, _iter_dirname(iteration))
    for r in range(tp):
        lm = {
            "embedding": {"word_embeddings": {
                "weight": torch.from_numpy(np.array(emb_shards[r]))}},
            "encoder": dict(encoders[r]),
        }
        lm["encoder"]["final_layernorm.weight"] = torch.from_numpy(
            np.array(final_norm))
        if head_shards is not None:
            lm["lm_head"] = torch.from_numpy(np.array(head_shards[r]))
        sd = {
            "model": {"language_model": lm},
            "checkpoint_version": CHECKPOINT_VERSION,
            "iteration": 0 if iteration == "release" else int(iteration),
            "args": args,
        }
        rank_dir = os.path.join(iter_dir, f"mp_rank_{r:02d}")
        os.makedirs(rank_dir, exist_ok=True)
        torch.save(sd, os.path.join(rank_dir, "model_optim_rng.pt"))
    with open(_tracker_path(save_dir), "w") as f:
        f.write("release" if iteration == "release" else str(int(iteration)))


# ---------------------------------------------------------------------------
# CLI: convert between reference mp_rank checkpoints and the port's
# ---------------------------------------------------------------------------

def build_parser():
    import argparse

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("direction", choices=["from-megatron", "to-megatron"])
    p.add_argument("--load", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--tp", type=int, default=1,
                   help="TP shards to write (to-megatron only)")
    p.add_argument("--iteration", type=int, default=None)
    return p


def main(argv=None):
    from megatron_llm_torch import checkpointing

    args = build_parser().parse_args(argv)
    if args.direction == "from-megatron":
        params, config, meta = load_reference_checkpoint(
            args.load, iteration=args.iteration)
        release = meta["iteration"] == "release"
        it = 0 if release else int(meta["iteration"])
        checkpointing.save_checkpoint(args.out, it, params, args=config,
                                      release=release)
        print(f" imported reference checkpoint {args.load} "
              f"(version {meta['checkpoint_version']}) -> {args.out}")
    else:
        # not finetune=True: that zeroes meta['iteration'], which names the
        # exported iter_XXXXXXX dir (optimizer state is skipped anyway
        # because no template is passed)
        params, _, meta = checkpointing.load_checkpoint(args.load,
                                                        device="cpu")
        cfg = (meta or {}).get("args") or {}
        it = args.iteration if args.iteration is not None else \
            (meta or {}).get("iteration", 0)
        save_reference_checkpoint(args.out, it, params, cfg,
                                  tensor_parallel=args.tp)
        print(f" exported {args.load} -> reference layout at {args.out} "
              f"(tp={args.tp})")


if __name__ == "__main__":
    main()
