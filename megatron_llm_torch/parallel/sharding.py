"""Tensor-parallel placement of the param tree: the logical-axis spec
tables (the port's copy of ``megatron_llm_tpu/models/language_model.py``'s
``_linear_spec``, ``_norm_spec``, ``transformer_layer_specs`` and
``language_model_param_specs``), the shard and gather of a tree on the
JAX layout, the ZeRO-1 state's dp dims (``dp_shard_dim``, the JAX
optimizer's ``state_specs(zero1=True)``), and ``TensorParallelPlan``,
which the train step, the optimizer, the checkpoints and the snapshots
use to finish and reduce a step's grads over tp x dp, to count each
element once, and to move a tree between a rank's pieces and the one
layout.

A spec names the logical axis of each dim of a leaf (``'vocab'``,
``'ffn'``, ``'heads'``, ``'stage'`` or None).  The JAX package maps
``'vocab'``, ``'ffn'`` and ``'heads'`` onto its ``tp`` mesh axis and lets
GSPMD place the slices; here a rank holds its slice explicitly, cut as
the port's layers consume it:

* ``'vocab'`` and a plain ``'ffn'`` or ``'heads'`` dim: contiguous
  chunks, one a rank.
* ``'ffn'`` on a GLU's doubled projection (``dense_h_to_4h`` under
  ``glu_activation``, ``[a | b]`` halves): each rank keeps its chunk of
  both halves, ``[a_r | b_r]``, so that the activation pairs them
  locally.
* ``'heads'`` on the grouped QKV projection (``[ng, qpg + 2, d]``,
  ``models/transformer.py``): with tp dividing ``num_query_groups``, a
  contiguous chunk of whole groups.  With fewer groups than ranks (and
  the groups dividing tp, as Falcon's and Gemma's one KV head at tp 2
  or 4), each rank keeps its query heads and its group's K and V
  columns, ``[1, nh / tp + 2, d]``; the K/V columns are then held by
  tp / ng ranks, and their grads are summed over those ranks
  (``TensorParallelPlan.finish_grads``).  Any other head count raises
  ``NotImplementedError`` naming the shape.

A rank's query heads are global heads ``[r nh / tp, (r + 1) nh / tp)``
in either QKV case, so the attention output projection (``dense``,
``'heads'`` on its input dim) is cut in contiguous chunks too.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import torch

from megatron_llm_torch import topology
from megatron_llm_torch.parallel import mappings
from megatron_llm_torch.tree import tree_leaves_with_path

TP_LOGICAL = ("vocab", "ffn", "heads")


# ---------------------------------------------------------------------------
# the spec tables (the JAX package's, leaf for leaf)
# ---------------------------------------------------------------------------

def _linear_spec(p, in_ax, out_ax, stacked):
    lead = ("stage",) if stacked else ()
    spec = {"kernel": lead + (in_ax, out_ax)}
    if "bias" in p:
        spec["bias"] = lead + (out_ax,)
    return spec


def _norm_spec(p, stacked):
    lead = ("stage",) if stacked else ()
    return {k: lead + (None,) for k in p}


def transformer_layer_specs(layers, stacked: bool = True, cfg=None) -> dict:
    """Logical-axis specs of one (layer-stacked) transformer layer tree,
    the decoder's ``inter_attention`` included.  The mixture of experts'
    ``expert`` axis is not ported (ROADMAP item 15): its specs raise."""
    if "experts" in layers["mlp"]:
        raise NotImplementedError(
            "the mixture of experts' expert axis at tp > 1 is not ported "
            "yet (ROADMAP item 15)")
    layer_specs = {
        "input_norm": _norm_spec(layers["input_norm"], stacked),
        "attention": {
            "query_key_value": _linear_spec(
                layers["attention"]["query_key_value"], None, "heads",
                stacked),
            "dense": _linear_spec(layers["attention"]["dense"], "heads",
                                  None, stacked),
        },
        "mlp": {
            "dense_h_to_4h": _linear_spec(
                layers["mlp"]["dense_h_to_4h"], None, "ffn", stacked),
            "dense_4h_to_h": _linear_spec(
                layers["mlp"]["dense_4h_to_h"], "ffn", None, stacked),
        },
    }
    if "post_attention_norm" in layers:
        layer_specs["post_attention_norm"] = _norm_spec(
            layers["post_attention_norm"], stacked)
    if "mlp_norm" in layers:
        layer_specs["mlp_norm"] = _norm_spec(layers["mlp_norm"], stacked)
    if "inter_attention" in layers:
        ia = layers["inter_attention"]
        layer_specs["inter_attention"] = {
            "query": _linear_spec(ia["query"], None, "heads", stacked),
            "key_value": _linear_spec(ia["key_value"], None, "heads",
                                      stacked),
            "dense": _linear_spec(ia["dense"], "heads", None, stacked),
        }
        layer_specs["post_inter_attention_norm"] = _norm_spec(
            layers["post_inter_attention_norm"], stacked)
    return layer_specs


def transformer_stack_specs(stack_params, cfg=None) -> dict:
    return {
        "layers": transformer_layer_specs(stack_params["layers"], cfg=cfg),
        "final_norm": _norm_spec(stack_params["final_norm"], False),
    }


def language_model_param_specs(params, cfg=None) -> dict:
    """The spec tree of ``init_language_model_params``'s tree (the JAX
    package's ``language_model_param_specs``)."""
    specs = {
        "embedding": {"word": {"embedding": ("vocab", None)}},
        "transformer": transformer_stack_specs(params["transformer"], cfg),
    }
    if "position" in params["embedding"]:
        specs["embedding"]["position"] = {"embedding": (None, None)}
    if "tokentype" in params["embedding"]:
        specs["embedding"]["tokentype"] = {"embedding": (None, None)}
    if "lm_head" in params:
        specs["lm_head"] = {"weight": ("vocab", None)}
    return specs


def is_sharded(spec) -> bool:
    return any(a in TP_LOGICAL for a in spec)


# ---------------------------------------------------------------------------
# heads at tp
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class HeadLayout:
    """How the attention heads of a config fall on ``tp`` ranks."""

    nh: int
    ng: int
    d: int
    tp: int

    @property
    def nh_local(self) -> int:
        return self.nh // self.tp

    @property
    def ng_local(self) -> int:
        return max(self.ng // self.tp, 1)

    @property
    def kv_shared(self) -> bool:
        """Fewer KV groups than ranks: a group's K/V on tp / ng ranks."""
        return self.ng < self.tp

    @property
    def ranks_per_group(self) -> int:
        return self.tp // self.ng if self.kv_shared else 1

    def group_of(self, rank: int) -> int:
        """The KV group of ``rank``'s query heads (the first of them when
        a rank holds several groups)."""
        return rank // self.ranks_per_group if self.kv_shared else \
            rank * self.ng_local


def head_layout(cfg, tp: Optional[int] = None) -> HeadLayout:
    """The config's heads at tp (the topology's by default); raises
    ``NotImplementedError`` for a head count the port does not split."""
    tp = tp or topology.get_tensor_model_parallel_world_size()
    nh, ng, d = cfg.num_attention_heads, cfg.num_query_groups, cfg.head_dim
    if tp > 1 and (nh % tp or (ng >= tp and ng % tp)
                   or (ng < tp and tp % ng)):
        raise NotImplementedError(
            f"tensor parallelism over {tp} ranks does not split "
            f"{nh} query heads on {ng} KV groups (tp must divide the "
            f"query heads, and divide the KV groups or be a multiple of "
            f"them)")
    return HeadLayout(nh, ng, d, tp)


def local_heads(cfg) -> tuple:
    """(query heads, KV groups) of this rank."""
    lay = head_layout(cfg)
    return lay.nh_local, lay.ng_local


# ---------------------------------------------------------------------------
# shard / gather on the JAX layout
# ---------------------------------------------------------------------------

def _tp_dim(spec) -> Optional[int]:
    dims = [i for i, a in enumerate(spec) if a in TP_LOGICAL]
    if len(dims) > 1:
        raise ValueError(f"spec {spec} shards more than one dim")
    return dims[0] if dims else None


def _kind(t_dim_size: int, logical: str, cfg) -> str:
    """How a sharded dim is cut: 'qkv' (the grouped projection), 'glu'
    (a GLU's doubled projection) or 'chunk'."""
    if cfg is None:
        return "chunk"
    if logical == "heads":
        lay = head_layout(cfg, 1)
        if t_dim_size == lay.ng * (lay.nh // lay.ng + 2) * lay.d:
            return "qkv"
    if (logical == "ffn" and cfg.glu_activation
            and t_dim_size == 2 * cfg.ffn_hidden_size):
        return "glu"
    return "chunk"


def shard_leaf(t: torch.Tensor, spec, tp_rank: int, tp_size: int,
               cfg=None) -> torch.Tensor:
    """This rank's slice of the full leaf ``t`` (a new tensor)."""
    dim = _tp_dim(spec)
    if dim is None or tp_size == 1:
        return t.clone()
    n = t.shape[dim]
    kind = _kind(n, spec[dim], cfg)
    if kind == "qkv":
        lay = head_layout(cfg, tp_size)
        qpg = lay.nh // lay.ng
        g = t.unflatten(dim, (lay.ng, qpg + 2, lay.d))
        if not lay.kv_shared:
            per = lay.ng // tp_size
            out = g.narrow(dim, tp_rank * per, per)
        else:
            grp = lay.group_of(tp_rank)
            j = tp_rank % lay.ranks_per_group
            gg = g.narrow(dim, grp, 1)
            q = gg.narrow(dim + 1, j * lay.nh_local, lay.nh_local)
            kv = gg.narrow(dim + 1, qpg, 2)
            out = torch.cat([q, kv], dim=dim + 1)
        return out.flatten(dim, dim + 2).contiguous()
    if n % tp_size:
        raise NotImplementedError(
            f"dim {dim} of {tuple(t.shape)} ({spec[dim]}) is not divisible "
            f"by tp {tp_size}")
    if kind == "glu":
        halves = t.unflatten(dim, (2, n // 2))
        per = n // 2 // tp_size
        return halves.narrow(dim + 1, tp_rank * per, per).flatten(
            dim, dim + 1).contiguous()
    per = n // tp_size
    return t.narrow(dim, tp_rank * per, per).contiguous()


def unshard_leaf(parts, spec, cfg=None) -> torch.Tensor:
    """The full leaf from every rank's slice (``parts`` in rank order):
    the inverse of ``shard_leaf``."""
    dim = _tp_dim(spec)
    tp = len(parts)
    if dim is None or tp == 1:
        return parts[0].clone()
    n_local = parts[0].shape[dim]
    if cfg is not None and spec[dim] == "heads":
        lay = head_layout(cfg, tp)
        if n_local == lay.ng_local * (lay.nh_local // lay.ng_local + 2) \
                * lay.d:
            if not lay.kv_shared:
                return torch.cat(parts, dim=dim)
            groups = []
            for grp in range(lay.ng):
                ranks = range(grp * lay.ranks_per_group,
                              (grp + 1) * lay.ranks_per_group)
                loc = [parts[r].unflatten(dim, (1, lay.nh_local + 2, lay.d))
                       for r in ranks]
                q = torch.cat([p.narrow(dim + 1, 0, lay.nh_local)
                               for p in loc], dim=dim + 1)
                kv = loc[0].narrow(dim + 1, lay.nh_local, 2)
                groups.append(torch.cat([q, kv], dim=dim + 1))
            return torch.cat(groups, dim=dim).flatten(dim, dim + 2)
    if (cfg is not None and spec[dim] == "ffn" and cfg.glu_activation
            and n_local * tp == 2 * cfg.ffn_hidden_size):
        halves = [p.unflatten(dim, (2, n_local // 2)) for p in parts]
        return torch.cat(halves, dim=dim + 1).flatten(dim, dim + 1)
    return torch.cat(parts, dim=dim)


def shard_params(full_tree, specs, tp_rank: int, tp_size: int, cfg=None):
    """This rank's tree from the full tree (the JAX layout) and its spec
    tree.  ``cfg`` gives the grouped QKV and the GLU their cuts; without
    it every sharded dim is cut in contiguous chunks."""
    return _map_with_specs(
        lambda t, s: shard_leaf(t, s, tp_rank, tp_size, cfg), full_tree,
        specs)


def gather_params(local_tree, specs, cfg=None, group=None):
    """The full tree from every rank's slices, on every rank of the tp
    group (a collective: every rank calls it)."""
    def one(t, s):
        if _tp_dim(s) is None:
            return t.detach().clone()
        parts = mappings.collective("all_gather", t.detach().unsqueeze(0),
                                    group, dim=0).unbind(0)
        return unshard_leaf(list(parts), s, cfg)

    return _map_with_specs(one, local_tree, specs)


def _map_with_specs(fn: Callable, tree, specs):
    if isinstance(tree, dict):
        return {k: _map_with_specs(fn, v, specs[k]) for k, v in
                tree.items()}
    return fn(tree, specs)


def tp_sharder(cfg):
    """``fn(subtree, spec_subtree) -> local subtree`` for the topology's
    tp rank and size, or None at tp 1 (what ``init_language_model_params``
    takes to keep each leaf's shard as it draws the full leaf)."""
    tp = topology.get_tensor_model_parallel_world_size()
    if tp == 1:
        return None
    head_layout(cfg, tp)
    rank = topology.get_tensor_model_parallel_rank()
    return lambda tree, specs: shard_params(tree, specs, rank, tp, cfg)


# ---------------------------------------------------------------------------
# ZeRO-1: the optimizer state's dp slices
# ---------------------------------------------------------------------------

# the logical -> mesh axis table the JAX package shards with (its
# ``DEFAULT_RULES``, the entries a param spec can name): ZeRO-1 reads it to
# skip a leaf already on dp
DEFAULT_RULES = {"vocab": topology.TP_AXIS, "ffn": topology.TP_AXIS,
                 "heads": topology.TP_AXIS, "kv_heads": topology.TP_AXIS,
                 "stage": topology.PP_AXIS, "expert": topology.DP_AXIS,
                 "dp_shard": topology.DP_AXIS, "hidden": None, None: None}


def dp_shard_dim(spec, shape, dp: int, rules=None) -> Optional[int]:
    """The dim of a leaf whose optimizer state ZeRO-1 splits over dp (the
    JAX package's ``state_specs(zero1=True)``): the first dim whose
    logical axis is None and whose size divides by dp.  None when dp is
    1, when the leaf is already on dp under ``rules`` (the MoE's
    ``expert`` axis by default), or when no dim qualifies: the state then
    stays replicated.  A stacked leaf leads with ``'stage'``, so its
    layer axis is never the dp dim."""
    if dp <= 1:
        return None
    active = rules if rules is not None else DEFAULT_RULES
    if any(active.get(ax) == topology.DP_AXIS for ax in spec
           if ax is not None):
        return None
    for i, (ax, n) in enumerate(zip(spec, shape)):
        if ax is None and n % dp == 0:
            return i
    return None


def zero1_state_specs(specs, params, dp: int, rules=None):
    """The spec tree of the ZeRO-1 state (``master_params``,
    ``exp_avg``, ``exp_avg_sq`` each): ``specs`` with ``'dp_shard'`` on
    each leaf's ``dp_shard_dim``."""
    def one(t, spec):
        dim = dp_shard_dim(spec, t.shape, dp, rules)
        spec = tuple(spec)
        return spec if dim is None else \
            spec[:dim] + ("dp_shard",) + spec[dim + 1:]

    return _map_with_specs(one, params, specs)


# ---------------------------------------------------------------------------
# the step's grads at tp x dp
# ---------------------------------------------------------------------------

class TensorParallelPlan:
    """What a step needs to know of the tree's placement at tp x dp:
    which leaves are sharded over tp, which replicated leaves saw a
    sequence shard in the forward, which part of the QKV leaf several
    ranks hold, and, under ZeRO-1, which dim of each leaf's optimizer
    state is cut over dp (``zero_dims``).  Built from this rank's tree
    or from the one-device tree alike (a dp dim is never a tp dim, so
    its size is the same in both).

    * ``finish_grads`` completes a step's grads over tp in place: under
      sequence parallelism each replicated leaf (the norms' scales and
      biases, the row-parallel linears' biases, the position embedding)
      got only its own sequence shard's contribution, and the sum over
      the tp ranks is its grad; the K/V columns that tp / ng ranks share
      get the sum of those ranks' contributions.
    * ``reduce_grads`` sums them over dp: an all-reduce, or under ZeRO-1
      a reduce-scatter onto each rank's state slice (``dp_slice``) for
      the leaves that have one.
    * ``unique_parts`` names the elements this rank counts in a global
      sum (the grad norm, the zero count, the layer stats): all of a
      tp-sharded leaf, a tp-replicated leaf on tp rank 0 only, the shared
      K/V columns on the first rank of their group only; over dp, a
      ZeRO-1 slice on every rank (the slices are disjoint) and anything
      else on dp rank 0 only.  ``global_sum`` adds them over tp, then
      over dp; ``all_finite`` agrees a flag over the whole world.
    * ``gather_leaf`` / ``shard_leaf``: a leaf (or its optimizer state)
      between this rank's piece and the one-device layout, for the
      checkpoints and the snapshots.
    """

    def __init__(self, params, cfg, sequence_parallel: bool,
                 zero1: bool = False):
        self.tp = topology.get_tensor_model_parallel_world_size()
        self.rank = topology.get_tensor_model_parallel_rank()
        self.dp = topology.get_data_parallel_world_size()
        self.dp_rank = topology.get_data_parallel_rank()
        self.sequence_parallel = sequence_parallel
        self.zero1 = bool(zero1) and self.dp > 1
        self.cfg = cfg
        self.layout = head_layout(cfg, self.tp)
        self.specs = {p: s for p, s in tree_leaves_with_path(
            language_model_param_specs(params, cfg))}
        self.zero_dims = {}
        if self.zero1:
            self.zero_dims = {
                p: dp_shard_dim(self.specs[p], t.shape, self.dp)
                for p, t in tree_leaves_with_path(params)}

    # -- collectives over the axes of size > 1 ------------------------------

    def tp_sum(self, x: torch.Tensor) -> torch.Tensor:
        return x if self.tp == 1 else mappings.collective("all_reduce", x)

    def dp_sum(self, x: torch.Tensor) -> torch.Tensor:
        return x if self.dp == 1 else mappings.collective(
            "all_reduce", x, topology.get_data_parallel_group())

    def all_sum(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of ``x`` over tp, then over dp."""
        return self.dp_sum(self.tp_sum(x))

    # -- ZeRO-1 slices ------------------------------------------------------

    def zero_dim(self, path) -> Optional[int]:
        return self.zero_dims.get(path)

    def dp_slice(self, path, t: torch.Tensor) -> torch.Tensor:
        """This dp rank's slice (a view) of a leaf's ``zero_dim``; the
        leaf itself when it has none."""
        dim = self.zero_dim(path)
        if dim is None:
            return t
        n = t.shape[dim] // self.dp
        return t.narrow(dim, self.dp_rank * n, n)

    def dp_gather(self, path, t: torch.Tensor) -> torch.Tensor:
        """The dp ranks' slices of a leaf joined along its ``zero_dim``
        (every rank of the dp group calls it)."""
        dim = self.zero_dim(path)
        if dim is None:
            return t
        return mappings.collective("all_gather", t,
                                   topology.get_data_parallel_group(),
                                   dim=dim)

    # -- grads ----------------------------------------------------------------

    def _qkv(self, path) -> bool:
        return "query_key_value" in path and self.layout.kv_shared

    def _kv_split(self, t: torch.Tensor):
        """(query part, K/V part) of a local QKV leaf, along its last dim
        unflattened to [1, nh_local + 2, d]."""
        lay = self.layout
        g = t.unflatten(-1, (1, lay.nh_local + 2, lay.d))
        return g[..., :lay.nh_local, :], g[..., lay.nh_local:, :]

    def finish_grads(self, named_grads) -> None:
        """``named_grads``: [(path, grad)] of this rank's tree, fp32,
        reduced over tp in place."""
        if self.tp == 1:
            return
        for path, g in named_grads:
            spec = self.specs[path]
            if self.sequence_parallel and not is_sharded(spec):
                g.copy_(mappings.collective("all_reduce", g))
            elif self._qkv(path):
                self._sum_shared_kv(g)

    def _sum_shared_kv(self, g: torch.Tensor) -> None:
        # every rank puts its K/V columns in its group's slot of a [ng]
        # buffer, zeros elsewhere; the all-reduce sums each group's
        # ranks, and each rank reads its own group back
        lay = self.layout
        _, kv = self._kv_split(g)
        buf = torch.zeros((lay.ng,) + tuple(kv.shape), dtype=g.dtype,
                          device=g.device)
        grp = lay.group_of(self.rank)
        buf[grp] = kv
        total = mappings.collective("all_reduce", buf)
        kv.copy_(total[grp])

    def reduce_grads(self, named_grads) -> list:
        """The grads summed over dp: [(path, grad)] with each leaf's whole
        sum (an all-reduce, in place), or under ZeRO-1 this rank's slice
        of it for a leaf with a ``zero_dim`` (a reduce-scatter)."""
        if self.dp == 1:
            return list(named_grads)
        group = topology.get_data_parallel_group()
        out = []
        for path, g in named_grads:
            dim = self.zero_dim(path)
            if dim is None:
                g.copy_(mappings.collective("all_reduce", g, group))
                out.append((path, g))
            else:
                out.append((path, mappings.collective(
                    "reduce_scatter", g, group, dim=dim)))
        return out

    # -- counting each element once -----------------------------------------

    def unique_parts(self, path, t: torch.Tensor, sliced: bool = False
                     ) -> list:
        """The parts of this rank's ``t`` that it counts in a global sum.
        ``sliced``: ``t`` is the ZeRO-1 slice of a leaf that has one (the
        reduced grads, the state), not the whole tp-local leaf."""
        if not (sliced and self.zero_dim(path) is not None) \
                and self.dp_rank != 0:
            return []
        if not is_sharded(self.specs[path]):
            return [t] if self.rank == 0 else []
        if self._qkv(path):
            q, kv = self._kv_split(t)
            first = self.rank % self.layout.ranks_per_group == 0
            return [q, kv] if first else [q]
        return [t]

    def global_sum(self, named, fn, sliced: bool = False) -> torch.Tensor:
        """The sum over tp x dp of ``fn(part)`` (a 0-dim tensor) over
        every part each rank counts (``unique_parts``), in fp32."""
        dev = named[0][1].device
        total = torch.zeros((), dtype=torch.float32, device=dev)
        for path, t in named:
            for part in self.unique_parts(path, t, sliced):
                total = total + fn(part).float()
        return self.all_sum(total)

    def all_finite(self, finite: torch.Tensor) -> torch.Tensor:
        """The world's consensus on a local all-finite flag (a 0-dim
        float tensor, 1.0 when finite): every rank skips the same
        step."""
        import torch.distributed as dist

        return mappings.collective("all_reduce", finite, dist.group.WORLD,
                                   reduce="min")

    # -- the one-device layout ------------------------------------------------

    def gather_leaf(self, path, t: torch.Tensor, sliced: bool = False
                    ) -> Optional[torch.Tensor]:
        """The one-device leaf on global rank 0 from every rank's piece (a
        collective: every rank calls it; the others get None).
        ``sliced``: ``t`` is a ZeRO-1 state slice.  The pieces are
        gathered to rank 0 alone, over dp into each dp rank 0, then over
        tp, on host tensors under gloo: the bytes a save must move to
        its writer, and no more."""
        if sliced and self.zero_dim(path) is not None:
            t = self._to_root(t, topology.get_data_parallel_group(),
                              self.zero_dim(path))
        if self.dp_rank != 0:
            return None
        spec = self.specs[path]
        if self.tp == 1 or _tp_dim(spec) is None:
            return t.detach() if self.rank == 0 else None
        parts = self._to_root(t.unsqueeze(0),
                              topology.get_tensor_model_parallel_group())
        return None if parts is None else \
            unshard_leaf(list(parts.unbind(0)), spec, self.cfg)

    @staticmethod
    def _to_root(t: torch.Tensor, group, dim: int = 0):
        """``t`` of every rank of ``group`` joined along ``dim`` on its
        first rank (None elsewhere): on host tensors under gloo."""
        import torch.distributed as dist

        x = t.detach()
        if dist.get_backend(group) != "nccl":
            x = x.cpu()
        return mappings.collective("gather", x, group, dim=dim)

    def shard_leaf(self, path, full: torch.Tensor, sliced: bool = False
                   ) -> torch.Tensor:
        """This rank's piece of a one-device leaf (a new tensor): its tp
        slice, and with ``sliced`` its ZeRO-1 slice of that."""
        local = shard_leaf(full, self.specs[path], self.rank, self.tp,
                           self.cfg)
        return self.dp_slice(path, local).contiguous() if sliced else local


def plan_for(params, cfg, sequence_parallel: bool, zero1: bool = False):
    """A ``TensorParallelPlan`` at tp > 1 or dp > 1, else None."""
    if topology.get_tensor_model_parallel_world_size() == 1 \
            and topology.get_data_parallel_world_size() == 1:
        return None
    return TensorParallelPlan(params, cfg, sequence_parallel, zero1)
