"""Model-health observatory: per-layer gradient, update and parameter
diagnostics (the counterpart of ``megatron_llm_tpu/health.py``).

The optimizer step can report fixed-shape per-group stats — one slot per
top-level param subtree (embedding, each transformer layer, final norm,
lm head): grad L2 norm, param L2 norm, update L2 norm and non-finite grad
count.  The groups come from the tree paths (``tree.py``
``tree_leaves_with_path``; the port's param tree is the JAX package's),
so ``embedding`` / ``transformer.layers`` (stacked, leading axis = layer)
/ ``transformer.final_norm`` / ``lm_head`` give the JAX names
(``embedding``, ``layer_000``..., ``final_norm``, ``lm_head``) for every
family, a mixture of experts' ``mlp.router`` and ``mlp.experts`` leaves
included (they sit under ``layers``), and an unknown top-level subtree is
its own group.  A stacked leaf ``[L, ...]`` is one reduction over all but
its leading axis.

The optimizer step (``optimizer.MegatronOptimizer.step(...,
layer_stats=True)``) accumulates the same sums leaf by leaf inside its
in-place update loop (``GroupStats``); ``compute_layer_stats`` gives them
from whole trees.  The host-side helpers (``to_record``,
``find_offenders``, ``describe_offenders``) are copies of the JAX
package's: they turn the stats into the JSONL record shape and into a
diagnosis ("first group with non-finite grads", grad-norm outliers vs.
the median) used by the resilience rewind path and
``tools/health_report.py``.
"""

import math
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from megatron_llm_torch.tree import tree_leaves_with_path

# Update-to-weight ratios outside this band usually mean the LR is badly
# tuned for that tensor (too small: frozen; too large: thrashing). Shared
# convention with tools/health_report.py (stdlib-only, so it keeps its own
# copy of the numbers).
UPDATE_RATIO_BAND = (1e-4, 1e-2)

LAYER_GROUP_FMT = "layer_{:03d}"


def _classify(path: Sequence[str]) -> Tuple[bool, str]:
    """Map a tree path to (is_stacked_layers, group_name).

    Stacked transformer layers (any path passing through a ``layers`` key)
    report per-leading-axis-row stats; every other leaf folds into a group
    named after its most specific stable ancestor.
    """
    names = [str(p) for p in path]
    if not names:
        return False, "params"
    if "layers" in names:
        return True, "layers"
    if names[0] == "transformer":
        return False, names[1] if len(names) > 1 else "transformer"
    return False, names[0]


def layer_group_names(params, plan=None) -> List[str]:
    """Deterministic group names for a param tree: ``embedding`` first (when
    present), then one ``layer_NNN`` per stacked transformer-layer row, then
    the remaining top-level groups in flatten order (``final_norm``,
    ``lm_head``, ...).  At pp > 1 (a ``plan`` whose ``pp`` is) ``params``
    is a stage's, and the names are the whole stack's: ``layer_NNN``
    indexes the stacked rows, which are stage-major under the interleaved
    pipeline (the JAX package's ``health.py:18-21``)."""
    if plan is not None and getattr(plan, "pp", 1) > 1:
        names = layer_group_names(params)
        start = _layer_slot(names)
        rows = sum(1 for n in names if n.startswith("layer_"))
        return (names[:start] + [LAYER_GROUP_FMT.format(i)
                                 for i in range(plan.num_layers)]
                + names[start + rows:])
    num_layers = 0
    others: List[str] = []
    for path, leaf in tree_leaves_with_path(params):
        stacked, g = _classify(path)
        if stacked:
            num_layers = max(num_layers, int(leaf.shape[0]))
        elif g not in others:
            others.append(g)
    names: List[str] = []
    if "embedding" in others:
        names.append("embedding")
        others.remove("embedding")
    names.extend(LAYER_GROUP_FMT.format(i) for i in range(num_layers))
    names.extend(others)
    return names


def _layer_slot(names: Sequence[str]) -> int:
    first = LAYER_GROUP_FMT.format(0)
    return names.index(first) if first in names else len(names)


class GroupStats:
    """Per-group fp32 sums of squares and non-finite counts, accumulated
    one leaf (or one stacked row) at a time, on the leaves' device.

    ``slots(path, leaf)`` gives the leaf's group slot (``int``) or, for a
    stacked leaf, the start of its row slots; ``add`` takes a [rows]
    vector for a stacked leaf (one reduction over all but the leading
    axis) or a scalar, and ``add_sumsq`` reduces a tensor of the leaf
    itself.

    At tp x dp a ``plan`` (``parallel/sharding.TensorParallelPlan``)
    makes ``add_sumsq`` count each element once, as the grad norm does
    (``unique_parts``; ``sliced``: the tensors are ZeRO-1 slices), and
    ``result`` sums the groups over tp x dp, so that every rank holds the
    one-device stats.  At pp > 1 a stage's stacked rows take the slots
    of its rows of the whole stack (``plan.row0`` on), and ``result``
    sums over pp too."""

    def __init__(self, names: Sequence[str], device, plan=None,
                 sliced: bool = False):
        self.plan, self.sliced = plan, sliced
        self.names = list(names)
        self.start = _layer_slot(self.names) + (
            getattr(plan, "row0", 0) if plan is not None else 0)
        self.device = device
        self.sumsq = {k: torch.zeros(len(self.names), dtype=torch.float32,
                                     device=device)
                      for k in ("grad_norm", "param_norm", "update_norm")}
        self.nonfinite = torch.zeros(len(self.names), dtype=torch.int64,
                                     device=device)

    def slots(self, path) -> Tuple[bool, int]:
        stacked, g = _classify(path)
        return stacked, (self.start if stacked else self.names.index(g))

    def add(self, key: str, path, value: torch.Tensor,
            row: Optional[int] = None) -> None:
        """Add ``value`` (a sum of squares, or with ``key`` "nonfinite" a
        count) to the leaf's slot: a [rows] vector for a whole stacked
        leaf, a scalar for a plain leaf or for stacked row ``row``."""
        stacked, slot = self.slots(path)
        acc = self.nonfinite if key == "nonfinite" else self.sumsq[key]
        value = value.to(acc.dtype)
        if stacked and row is None:
            acc[slot:slot + value.numel()] += value
        else:
            acc[slot + (row or 0)] += value

    def add_sumsq(self, key: str, path, t: torch.Tensor,
                  row: Optional[int] = None) -> None:
        """Add the sum of squares of ``t`` (with ``key`` "nonfinite", its
        count of non-finite entries) to the leaf's slot, counting only
        the parts of ``t`` this rank counts: ``t`` is the whole leaf
        (per row when stacked), or stacked row ``row`` of it."""
        stacked, _ = self.slots(path)
        per_row = stacked and row is None
        parts = [t] if self.plan is None else \
            self.plan.unique_parts(path, t, self.sliced)
        fn = row_nonfinite if key == "nonfinite" else row_sumsq
        for part in parts:
            self.add(key, path, fn(part, per_row), row=row)

    def result(self, updates: bool = True) -> Dict[str, torch.Tensor]:
        """The fixed-shape [G] stats: fp32 norms, int32 counts."""
        sums = dict(self.sumsq)
        nonfinite = self.nonfinite
        if self.plan is not None:
            keys = [k for k in ("grad_norm", "param_norm", "update_norm")
                    if updates or k != "update_norm"]
            total = self.plan.all_sum(torch.cat([sums[k] for k in keys]))
            n = len(self.names)
            for i, k in enumerate(keys):
                sums[k] = total[i * n:(i + 1) * n]
            nonfinite = self.plan.all_sum(nonfinite)
        out = {"grad_norm": sums["grad_norm"].sqrt(),
               "param_norm": sums["param_norm"].sqrt(),
               "nonfinite_grads": nonfinite.to(torch.int32)}
        if updates:
            out["update_norm"] = sums["update_norm"].sqrt()
        return out


def row_sumsq(x: torch.Tensor, stacked: bool) -> torch.Tensor:
    """fp32 sum of squares of ``x``: per leading-axis row for a stacked
    leaf, else one scalar."""
    x = x.float()
    if stacked:
        return x.square().reshape(x.shape[0], -1).sum(dim=1)
    return x.square().sum()


def row_nonfinite(x: torch.Tensor, stacked: bool) -> torch.Tensor:
    """Count of non-finite entries: per row for a stacked leaf."""
    bad = ~torch.isfinite(x)
    if stacked:
        return bad.reshape(x.shape[0], -1).sum(dim=1)
    return bad.sum()


def compute_layer_stats(params, grads, updates=None, plan=None,
                        sliced: bool = False) -> Dict[str, torch.Tensor]:
    """Per-group stats of whole trees (all share the param tree's
    structure): ``grads`` should be the unscaled, pre-clip gradients (so
    grad norms partition the global grad norm) and ``updates`` the
    applied master-weight delta (zero on a skipped overflow step).
    Returns fixed-shape ``[G]`` tensors — grad_norm, param_norm,
    update_norm (fp32), nonfinite_grads (int32) — in
    ``layer_group_names(params)`` order.  At tp x dp, with the step's
    ``plan``, the trees are this rank's pieces (``sliced``: ZeRO-1
    slices) and the sums run over tp x dp, each element once."""
    names = layer_group_names(params, plan)
    leaves = tree_leaves_with_path(params)
    gs = GroupStats(names, leaves[0][1].device if leaves else "cpu", plan,
                    sliced)
    trees = (("param_norm", params), ("grad_norm", grads))
    if updates is not None:
        trees += (("update_norm", updates),)
    for key, tree in trees:
        for path, leaf in tree_leaves_with_path(tree):
            gs.add_sumsq(key, path, leaf)
            if key == "grad_norm":
                gs.add_sumsq("nonfinite", path, leaf.float())
    return gs.result(updates=updates is not None)


# ---------------------------------------------------------------------------
# Host-side: JSONL records and offender diagnosis.
# ---------------------------------------------------------------------------

def to_record(names: Sequence[str], stats) -> Dict[str, Any]:
    """Fetched stats dict -> the JSONL / flight-recorder record shape.

    `stats` values are host sequences (``tensor.tolist()``). Non-finite
    floats become the strings "nan"/"inf"/"-inf" so the record stays plain
    JSON. Adds the derived per-group update-to-weight ratio.
    """
    def _num(x):
        x = float(x)
        if math.isfinite(x):
            return x
        return "nan" if math.isnan(x) else ("inf" if x > 0 else "-inf")

    rec: Dict[str, Any] = {"groups": list(names)}
    for key in ("grad_norm", "param_norm", "update_norm"):
        if key in stats:
            rec[key] = [_num(v) for v in stats[key]]
    if "nonfinite_grads" in stats:
        rec["nonfinite_grads"] = [int(v) for v in stats["nonfinite_grads"]]
    if "update_norm" in rec and "param_norm" in rec:
        ratios = []
        for u, p in zip(rec["update_norm"], rec["param_norm"]):
            if isinstance(u, str) or isinstance(p, str) or p <= 0.0:
                ratios.append(None)
            else:
                ratios.append(u / p)
        rec["update_ratio"] = ratios
    return rec


def record_value(rec_val) -> float:
    """Inverse of to_record's non-finite string encoding."""
    if isinstance(rec_val, str):
        return {"nan": math.nan, "inf": math.inf, "-inf": -math.inf}.get(
            rec_val, math.nan)
    return float(rec_val)


def derived_params_norm(record: Dict[str, Any]) -> float:
    """Global params norm from the per-group partition of sum-of-squares —
    exact (up to fp rounding), so --log_params_norm needs no second
    whole-tree reduction when layer stats are on."""
    return math.sqrt(sum(record_value(v) ** 2
                         for v in record.get("param_norm", [])))


def find_offenders(record: Dict[str, Any], top_k: int = 3,
                   outlier_factor: float = 4.0) -> Dict[str, Any]:
    """Diagnose a layer-stats record: which groups look responsible?

    Returns {"first_nonfinite", "nonfinite" (all such groups),
    "outliers": [{"group", "grad_norm", "ratio_to_median"}] (top_k, only
    groups whose finite grad norm exceeds outlier_factor x the median)}.
    """
    groups = record.get("groups", [])
    nf = record.get("nonfinite_grads") or [0] * len(groups)
    gn = [record_value(v) for v in record.get("grad_norm", [])]
    nonfinite = [g for g, n in zip(groups, nf) if n > 0]
    finite = sorted(v for v in gn if math.isfinite(v))
    outliers: List[Dict[str, Any]] = []
    if finite:
        mid = len(finite) // 2
        median = (finite[mid] if len(finite) % 2 else
                  0.5 * (finite[mid - 1] + finite[mid]))
        if median > 0.0:
            ranked = sorted(
                ((v / median, g, v) for g, v in zip(groups, gn)
                 if math.isfinite(v) and v > outlier_factor * median),
                reverse=True)
            outliers = [{"group": g, "grad_norm": v, "ratio_to_median": r}
                        for r, g, v in ranked[:top_k]]
    return {
        "first_nonfinite": nonfinite[0] if nonfinite else None,
        "nonfinite": nonfinite,
        "outliers": outliers,
    }


def describe_offenders(offenders: Dict[str, Any]) -> Optional[str]:
    """One-line human summary for rewind logs / flight-recorder dump
    reasons; None when nothing looks wrong."""
    parts = []
    nonfinite = offenders.get("nonfinite") or []
    if nonfinite:
        shown = ", ".join(nonfinite[:4])
        more = f" (+{len(nonfinite) - 4} more)" if len(nonfinite) > 4 else ""
        parts.append(f"non-finite grads in [{shown}{more}], "
                     f"first: {offenders['first_nonfinite']}")
    outliers = offenders.get("outliers") or []
    if outliers:
        shown = ", ".join(f"{o['group']} ({o['ratio_to_median']:.1f}x median)"
                          for o in outliers)
        parts.append(f"grad-norm outliers: {shown}")
    return "; ".join(parts) if parts else None
