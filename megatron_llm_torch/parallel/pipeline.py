"""Pipeline parallelism over the pp group of ``torch.distributed``: the
1F1B and interleaved schedules (the counterpart of
``megatron_llm_tpu/parallel/pipeline.py``).

The JAX package writes both engines as one compiled ``lax.scan`` over
pipeline ticks inside a ``shard_map`` manual over pp, with
``lax.ppermute`` for the point-to-point steps.  Here each stage is a
process that runs the same tick loop eagerly and steps its activations
with ``mappings.permute_many`` (an ``isend`` / ``irecv`` of each tensor,
all of a tick's posted before any is waited on).  Every stage works out
the sequence of point-to-point ops from (tick, stage) alone, so a send
always meets the receive its neighbour posts: a stage skips the work the
JAX engine masks (the embedding off stage 0, the head and the loss off
the last stage, the bubble ticks) and, with both ends agreeing, the
messages that would carry nothing (bubbles, and at one virtual stage
the wrap-around from the last stage to stage 0).

1. **1F1B** (``build_pipeline_grad_fn``, one virtual stage): T = M + 2S
   - 1 ticks; at tick t stage k runs the forward of micro batch t - k
   and the backward of micro batch t - (2S - 1 - k).  The forward keeps
   its input in a stash of 2S slots and runs without a graph; the
   backward recomputes the chunk from the stash (on the last stage with
   the final norm, the head and the cross entropy; on stage 0 from the
   embedding) and takes ``torch.autograd.grad`` with the incoming
   cotangent, or on the last stage the seed ``scale / tok_tot``.  The
   last stage's forward would feed only the head, which its backward
   recomputes, so it runs no forward of its own.  The grads accumulate
   in fp32; the live activations are the stash, flat in M.
2. **Stream** (``build_pipeline_loss_fn``, any number V of virtual
   stages, the interleaved schedule): work item w = g S V + v S + r is
   chunk v of micro batch m = g S + r; stage k runs item t - k at tick
   t, T = M V + S - 1 ticks.  Autograd does not run through the
   point-to-point ops across the schedule: it would order a rank's
   backward nodes by that rank's graph and skip the nodes whose outputs
   went unused, and either can leave a stage waiting on a receive its
   neighbour never posts.  The engine runs as the JAX engine's per-tick
   ``jax.checkpoint`` behaves: a forward sweep without a graph that
   keeps each tick's input, then a reverse sweep that recomputes each
   tick under ``torch.autograd.grad`` and steps its input's cotangent
   back.  At V > 1 the wrap-around carries chunk v of the last stage to
   chunk v + 1 of stage 0, and its cotangent back.

The objective is the JAX engines': the masked cross-entropy sum over the
whole global batch over its token count, ``ce_tot / tok_tot`` (not the
mean of micro-batch means that ``training.build_train_step`` takes), and
for a mixture of experts the routing aux's mean over the micro batches
with its coefficients.  Dropout keys follow the JAX engines: the
embedding of micro batch m draws from ``fold_in(fold_in(key, 1), m)``
and layer row j (the stage-major stacked row) from
``fold_in(fold_in(fold_in(key, 2), m), j)``, so the 1F1B recompute
replays the forward's masks and both engines draw the same.

Every stage holds the embedding, the final norm and the head, as the
JAX package replicates them over pp; their grads are summed over the pp
group (a tied head's into the word table, through the one leaf).  Under
tp each stage runs the tensor-parallel layers on its own tp group.  The
layer stack is stage-major at V > 1 (``vpp_stage_major_permutation``):
stage k's rows hold its V chunks in chunk order, chunk v of stage k
being natural layers [(v S + k) cl, (v S + k + 1) cl); checkpoints stay
in natural order (``TensorParallelPlan.gather_leaf`` / ``shard_leaf``
convert).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from megatron_llm_torch import random as mrandom
from megatron_llm_torch import topology
from megatron_llm_torch.tree import (
    tree_leaves,
    tree_leaves_with_path,
    tree_map,
    tree_unflatten,
)

# ---------------------------------------------------------------------------
# the VPP layer-stack layout
# ---------------------------------------------------------------------------


def _check_divides(num_layers: int, pp: int, vpp: int) -> None:
    if num_layers % (pp * vpp):
        raise ValueError(f"num_layers {num_layers} must divide by pp x vpp "
                         f"({pp} x {vpp})")


def vpp_stage_major_permutation(num_layers: int, pp: int, vpp: int
                                ) -> np.ndarray:
    """Index array ``perm`` with ``stage_major = natural[perm]``: stacked
    row ``j = k (L / S) + v cl + i`` holds natural layer ``(v S + k) cl +
    i``, so that stage k's contiguous L / S rows are its V chunks in
    chunk order."""
    L, S, V = num_layers, pp, vpp
    _check_divides(L, S, V)
    cl = L // (S * V)
    perm = np.empty(L, np.int64)
    j = 0
    for k in range(S):
        for v in range(V):
            for i in range(cl):
                perm[j] = (v * S + k) * cl + i
                j += 1
    return perm


def take_rows(x, idx):
    """Rows ``idx`` of a tensor's or numpy array's first dim, in order (a
    new array)."""
    if isinstance(x, torch.Tensor):
        return x.index_select(0, torch.as_tensor(idx, device=x.device))
    return np.asarray(x)[idx]


def permute_layer_stack(layers, num_layers: int, pp: int, vpp: int):
    """Natural layer order -> stage-major order (the tree itself at vpp
    1); leaves are tensors or numpy arrays."""
    if vpp <= 1:
        return layers
    perm = vpp_stage_major_permutation(num_layers, pp, vpp)
    return tree_map(lambda x: take_rows(x, perm), layers)


def unpermute_layer_stack(layers, num_layers: int, pp: int, vpp: int):
    """Stage-major order -> natural layer order (the tree itself at vpp
    1)."""
    if vpp <= 1:
        return layers
    inv = np.argsort(vpp_stage_major_permutation(num_layers, pp, vpp))
    return tree_map(lambda x: take_rows(x, inv), layers)


def convert_params_layout(params, num_layers: int, pp: int, vpp: int, *,
                          to_stage_major: bool):
    """Permute the ``transformer.layers`` subtree of a params-like tree
    between natural order (checkpoints, converters) and stage-major
    order; the tree itself at vpp 1 or without that subtree."""
    if vpp <= 1 or params is None:
        return params
    tr = params.get("transformer") if isinstance(params, dict) else None
    if not isinstance(tr, dict) or "layers" not in tr:
        return params
    fn = permute_layer_stack if to_stage_major else unpermute_layer_stack
    out = dict(params)
    out["transformer"] = dict(tr)
    out["transformer"]["layers"] = fn(tr["layers"], num_layers, pp, vpp)
    return out


def convert_opt_state_layout(opt_state, num_layers: int, pp: int, vpp: int,
                             *, to_stage_major: bool):
    """``convert_params_layout`` on every params-shaped tree of an
    ``OptimizerState`` (the moments and the masters)."""
    if vpp <= 1 or opt_state is None:
        return opt_state

    def conv(tree):
        return convert_params_layout(tree, num_layers, pp, vpp,
                                     to_stage_major=to_stage_major)

    return opt_state._replace(
        exp_avg=conv(opt_state.exp_avg),
        exp_avg_sq=conv(opt_state.exp_avg_sq),
        master_params=conv(opt_state.master_params))


def stage_layer_rows(num_layers: int, pp: int, vpp: Optional[int],
                     pp_rank: int) -> list:
    """The natural layers stage ``pp_rank`` holds, in its row order."""
    vpp = vpp or 1
    _check_divides(num_layers, pp, vpp)
    n = num_layers // pp
    perm = vpp_stage_major_permutation(num_layers, pp, vpp)
    return [int(i) for i in perm[pp_rank * n:(pp_rank + 1) * n]]


def stage_rows(tree, pp_rank: int, pp: int, vpp: Optional[int],
               num_layers: int):
    """A params-like tree (natural order, numpy or tensor leaves) cut to
    stage ``pp_rank``: its rows of the stage-major layer stack; the other
    leaves whole (every stage holds them)."""
    if pp <= 1:
        return tree
    rows = stage_layer_rows(num_layers, pp, vpp, pp_rank)
    out = dict(tree)
    out["transformer"] = dict(tree["transformer"])
    out["transformer"]["layers"] = tree_map(
        lambda x: take_rows(x, rows), tree["transformer"]["layers"])
    return out


def _decode_item(w: int, M: int, S: int, V: int):
    """Work item w -> (micro batch m, chunk v, valid): mixed radix w = g
    (S V) + v S + r with m = g S + r; V 1 gives m = w."""
    valid = 0 <= w < M * V
    if not valid:
        return 0, 0, False
    if V == 1:
        return w, 0, True
    g, rem = divmod(w, S * V)
    v, r = divmod(rem, S)
    return g * S + r, v, True


# ---------------------------------------------------------------------------
# a stage's pieces
# ---------------------------------------------------------------------------

def refuse_at_pp(model, loss_func=None) -> None:
    """The pipeline drives the GPT families' decoder stacks only: BERT,
    T5, ICT and the classification heads raise at pp > 1, as does any
    loss but the masked token mean."""
    from megatron_llm_torch.models.gpt import GPTModel

    pp = topology.get_pipeline_model_parallel_world_size()
    if pp <= 1:
        return
    cfg = getattr(model, "cfg", None)
    if not isinstance(model, GPTModel) or getattr(cfg, "num_tokentypes", 0):
        raise NotImplementedError(
            f"{type(model).__name__} at pipeline-parallel size {pp}: the "
            f"pipeline drives the GPT families' decoder stacks only (BERT, "
            f"T5, ICT and the classification heads are not pipelined, as "
            f"in the JAX package)")
    from megatron_llm_torch.training import default_loss_func

    if loss_func is not None and loss_func is not default_loss_func:
        raise NotImplementedError(
            f"a loss other than the masked token mean at pipeline-parallel "
            f"size {pp}: the pipeline's objective is the global batch's "
            f"token mean")


class _Stage:
    """This rank's stage of a schedule: its chunks, the embedding, the
    head and the loss, and the dropout keys."""

    def __init__(self, model, S: int, M: int, V: int,
                 sequence_parallel: bool):
        from megatron_llm_torch.models.transformer import rotary_freqs

        cfg = model.cfg
        if topology.get_pipeline_model_parallel_world_size() != S:
            raise ValueError(
                f"a pipeline of {S} stages, but the topology's pp is "
                f"{topology.get_pipeline_model_parallel_world_size()}: "
                f"initialize_model_parallel first")
        L = cfg.num_layers
        _check_divides(L, S, V)
        if V > 1 and M % S:
            # the reference's interleaved schedule groups the micro
            # batches by stage (schedules.py:253-266)
            raise ValueError(f"the interleaved pipeline needs the micro "
                             f"batches ({M}) to divide by the stages ({S})")
        refuse_at_pp(model)
        self.cfg = cfg.replace(sequence_parallel=bool(sequence_parallel))
        self.S, self.M, self.V = S, M, V
        self.cl = L // (S * V)
        self.local_L = L // S
        self.k = topology.get_pipeline_model_parallel_rank()
        self.moe = cfg.num_experts > 1
        self.device = model.device
        self.freqs = rotary_freqs(self.cfg, device=self.device)

    # -- keys ---------------------------------------------------------------

    def keys(self, rng_key, train: bool):
        cfg = self.cfg
        on = (train and rng_key is not None
              and (cfg.hidden_dropout > 0.0 or cfg.attention_dropout > 0.0))
        self.dropout = on
        self.emb_key0 = mrandom.fold_in(rng_key, 1) if on else None
        self.lay_key0 = mrandom.fold_in(rng_key, 2) if on else None

    # -- compute --------------------------------------------------------------

    def embed(self, emb, tokens, m: int):
        """The embedding of micro batch ``m``."""
        from megatron_llm_torch.models.language_model import embedding_forward

        key = (mrandom.fold_in(self.emb_key0, m) if self.dropout else None)
        return embedding_forward(tokens[m], None, emb, self.cfg,
                                 rng_key=key, train=self.dropout
                                 ).to(self.cfg.compute_torch_dtype)

    def chunk(self, h, rows, v: int, m: int):
        """Chunk ``v`` of this stage over ``rows`` (one tree a local row)
        for micro batch ``m``; returns (h, aux [2] fp32 or None)."""
        from megatron_llm_torch.models.transformer import transformer_layer

        aux = None
        for i in range(self.cl):
            li = v * self.cl + i
            key = None
            if self.dropout:
                key = mrandom.fold_in(mrandom.fold_in(self.lay_key0, m),
                                      self.k * self.local_L + li)
            h, _, a = transformer_layer(h, rows[li], self.cfg,
                                        freqs=self.freqs, rng_key=key,
                                        train=self.dropout)
            if self.moe:
                aux = a if aux is None else aux + a
        return h, aux

    def head_ce(self, h, fnorm, head_w, batch, m: int):
        """(masked CE sum, token count) of micro batch ``m``: the final
        norm (through the norm kernel, as the one-device stack's), the
        vocab-parallel logits and cross entropy."""
        from megatron_llm_torch.models.transformer import (
            _norm_uses_kernel,
            sequence_parallel_on,
        )
        from megatron_llm_torch.ops.cross_entropy import (
            vocab_parallel_cross_entropy,
        )
        from megatron_llm_torch.ops.layernorm import apply_norm
        from megatron_llm_torch.parallel.layers import parallel_lm_logits

        cfg = self.cfg
        h = apply_norm(h, fnorm, cfg.normalization, eps=cfg.layernorm_epsilon,
                       fp32_compute=cfg.norm_in_fp32,
                       use_kernel=_norm_uses_kernel(cfg))
        logits = parallel_lm_logits(
            h, head_w, compute_dtype=cfg.compute_torch_dtype,
            sequence_parallel=sequence_parallel_on(cfg))
        ce = vocab_parallel_cross_entropy(logits.float(), batch["labels"][m])
        wgt = batch["loss_mask"][m].float()
        return (ce * wgt).sum(), wgt.sum()

    # -- the activation a message carries ------------------------------------

    def act_like(self, batch):
        """An empty tensor of the activations the stages pass (this
        rank's sequence shard under SP); checks the batch's micro
        batches."""
        from megatron_llm_torch.models.transformer import sequence_parallel_on

        if batch["tokens"].shape[0] != self.M:
            raise ValueError(
                f"the batch holds {batch['tokens'].shape[0]} micro batches; "
                f"the schedule was built for {self.M}")
        mb, s = batch["tokens"].shape[1], batch["tokens"].shape[2]
        if sequence_parallel_on(self.cfg):
            s //= topology.get_tensor_model_parallel_world_size()
        return torch.empty((mb, s, self.cfg.hidden_size),
                           dtype=self.cfg.compute_torch_dtype,
                           device=batch["tokens"].device)


def _grad_leaves(params):
    """Leaves that take grads, sharing the params' storage: the layer
    stack one tree a row, and the rest (the embedding, the final norm,
    the head; a tied head is the word table's leaf)."""
    detach = (lambda p: p.detach().requires_grad_(True))
    layers = params["transformer"]["layers"]
    n = tree_leaves(layers)[0].shape[0]
    rows = [tree_map(lambda p, i=i: detach(p[i]), layers) for i in range(n)]
    emb = tree_map(detach, params["embedding"])
    fnorm = tree_map(detach, params["transformer"]["final_norm"])
    head = (detach(params["lm_head"]["weight"]) if "lm_head" in params
            else emb["word"]["embedding"])
    return rows, emb, fnorm, head


class _Acc:
    """fp32 grad accumulators shaped like this stage's params, and the
    additions of one chunk's grads into them."""

    def __init__(self, params):
        self.tree = tree_map(lambda p: torch.zeros(
            p.shape, dtype=torch.float32, device=p.device), params)
        self.rows = tree_leaves(self.tree["transformer"]["layers"])

    def add_rows(self, per_row, idx):
        """``per_row[j]``: the grads of local row ``idx[j]``'s leaves."""
        for r, grads in zip(idx, per_row):
            for acc, g in zip(self.rows, grads):
                if g is not None:
                    acc[r].add_(g)

    def add(self, tree, grads):
        for acc, g in zip(tree_leaves(tree), grads):
            if g is not None:
                acc.add_(g)


def _finish(acc, untied: bool):
    """The replicated leaves' grads summed over the pp group (a tied
    head's already in the word table's leaf): the JAX engines' sum of
    the per-stage stacks."""
    from megatron_llm_torch.parallel import mappings

    group = topology.get_pipeline_model_parallel_group()
    rep = [acc.tree["embedding"], acc.tree["transformer"]["final_norm"]]
    if untied:
        rep.append(acc.tree["lm_head"])
    flat = [t for tree in rep for t in tree_leaves(tree)]
    total = mappings.collective(
        "all_reduce", torch.cat([t.reshape(-1) for t in flat]), group)
    i = 0
    for t in flat:
        t.copy_(total[i:i + t.numel()].view_as(t))
        i += t.numel()
    return acc.tree


def _token_total(batch) -> torch.Tensor:
    """The global batch's masked token count (summed over dp), at least
    1: the objective's denominator, known before the schedule runs."""
    from megatron_llm_torch.training import _dp_sum

    return _dp_sum(batch["loss_mask"].float().sum()).clamp(min=1.0)


def _totals(ce_sum, tok_sum, aux_sum):
    """ce, tokens and the aux [2] summed over pp (then ce and tokens
    over dp): every rank gets the loss."""
    from megatron_llm_torch.parallel import mappings
    from megatron_llm_torch.training import _dp_sum

    vec = torch.cat([ce_sum.reshape(1), tok_sum.reshape(1), aux_sum])
    vec = mappings.collective("all_reduce", vec,
                              topology.get_pipeline_model_parallel_group())
    ct = _dp_sum(vec[:2])
    return ct[0], ct[1], vec[2:]


def _objective_seeds(cfg, M: int, scale, tok_tot):
    """The CE sum's cotangent ``scale / tok_tot`` and the routing aux's
    ``scale / M`` times its coefficients (the JAX engine's seeds)."""
    seed = torch.tensor(float(scale), dtype=torch.float32,
                        device=tok_tot.device) / tok_tot
    aux_seed = (float(scale) / M) * torch.tensor(
        [cfg.moe_aux_loss_coeff, cfg.moe_z_loss_coeff], dtype=torch.float32,
        device=tok_tot.device)
    return seed, aux_seed


def _backward(stage, x, m, idx, v, acc, leaves, batch, seed, aux_seed, cot,
              first: bool, head: bool):
    """One chunk's recompute and ``torch.autograd.grad``: chunk ``v`` over
    local rows ``idx`` from ``x`` (the kept input; on stage 0's chunk 0,
    ``first``, the embedding recomputed in the graph), with the final
    norm, the head and the CE when ``head``, seeded with the incoming
    cotangent ``cot`` or the CE seed (and the aux seed for a mixture of
    experts).  Adds the grads into ``acc``; returns (the input's
    cotangent, or None on ``first``; the CE sum, the token count and the
    aux, or None)."""
    rows_all, emb, fnorm, head_w = leaves
    if first and head:
        raise ValueError("a stage with both the embedding and the head "
                         "is not a pipeline of two or more stages")
    with torch.enable_grad():
        if first:
            x = stage.embed(emb, batch["tokens"], m)
        else:
            x = x.detach().requires_grad_(True)
        o, aux = stage.chunk(x, rows_all, v, m)
        ce = tok = None
        if head:
            ce, tok = stage.head_ce(o, fnorm, head_w, batch, m)
            outs, gos = [ce], [seed]
        else:
            outs, gos = [o], [cot]
        if aux is not None:
            outs.append(aux)
            gos.append(aux_seed)
        row_leaves = [tree_leaves(rows_all[i]) for i in idx]
        inputs = [] if first else [x]
        inputs += [t for r in row_leaves for t in r]
        # (accumulator subtree, leaves) of the replicated params in the
        # graph; a tied head is the word table's leaf
        extra = []
        if first:
            extra.append((acc.tree["embedding"], tree_leaves(emb)))
        if head:
            extra.append((acc.tree["transformer"]["final_norm"],
                          tree_leaves(fnorm)))
            extra.append((acc.tree["lm_head"] if "lm_head" in acc.tree
                          else {"w": acc.tree["embedding"]["word"][
                              "embedding"]}, [head_w]))
        for _, ls in extra:
            inputs += ls
        grads = list(torch.autograd.grad(outs, inputs, gos,
                                         allow_unused=True))
    dx = None if first else grads.pop(0)
    n = len(row_leaves[0])
    acc.add_rows([grads[j * n:(j + 1) * n] for j in range(len(idx))], idx)
    grads = grads[n * len(idx):]
    for tree, ls in extra:
        acc.add(tree, grads[:len(ls)])
        grads = grads[len(ls):]
    return (dx, None if ce is None else ce.detach(),
            None if tok is None else tok.detach(),
            None if aux is None else aux.detach())


# ---------------------------------------------------------------------------
# Engine 1: the stream schedule (any V), a forward and a reverse sweep
# ---------------------------------------------------------------------------

class _StreamLoss:
    """``loss_fn(params, batch, rng_key, scale=1.0, train=True) ->
    (scaled_loss, loss)`` (a mixture of experts: ``(scaled_total, (loss,
    aux))``) of the stream schedule's forward sweep, and
    ``value_and_grad`` with the same arguments, which also runs the
    reverse sweep and returns ``(that value, grads)``: the counterpart of
    ``jax.value_and_grad`` over the JAX engine's loss."""

    def __init__(self, model, S, M, V, sequence_parallel):
        self.model, self.S, self.M, self.V = model, S, M, V
        self.sequence_parallel = sequence_parallel

    def __call__(self, params, batch, rng_key=None, scale=1.0,
                 train: bool = True):
        with torch.no_grad():
            return self._run(params, batch, rng_key, scale, train,
                             grads=False)[0]

    def value_and_grad(self, params, batch, rng_key=None, scale=1.0,
                       train: bool = True):
        return self._run(params, batch, rng_key, scale, train, grads=True)

    # the point-to-point plan, a function of (tick, stage) alone --------

    def _sends_fwd(self, t, k):
        """Stage k sends its tick-t output on: a valid item that is not
        the last stage's last chunk (which feeds the head)."""
        m, v, valid = _decode_item(t - k, self.M, self.S, self.V)
        return valid and not (k == self.S - 1 and v == self.V - 1)

    def _recvs_fwd(self, t, k):
        """Stage k takes its tick-t input from the previous stage: a
        valid item that is not chunk 0 on stage 0 (the embedding)."""
        m, v, valid = _decode_item(t - k, self.M, self.S, self.V)
        return valid and not (k == 0 and v == 0)

    def _run(self, params, batch, rng_key, scale, train, grads: bool):
        from megatron_llm_torch.parallel import mappings

        S, M, V = self.S, self.M, self.V
        stage = _Stage(self.model, S, M, V, self.sequence_parallel)
        stage.keys(rng_key, train)
        k = stage.k
        T = M * V + S - 1
        like = stage.act_like(batch)
        tok_tot = _token_total(batch)
        dev = like.device
        leaves = _grad_leaves(params)
        rows_plain = [tree_map(lambda p: p.detach(), r) for r in leaves[0]]
        emb_plain = tree_map(lambda p: p.detach(), params["embedding"])
        inputs = {}
        ce_sum, tok_sum = (torch.zeros((), dtype=torch.float32, device=dev)
                           for _ in range(2))
        aux_sum = torch.zeros(2, dtype=torch.float32, device=dev)
        act = None
        with torch.no_grad():
            for t in range(T):
                m, v, valid = _decode_item(t - k, M, S, V)
                out = None
                if valid:
                    x = stage.embed(emb_plain, batch["tokens"], m) \
                        if (k == 0 and v == 0) else act
                    if grads:
                        # the tick's checkpoint: its input (stage 0's
                        # chunk 0 recomputes its embedding instead)
                        inputs[t] = None if (k == 0 and v == 0) else x
                    if self._sends_fwd(t, k) or not grads:
                        out, aux = stage.chunk(x, rows_plain, v, m)
                        if not grads:
                            if aux is not None:
                                aux_sum += aux
                            if k == S - 1 and v == V - 1:
                                ce, tok = stage.head_ce(
                                    out, params["transformer"]["final_norm"],
                                    leaves[3].detach(), batch, m)
                                ce_sum += ce
                                tok_sum += tok
                sends = [(out, 1)] if self._sends_fwd(t, k) else []
                recvs = [(like, 1)] if (t + 1 < T and self._recvs_fwd(
                    t + 1, k)) else []
                got = mappings.permute_many(sends, recvs) \
                    if (sends or recvs) else []
                act = got[0] if got else None
        acc = _Acc(params) if grads else None
        if grads:
            seed, aux_seed = _objective_seeds(stage.cfg, M, scale, tok_tot)
            cot = None
            for t in range(T - 1, -1, -1):
                m, v, valid = _decode_item(t - k, M, S, V)
                dx = None
                if valid:
                    idx = list(range(v * stage.cl, (v + 1) * stage.cl))
                    dx, ce, tok, aux = _backward(
                        stage, inputs.pop(t), m, idx, v, acc, leaves, batch,
                        seed, aux_seed, cot, k == 0 and v == 0,
                        k == S - 1 and v == V - 1)
                    if ce is not None:
                        ce_sum += ce
                        tok_sum += tok
                    if aux is not None:
                        aux_sum += aux
                # the cotangent goes back where the input came from
                sends = [(dx.to(like.dtype), -1)] \
                    if self._recvs_fwd(t, k) else []
                recvs = [(like, -1)] if (t > 0 and self._sends_fwd(
                    t - 1, k)) else []
                got = mappings.permute_many(sends, recvs) \
                    if (sends or recvs) else []
                cot = got[0] if got else None
        ce_tot, tok_g, aux_tot = _totals(ce_sum, tok_sum, aux_sum)
        loss = ce_tot / tok_g.clamp(min=1.0)
        if stage.moe:
            aux_mean = aux_tot / M
            cfg = stage.cfg
            total = (loss + cfg.moe_aux_loss_coeff * aux_mean[0]
                     + cfg.moe_z_loss_coeff * aux_mean[1])
            value = (total * scale, (loss, aux_mean))
        else:
            value = (loss * scale, loss)
        if not grads:
            return value, None
        return value, _finish(acc, "lm_head" in params)


def build_pipeline_loss_fn(model, pp_size: int, num_microbatches: int, *,
                           num_virtual: int = 1,
                           sequence_parallel: bool = False):
    """The stream schedule's ``loss_fn(params, batch, rng_key, scale,
    train) -> (scaled_loss, loss)`` over this stage's params (its rows of
    the stage-major stack when ``num_virtual`` > 1), with
    ``loss_fn.value_and_grad`` for the grads (``_StreamLoss``).
    ``batch``: tokens, labels and loss_mask [M, mb, s] on the model's
    device.  Every tick's input is kept for the reverse sweep."""
    return _StreamLoss(model, pp_size, num_microbatches, num_virtual or 1,
                       sequence_parallel)


# ---------------------------------------------------------------------------
# Engine 2: 1F1B with a stash of 2S inputs (V 1)
# ---------------------------------------------------------------------------

class _OneFOneB:
    """``grad_fn(params, batch, rng_key, scale=1.0, train=True) -> (loss,
    grads)`` (a mixture of experts: ``(loss, grads, aux)``), the grads of
    ``scale`` times the objective, fp32, shaped like this stage's
    params."""

    def __init__(self, model, S, M, sequence_parallel):
        self.model, self.S, self.M = model, S, M
        self.sequence_parallel = sequence_parallel
        # the bytes the stash and the received activations hold at each
        # tick's end (what stays live between ticks: flat in M)
        self.tick_bytes = []

    def __call__(self, params, batch, rng_key=None, scale=1.0,
                 train: bool = True):
        from megatron_llm_torch.parallel import mappings

        S, M = self.S, self.M
        stage = _Stage(self.model, S, M, 1, self.sequence_parallel)
        stage.keys(rng_key, train)
        k = stage.k
        R, T = 2 * S, M + 2 * S - 1
        like = stage.act_like(batch)
        dev = like.device
        tok_tot = _token_total(batch)
        seed, aux_seed = _objective_seeds(stage.cfg, M, scale, tok_tot)
        leaves = _grad_leaves(params)
        rows_plain = [tree_map(lambda p: p.detach(), r) for r in leaves[0]]
        emb_plain = tree_map(lambda p: p.detach(), params["embedding"])
        acc = _Acc(params)
        idx = list(range(stage.cl))
        stash = {}
        ce_sum, tok_sum = (torch.zeros((), dtype=torch.float32, device=dev)
                           for _ in range(2))
        aux_sum = torch.zeros(2, dtype=torch.float32, device=dev)
        act_f = cot = None
        self.tick_bytes = []

        def fwd_valid(t, kk):
            return 0 <= t - kk < M

        def bwd_valid(t, kk):
            return 0 <= t - (2 * S - 1 - kk) < M

        for t in range(T):
            # -- the forward chunk: micro batch t - k -----------------------
            out = None
            if fwd_valid(t, k):
                f = t - k
                if k > 0:
                    stash[f % R] = act_f
                if k < S - 1:
                    with torch.no_grad():
                        x = stage.embed(emb_plain, batch["tokens"], f) \
                            if k == 0 else act_f
                        out, _ = stage.chunk(x, rows_plain, 0, f)
            # -- the backward chunk: micro batch t - (2S - 1 - k) -----------
            dx = None
            if bwd_valid(t, k):
                b = t - (2 * S - 1 - k)
                x = stash.pop(b % R) if k > 0 else None
                dx, ce, tok, aux = _backward(
                    stage, x, b, idx, 0, acc, leaves, batch, seed, aux_seed,
                    cot, k == 0, k == S - 1)
                if ce is not None:
                    ce_sum += ce
                    tok_sum += tok
                if aux is not None:
                    aux_sum += aux
            sends, recvs = [], []
            if out is not None:
                sends.append((out, 1))
            if dx is not None:
                sends.append((dx.to(like.dtype), -1))
            want_f = k > 0 and fwd_valid(t + 1, k)
            want_b = k < S - 1 and bwd_valid(t + 1, k)
            if want_f:
                recvs.append((like, 1))
            if want_b:
                recvs.append((like, -1))
            got = mappings.permute_many(sends, recvs) \
                if (sends or recvs) else []
            act_f = got.pop(0) if want_f else None
            cot = got.pop(0) if want_b else None
            self.tick_bytes.append(sum(
                x.numel() * x.element_size() for x in
                list(stash.values()) + [act_f, cot] if x is not None))
        ce_tot, tok_g, aux_tot = _totals(ce_sum, tok_sum, aux_sum)
        loss = ce_tot / tok_g.clamp(min=1.0)
        grads = _finish(acc, "lm_head" in params)
        if stage.moe:
            return loss, grads, aux_tot / M
        return loss, grads


def build_pipeline_grad_fn(model, pp_size: int, num_microbatches: int, *,
                           sequence_parallel: bool = False):
    """The 1F1B schedule's ``grad_fn(params, batch, rng_key, scale,
    train) -> (loss, grads)`` (``_OneFOneB``): the grads of ``scale``
    times the objective, fp32, those of the replicated leaves summed
    over the pp group, with the stash of 2S inputs the reference's 1F1B
    keeps in flight (schedules.py:606-722)."""
    return _OneFOneB(model, pp_size, num_microbatches, sequence_parallel)


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------

def build_pipeline_train_step(model, optimizer, parallel_cfg,
                              num_microbatches: int, *,
                              layer_stats: bool = False, plan=None,
                              log_num_zeros_in_grad: bool = False):
    """The pipelined ``train_step(params, opt_state, batch, rng_key, lr,
    wd) -> (params, opt_state, metrics)``: the whole global batch through
    the pipeline, then ``MegatronOptimizer.step``, with the metrics of
    ``training.build_train_step`` (``lm loss``, ``grad_norm``,
    ``loss_scale``, ``skipped_iter``, ``layer_stats``, ``num zeros``,
    ``moe aux loss`` and ``moe z loss``).  The schedule is 1F1B at vpp 1
    and stream above it (``train_step.schedule``).  The step finishes the grads over the
    tp group and sums them over dp with ``plan`` (a
    ``TensorParallelPlan``; one is built from the params when not
    given), whose norm, inf check and layer stats count each element
    once over pp x tp x dp.  ``batch`` is this rank's rows of the global
    batch, [M, mb, s] a key, on the model's device."""
    from megatron_llm_torch.parallel.sharding import plan_for

    pp = parallel_cfg.pipeline_model_parallel_size
    vpp = parallel_cfg.virtual_pipeline_model_parallel_size or 1
    schedule = "1f1b" if vpp == 1 else "stream"
    if (parallel_cfg.tensor_model_parallel_size,
            parallel_cfg.data_parallel_size, pp) != (
            topology.get_tensor_model_parallel_world_size(),
            topology.get_data_parallel_world_size(),
            topology.get_pipeline_model_parallel_world_size()):
        raise ValueError("the parallel config's tp x dp x pp is not the "
                         "topology's: initialize_model_parallel first")
    cfg = model.cfg
    from megatron_llm_torch.training import default_loss_func, refuse_at_dp

    refuse_at_dp(cfg, default_loss_func)
    refuse_at_pp(model)
    sp = parallel_cfg.sequence_parallel
    moe_on = cfg.num_experts > 1
    if schedule == "1f1b":
        engine = build_pipeline_grad_fn(model, pp, num_microbatches,
                                        sequence_parallel=sp)
    else:
        engine = build_pipeline_loss_fn(model, pp, num_microbatches,
                                        num_virtual=vpp,
                                        sequence_parallel=sp)
    plans = {"plan": plan} if plan is not None else {}

    def train_step(params, opt_state, batch, rng_key, lr, wd):
        scale = opt_state.grad_scaler.scale
        aux = None
        if schedule == "1f1b":
            out = engine(params, batch, rng_key, scale)
            loss, grad_tree = out[0], out[1]
            if moe_on:
                aux = out[2]
        else:
            (_, lfaux), grad_tree = engine.value_and_grad(
                params, batch, rng_key, scale)
            loss, aux = lfaux if moe_on else (lfaux, None)
        if "plan" not in plans:
            plans["plan"] = plan_for(params, cfg, sp,
                                     parallel_cfg.use_distributed_optimizer)
        p = plans["plan"]
        named = list(zip([q for q, _ in tree_leaves_with_path(params)],
                         tree_leaves(grad_tree)))
        p.finish_grads(named)
        grads = [g for _, g in p.reduce_grads(named)]
        del named
        grad_tree = tree_unflatten(params, grads)
        num_zeros = None
        if log_num_zeros_in_grad:
            num_zeros = p.global_sum(tree_leaves_with_path(grad_tree),
                                     lambda t: (t == 0.0).sum(), p.zero1)
        del grads
        params, opt_state, stats = optimizer.step(
            params, grad_tree, opt_state, lr, wd, layer_stats=layer_stats,
            plan=p)
        metrics = {
            "lm loss": loss,
            "grad_norm": stats["grad_norm"],
            "loss_scale": stats["loss_scale"],
            "skipped_iter": int(stats["found_inf"]),
        }
        if layer_stats:
            metrics["layer_stats"] = stats["layer_stats"]
        if num_zeros is not None:
            metrics["num zeros"] = num_zeros
        if moe_on:
            metrics["moe aux loss"] = aux[0]
            if cfg.moe_z_loss_coeff > 0.0:
                metrics["moe z loss"] = aux[1]
        return params, opt_state, metrics

    train_step.schedule = schedule
    return train_step
