"""Tensor-, data- and pipeline-parallel worlds of the port on the CPU,
for the ``test_torch_tp_*.py``, ``test_torch_dp.py`` and
``test_torch_pp*.py`` files: ``run_world`` starts one process a rank
(``subprocess``), joined by a gloo process group over a ``file://``
store in the test's temporary directory (never a fixed port, so files
running side by side do not meet), runs one task in every rank and
reads back each rank's results.  A world runs every case of its task,
and parametrised tests read its results, so a file starts few worlds.

No process waits forever: ``init_process_group`` has a timeout of at most
120 s, the parent kills the whole world at its own timeout, and every
rank runs on one thread.  This module imports no jax: the parent test
computes the JAX package's side and hands the inputs over as numpy.

    python tests/_torch_tp_world.py TASK RANK WORLD STORE IN.pkl OUT_DIR
"""

from __future__ import annotations

import datetime
import os
import pickle
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
INIT_TIMEOUT_SECS = 120


# ---------------------------------------------------------------------------
# the parent's side
# ---------------------------------------------------------------------------

def run_world(tmp_path, task: str, world: int, payload: dict,
              timeout: float = 300.0) -> list:
    """Run ``task`` in a world of ``world`` gloo ranks over ``payload``;
    returns each rank's result, in rank order.  Raises with the ranks'
    output when one fails, and kills the world at ``timeout``."""
    tmp = str(tmp_path)
    inp = os.path.join(tmp, f"{task}_in.pkl")
    out = os.path.join(tmp, f"{task}_out")
    os.makedirs(out, exist_ok=True)
    store = os.path.join(tmp, f"{task}_store")
    if os.path.exists(store):
        os.unlink(store)
    with open(inp, "wb") as f:
        pickle.dump(payload, f)
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1",
               CUDA_VISIBLE_DEVICES="")
    logs = [open(os.path.join(out, f"rank{r}.log"), "w+")
            for r in range(world)]
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), task, str(r),
         str(world), store, inp, out], cwd=REPO, env=env,
        stdout=logs[r], stderr=subprocess.STDOUT) for r in range(world)]
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            p.wait(timeout=max(deadline - time.monotonic(), 0.1))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    text = []
    for r, f in enumerate(logs):
        f.seek(0)
        text.append(f"--- rank {r} (exit {procs[r].returncode}) ---\n"
                    + f.read()[-6000:])
        f.close()
    if any(p.returncode != 0 for p in procs):
        raise RuntimeError(f"the {task} world failed:\n" + "\n".join(text))
    results = []
    for r in range(world):
        with open(os.path.join(out, f"rank{r}.pkl"), "rb") as f:
            results.append(pickle.load(f))
    return results


# ---------------------------------------------------------------------------
# the ranks' side
# ---------------------------------------------------------------------------

def _np(t):
    return t.detach().float().numpy().copy()


def task_ops(rank, world, payload):
    """The seven mappings (forward and input grads under each rank's
    cotangent), the vocab-parallel cross entropy (loss and logit grads,
    with and without label smoothing) and max indices, dropout masks,
    and the topology's layout."""
    import torch

    from megatron_llm_torch import random as mrandom
    from megatron_llm_torch import topology
    from megatron_llm_torch.ops import cross_entropy as ce
    from megatron_llm_torch.parallel import mappings as mp

    out = {}
    fns = {
        "copy": mp.copy_to_tensor_model_parallel_region,
        "reduce": mp.reduce_from_tensor_model_parallel_region,
        "scatter": mp.scatter_to_tensor_model_parallel_region,
        "gather": mp.gather_from_tensor_model_parallel_region,
        "sp_scatter": mp.scatter_to_sequence_parallel_region,
        "sp_gather": mp.gather_from_sequence_parallel_region,
        "sp_reduce_scatter": mp.reduce_scatter_to_sequence_parallel_region,
    }
    for name, fn in fns.items():
        x = torch.from_numpy(payload["mappings"][name]["x"][rank]).clone()
        w = torch.from_numpy(payload["mappings"][name]["w"][rank])
        x.requires_grad_(True)
        y = fn(x)
        y.backward(w)
        out[f"map_{name}"] = (_np(y), _np(x.grad))

    c = payload["ce"]
    vl = c["logits"].shape[-1] // world
    for smooth in (0.0, 0.1):
        local = torch.from_numpy(
            c["logits"][..., rank * vl:(rank + 1) * vl]).clone()
        local.requires_grad_(True)
        loss = ce.vocab_parallel_cross_entropy(
            local, torch.from_numpy(c["labels"]), smooth)
        loss.backward(torch.from_numpy(c["w"]))
        out[f"ce_{smooth}"] = (_np(loss), _np(local.grad))
    ties = torch.from_numpy(c["ties"][..., rank * vl:(rank + 1) * vl])
    out["max_indices"] = ce.vocab_parallel_max_indices(
        torch.from_numpy(c["logits"][..., rank * vl:(rank + 1) * vl])
    ).numpy()
    out["max_indices_ties"] = ce.vocab_parallel_max_indices(ties).numpy()

    d = payload["dropout"]
    full = tuple(d["shape"])
    n = full[1] // world
    out["mask_seq"] = mrandom.bernoulli(
        d["key"], d["p"], full, "cpu", local=(1, rank * n, n)).numpy()

    # the layout: tp 2 in a world of 4 (dp 2), then tp 3 (refused), then
    # the world's own tp back
    grid = topology.initialize_model_parallel(2)
    red = mp.collective("all_reduce", torch.tensor([float(rank)]))
    out["layout_tp2"] = dict(
        grid=grid.tolist(),
        tp=topology.get_tensor_model_parallel_world_size(),
        dp=topology.get_data_parallel_world_size(),
        tp_rank=topology.get_tensor_model_parallel_rank(),
        dp_rank=topology.get_data_parallel_rank(),
        tp_sum=float(red[0]))
    try:
        topology.initialize_model_parallel(3)
        out["layout_tp3"] = "accepted"
    except RuntimeError as exc:
        out["layout_tp3"] = f"RuntimeError: {exc}"
    # the start-up of a run: the world's dp, the vocab padded to 128 x tp
    from megatron_llm_torch.initialize import initialize_megatron

    args, _ = initialize_megatron(args_list=[
        "--vocab_size=1000", f"--tensor_model_parallel_size={world}",
        "--num_layers=2", "--hidden_size=64", "--num_attention_heads=4",
        "--seq_length=8", "--device=cpu"])
    out["initialize"] = dict(
        padded_vocab_size=args.padded_vocab_size, world=args.world_size,
        dp=args.data_parallel_size, rank=args.rank, device=args.device,
        tp=topology.get_tensor_model_parallel_world_size())

    # at the world's tp: a non-finite grad on rank 1 alone skips the step
    # on every rank (the inf check's consensus)
    from megatron_llm_torch.parallel.sharding import TensorParallelPlan

    model = _family_model("llama", False)
    plan = TensorParallelPlan(model.init(0), model.cfg, False)
    out["all_finite"] = float(plan.all_finite(
        torch.tensor(0.0 if rank == 1 else 1.0)))
    return out


def _family_model(name, sp, **over):
    from megatron_llm_torch import models as m

    fns = {"llama": (m.LlamaModel, m.llama_config),
           "gpt2": (m.GPTModel, m.gpt2_config),
           "falcon": (m.FalconModel, m.falcon_config),
           "mistral": (m.MistralModel, m.mistral_config),
           "qwen2": (m.Qwen2Model, m.qwen2_config),
           "gemma": (m.GemmaModel, m.gemma_config),
           "gpt_neox": (m.GPTNeoXModel, m.gpt_neox_config)}
    model_cls, cfg_fn = fns[name]
    cfg = cfg_fn("tiny", seq_length=32, max_position_embeddings=32,
                 sequence_parallel=sp, **over)
    return model_cls(cfg, device="cpu")


def task_families(rank, world, payload):
    """Each family's per-token loss from the JAX package's params, cut
    to this rank; with ``grads`` the full grads of the mean loss (the
    step's finish over the tp group, then the gather); with ``dropout``
    the loss of a training forward under a fixed dropout key."""
    import torch

    from megatron_llm_torch.parallel import sharding
    from megatron_llm_torch.tree import tree_leaves_with_path, tree_map
    from megatron_llm_torch.weights import params_from_jax

    sp = payload["sequence_parallel"]
    out = {}
    for name, case in payload["families"].items():
        model = _family_model(name, sp)
        params = params_from_jax(case["params"], model.cfg, device="cpu",
                                 tp_rank=rank, tp_size=world)
        tokens = torch.from_numpy(case["tokens"]).long()
        labels = torch.from_numpy(case["labels"]).long()
        with torch.no_grad():
            out[name] = _np(model(params, tokens, labels=labels))
        if name in payload.get("grads", ()):
            leaves = [p.requires_grad_(True) for _, p in
                      tree_leaves_with_path(params)]
            loss = model(params, tokens, labels=labels).mean()
            gs = torch.autograd.grad(loss, leaves)
            named = [(path, g.float()) for (path, _), g in
                     zip(tree_leaves_with_path(params), gs)]
            plan = sharding.TensorParallelPlan(params, model.cfg, sp)
            plan.finish_grads(named)
            grads = {}
            for (path, _), (_, g) in zip(tree_leaves_with_path(params),
                                         named):
                node = grads
                for k in path[:-1]:
                    node = node.setdefault(k, {})
                node[path[-1]] = g
            full = sharding.gather_params(
                grads, sharding.language_model_param_specs(params),
                model.cfg)
            out[f"{name}_grads"] = tree_map(_np, full)
            out[f"{name}_local_grads"] = tree_map(_np, grads)
    for name, case in payload.get("dropout", {}).items():
        model = _family_model(name, sp, **case["over"])
        params = params_from_jax(case["params"], model.cfg, device="cpu",
                                 tp_rank=rank, tp_size=world)
        with torch.no_grad():
            out[f"{name}_dropout"] = _np(model(
                params, torch.from_numpy(case["tokens"]).long(),
                labels=torch.from_numpy(case["labels"]).long(),
                train=True, rng_key=case["key"]))
    return out


def task_finetune(rank, world, payload):
    """``finetune.main(argv)`` (or the ``entry`` module's ``main``) in
    this rank, with every logged iteration's exact loss, grad norm and
    learning rate."""
    import contextlib
    import importlib
    import io

    from megatron_llm_torch import training

    entry = importlib.import_module(
        f"megatron_llm_torch.{payload.get('entry', 'finetune')}")

    seen = {}
    log0 = training.training_log

    def log_line(iteration, train_iters, metrics, elapsed, tokens, lr,
                 *a, **kw):
        seen[iteration] = dict(loss=float(metrics["lm loss"]),
                               grad_norm=float(metrics["grad_norm"]),
                               lr=float(lr))
        return log0(iteration, train_iters, metrics, elapsed, tokens, lr,
                    *a, **kw)

    training.training_log = log_line
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            it = entry.main(payload["argv"])
    finally:
        training.training_log = log0
    return dict(iteration=it, logged=seen, stdout=buf.getvalue())


def _np_tree(tree) -> dict:
    """{keystr: (fp32 numpy, dtype name)} of a tree (bf16 and fp16 widen
    to fp32 exactly, so equal arrays mean equal bits)."""
    from megatron_llm_torch.checkpointing import _flat, dtype_name

    return {k: (v.detach().float().numpy().copy(), dtype_name(v))
            for k, v in _flat(tree).items()}


def _rows(batch, dp_rank, dp):
    """This dp rank's rows of a numpy global batch, as tensors."""
    import numpy as np
    import torch

    from megatron_llm_torch.data.data_samplers import dp_rows

    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in dp_rows(batch, dp_rank, dp).items()}


def _stage_params(case, model):
    """This rank's params from the case's JAX params: its tp slices, and
    at pp > 1 its stage's rows (stage-major under vpp)."""
    from megatron_llm_torch import topology
    from megatron_llm_torch.parallel.pipeline import stage_rows
    from megatron_llm_torch.tree import tree_map
    from megatron_llm_torch.weights import params_from_jax

    params = params_from_jax(
        case["params"], model.cfg, dtype=model.cfg.params_torch_dtype,
        device="cpu", tp_rank=topology.get_tensor_model_parallel_rank(),
        tp_size=topology.get_tensor_model_parallel_world_size())
    params = stage_rows(
        params, topology.get_pipeline_model_parallel_rank(),
        topology.get_pipeline_model_parallel_world_size(),
        topology.get_virtual_pipeline_model_parallel_world_size(),
        model.cfg.num_layers)
    # own storage: the cases share the payload's arrays, which from_numpy
    # would hand to the in-place optimizer
    return tree_map(lambda t: t.clone(), params)


def _setup(case, world):
    """The topology at the case's tp and pp (and vpp; dp the rest of the
    world), its model, this rank's params (from the JAX package's, or the
    seed's init), optimizer, parallel config and plan."""
    import torch

    from megatron_llm_torch import topology
    from megatron_llm_torch.config import ParallelConfig, TrainConfig
    from megatron_llm_torch.optimizer import MegatronOptimizer
    from megatron_llm_torch.parallel.sharding import plan_for

    tp, pp, vpp = case["tp"], case.get("pp", 1), case.get("vpp")
    topology.initialize_model_parallel(tp, pp, vpp)
    sp = case.get("sp", False) and tp > 1
    model = _family_model(case["family"], sp, **case.get("over", {}))
    if "params" in case:
        params = _stage_params(case, model)
    else:
        params = model.init(case.get("seed", 0))
    tc = TrainConfig(**case["train"])
    opt = MegatronOptimizer(tc, params_dtype=model.cfg.params_torch_dtype)
    pc = ParallelConfig(tensor_model_parallel_size=tp,
                        pipeline_model_parallel_size=pp,
                        virtual_pipeline_model_parallel_size=vpp,
                        data_parallel_size=world // (tp * pp),
                        sequence_parallel=sp,
                        use_distributed_optimizer=case.get("zero1", False))
    plan = plan_for(params, model.cfg, sp, pc.use_distributed_optimizer)
    torch.manual_seed(0)
    return model, params, tc, opt, pc, plan


def _gathered(plan, params, opt_state=None):
    """Rank 0's one-device numpy trees of this rank's pieces (a
    collective), or None elsewhere."""
    from megatron_llm_torch import checkpointing

    opt_tree = (None if opt_state is None else
                checkpointing._opt_state_to_tree(opt_state))
    if plan is None:
        return (_np_tree(params),
                None if opt_tree is None else _np_tree(opt_tree))
    p_h, o_h, _ = checkpointing.gather_one_layout(plan, params, opt_tree)
    if p_h is None:
        return None
    return _np_tree(p_h), None if o_h is None else _np_tree(o_h)


def _state_bytes(opt_state) -> int:
    from megatron_llm_torch.tree import tree_leaves

    return sum(t.numel() * t.element_size()
               for tree in (opt_state.master_params, opt_state.exp_avg,
                            opt_state.exp_avg_sq) if tree is not None
               for t in tree_leaves(tree))


class _PoisonFirst:
    """A model whose first ``calls`` per-token losses are NaN (this rank's
    grads of the first step), the loss masks untouched."""

    def __init__(self, model, calls):
        self.model, self.cfg, self.calls = model, model.cfg, calls

    def __call__(self, *a, **kw):
        out = self.model(*a, **kw)
        if self.calls > 0:
            self.calls -= 1
            out = out * float("nan")
        return out


def task_dp_step(rank, world, payload):
    """Each case: ``build_train_step`` at its tp, dp the rest of the
    world, on this rank's rows of the case's global batches; the logged
    metrics of each step (the layer stats too), the state bytes, and
    rank 0's gathered params and state after the last step."""
    from megatron_llm_torch import topology
    from megatron_llm_torch.training import build_train_step

    out = {}
    for name, case in payload["cases"].items():
        model, params, tc, opt, pc, plan = _setup(case, world)
        dp = pc.data_parallel_size
        dp_rank = topology.get_data_parallel_rank()
        state = opt.init(params, plan)
        num_micro = case["batches"][0]["tokens"].shape[0]
        if case.get("nan_rank") == rank:
            model = _PoisonFirst(model, num_micro)
        step = build_train_step(model, opt, pc, num_micro,
                                log_num_zeros_in_grad=True,
                                log_layer_stats=case.get("layer_stats",
                                                         False), plan=plan)
        logs = []
        for it, batch in enumerate(case["batches"]):
            b = _rows(batch, dp_rank, dp)
            params, state, m = step(params, state, b, None, case["lrs"][it],
                                    tc.weight_decay)
            rec = {}
            for k, v in m.items():
                if k == "layer_stats":
                    rec[k] = {g: t.tolist() for g, t in v.items()}
                else:
                    rec[k] = float(v)
            logs.append(rec)
        out[name] = dict(logs=logs, state_bytes=_state_bytes(state),
                         dp_rank=dp_rank,
                         tp_rank=topology.get_tensor_model_parallel_rank(),
                         trees=_gathered(plan, params, state))
    return out


def task_ck(rank, world, payload):
    """Checkpoint operations, in order, each at its own tp (dp the rest
    of the world): ``train`` runs ``training.pretrain`` on a fixed global
    batch (with its saves), ``load`` reads a checkpoint (``plan``
    cuts it) and ``resume`` loads one and trains on; each returns rank
    0's gathered trees, and ``train`` every rank's state bytes."""
    from megatron_llm_torch import checkpointing, topology
    from megatron_llm_torch.models.language_model import (
        init_language_model_params,
    )
    from megatron_llm_torch.training import pretrain

    out = {}
    for op in payload["ops"]:
        model, params, tc, opt, pc, plan = _setup(op, world)
        dp = pc.data_parallel_size
        dp_rank = topology.get_data_parallel_rank()
        opt_state, start = None, 0
        if op["op"] in ("load", "resume"):
            tmpl = init_language_model_params(None, model.cfg, device="meta")
            params, _, meta = checkpointing.load_checkpoint(
                op["dir"], iteration=op.get("iteration"),
                params_template=tmpl, device="cpu", plan=plan)
            _, opt_state, _ = checkpointing.load_checkpoint(
                op["dir"], iteration=op.get("iteration"), load_params=False,
                opt_state_template=opt.init(tmpl), device="cpu", plan=plan)
            start = meta["iteration"]
        if op["op"] in ("train", "resume"):
            def batches():
                while True:
                    yield _rows(op["batch"], dp_rank, dp)

            params, opt_state, _ = pretrain(
                model, params, tc, pc, batches(), optimizer=opt,
                log_interval=0, save_interval=op.get("save_interval"),
                save_dir=op.get("save_dir"), start_iteration=start,
                opt_state=opt_state, async_save=op.get("async", False))
        out[op["name"]] = dict(trees=_gathered(plan, params, opt_state),
                               state_bytes=_state_bytes(opt_state))
    return out


def task_runtime(rank, world, payload):
    """The runtime's saves at the world's tp (dp the rest; a case's pp
    too): a hang on one rank fires the watchdogs, and rank 0's writes the
    rescue checkpoint from its host snapshot (every collective's and
    point-to-point step's thread is recorded); a
    SIGTERM to one rank makes every rank save and leave at the next
    boundary."""
    import threading

    from megatron_llm_torch import topology
    from megatron_llm_torch.dist_signal_handler import (
        DistributedSignalHandler,
    )
    from megatron_llm_torch.parallel import mappings
    from megatron_llm_torch.resilience import (
        FaultInjector,
        HangWatchdog,
        ResilienceConfig,
        ResilienceManager,
    )
    from megatron_llm_torch.training import pretrain

    threads = set()
    collective0 = mappings.collective
    permute0 = mappings.permute_many

    def recorded(*a, **kw):
        threads.add(threading.current_thread().name)
        return collective0(*a, **kw)

    def recorded_p2p(*a, **kw):
        threads.add(threading.current_thread().name)
        return permute0(*a, **kw)

    mappings.collective = recorded
    mappings.permute_many = recorded_p2p
    out = {}
    for op in payload["ops"]:
        model, params, tc, opt, pc, plan = _setup(op, world)
        dp = pc.data_parallel_size
        dp_rank = topology.get_data_parallel_rank()

        def batches():
            while True:
                yield _rows(op["batch"], dp_rank, dp)

        spec = op["faults"].get(rank)
        kw = {}
        handler = None
        if op["op"] == "rescue":
            fired = []
            kw["resilience"] = ResilienceManager(
                ResilienceConfig(snapshot_interval=1),
                injector=FaultInjector.from_spec(spec),
                watchdog=HangWatchdog(op["watchdog_secs"], hard_exit=False),
                rewind_enabled=True)
        else:
            handler = DistributedSignalHandler().install()
            kw["exit_signal_handler"] = handler
            kw["resilience"] = ResilienceManager(
                injector=FaultInjector.from_spec(spec),
                rewind_enabled=False)
        threads.clear()
        code = None
        try:
            pretrain(model, params, tc, pc, batches(), optimizer=opt,
                     log_interval=1, save_dir=op["save_dir"], **kw)
        except SystemExit as exc:
            code = exc.code
        finally:
            kw["resilience"].close()
            if handler is not None:
                handler.__exit__(None, None, None)
        wd = kw["resilience"].watchdog
        out[op["name"]] = dict(exit=code, threads=sorted(threads),
                               fired=None if wd is None else wd.fired)
    mappings.collective = collective0
    mappings.permute_many = permute0
    return out


def _full_grads(grads, cfg, plan):
    """This rank's grads finished over its tp group (the train step's
    ``finish_grads``) and gathered over it (collectives over tp), as
    numpy: the stage's rows of every layer-stack leaf, whole."""
    from megatron_llm_torch import topology
    from megatron_llm_torch.parallel import sharding
    from megatron_llm_torch.tree import tree_leaves_with_path, tree_map

    if topology.get_tensor_model_parallel_world_size() > 1:
        plan.finish_grads(tree_leaves_with_path(grads))
        grads = sharding.gather_params(
            grads, sharding.language_model_param_specs(grads), cfg)
    return tree_map(_np, grads)


def task_pp(rank, world, payload):
    """Each case at its tp x pp (x vpp; dp the rest of the world), from the
    JAX package's params cut to this rank:

    * ``grad``: a pipeline engine's loss and grads (1F1B's
      ``build_pipeline_grad_fn``, or the stream schedule's
      ``value_and_grad``; ``key`` a dropout key, ``train_mode`` on), the
      grads gathered over tp;
    * ``step``: ``build_pipeline_train_step``'s steps on this rank's rows
      of the global batches, and rank 0's gathered trees after them;
    * ``rotate``: ``mappings.permute`` of the stage's index one stage on
      and one stage back;
    * ``memory``: the 1F1B engine at each of ``micro`` micro-batch
      counts: the largest bytes its stash and its received activations
      hold at a tick boundary, and the largest bytes of tensors saved
      for backward alive at once over the call."""
    import weakref

    import torch

    from megatron_llm_torch import topology
    from megatron_llm_torch.parallel import mappings
    from megatron_llm_torch.parallel.pipeline import (
        build_pipeline_grad_fn,
        build_pipeline_loss_fn,
        build_pipeline_train_step,
    )

    out = {}
    for name, case in payload["cases"].items():
        model, params, tc, opt, pc, plan = _setup(case, world)
        cfg = model.cfg
        pp, vpp = pc.pipeline_model_parallel_size, \
            pc.virtual_pipeline_model_parallel_size or 1
        dp = pc.data_parallel_size
        dp_rank = topology.get_data_parallel_rank()
        who = dict(pp_rank=topology.get_pipeline_model_parallel_rank(),
                   tp_rank=topology.get_tensor_model_parallel_rank(),
                   dp_rank=dp_rank)
        mappings.calls.clear()
        if case["kind"] == "grad":
            batch = _rows(case["batch"], dp_rank, dp)
            M = batch["tokens"].shape[0]
            if case["engine"] == "1f1b":
                res = build_pipeline_grad_fn(
                    model, pp, M, sequence_parallel=pc.sequence_parallel)(
                    params, batch, case.get("key"), 1.0,
                    case.get("train_mode", False))
                loss, grads = res[0], res[1]
                aux = res[2] if len(res) > 2 else None
            else:
                fn = build_pipeline_loss_fn(
                    model, pp, M, num_virtual=vpp,
                    sequence_parallel=pc.sequence_parallel)
                (_, lfaux), grads = fn.value_and_grad(
                    params, batch, case.get("key"), 1.0,
                    case.get("train_mode", False))
                loss, aux = lfaux if cfg.num_experts > 1 else (lfaux, None)
            out[name] = dict(
                who, loss=float(loss),
                aux=None if aux is None else _np(aux),
                grads=_full_grads(grads, cfg, plan),
                permutes={"/".join(k): n for k, n in mappings.calls.items()
                          if k[2] == "permute"})
        elif case["kind"] == "rotate":
            # lax.ppermute's rotations over the pp group
            x = torch.full((2, 3), float(who["pp_rank"]))
            out[name] = dict(who, fwd=_np(mappings.permute(x, 1)),
                             bwd=_np(mappings.permute(x, -1)))
        elif case["kind"] == "step":
            state = opt.init(params, plan)
            step = build_pipeline_train_step(
                model, opt, pc, case["batches"][0]["tokens"].shape[0],
                plan=plan, log_num_zeros_in_grad=True)
            logs = []
            for it, b in enumerate(case["batches"]):
                params, state, m = step(params, state,
                                        _rows(b, dp_rank, dp), None,
                                        case["lrs"][it], tc.weight_decay)
                logs.append({k: float(v) for k, v in m.items()})
            out[name] = dict(who, logs=logs, state_bytes=_state_bytes(state),
                             trees=_gathered(plan, params, state))
        else:
            res = {}
            for M in case["micro"]:
                batch = _rows(dict((k, v[:M]) for k, v in
                                   case["batch"].items()), dp_rank, dp)
                live = {"now": 0, "peak": 0}

                def pack(t):
                    n = t.numel() * t.element_size()
                    live["now"] += n
                    live["peak"] = max(live["peak"], live["now"])
                    box = [t]

                    def gone(n=n):
                        live["now"] -= n

                    holder = _Saved(box)
                    weakref.finalize(holder, gone)
                    return holder

                engine = build_pipeline_grad_fn(model, pp, M)
                with torch.autograd.graph.saved_tensors_hooks(
                        pack, lambda h: h.box[0]):
                    engine(params, batch, None, 1.0, False)
                res[M] = dict(tick_bytes=max(engine.tick_bytes),
                              saved_peak=live["peak"])
            out[name] = dict(who, memory=res)
    return out


class _Saved:
    """A tensor saved for backward, held while autograd holds this."""

    def __init__(self, box):
        self.box = box


TASKS = {"ops": task_ops, "families": task_families,
         "finetune": task_finetune, "dp_step": task_dp_step,
         "ck": task_ck, "runtime": task_runtime, "pp": task_pp}


def main(argv) -> int:
    task, rank, world, store, inp, out = argv
    rank, world = int(rank), int(world)
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method=f"file://{store}", rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=INIT_TIMEOUT_SECS))
    from megatron_llm_torch import topology

    with open(inp, "rb") as f:
        payload = pickle.load(f)
    topology.initialize_model_parallel(payload.get("tp", world),
                                       payload.get("pp", 1))
    result = TASKS[task](rank, world, payload)
    with open(os.path.join(out, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(result, f)
    dist.barrier()
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
