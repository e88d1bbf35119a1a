"""Tensor-parallel worlds of the port on the CPU, for the
``test_torch_tp_*.py`` files: ``run_world`` starts one process a rank
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
    """``finetune.main(argv)`` in this rank, with every logged
    iteration's exact loss, grad norm and learning rate."""
    import contextlib
    import io

    from megatron_llm_torch import finetune, training

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
            it = finetune.main(payload["argv"])
    finally:
        training.training_log = log0
    return dict(iteration=it, logged=seen, stdout=buf.getvalue())


TASKS = {"ops": task_ops, "families": task_families,
         "finetune": task_finetune}


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

    topology.initialize_model_parallel(world)
    with open(inp, "rb") as f:
        payload = pickle.load(f)
    result = TASKS[task](rank, world, payload)
    with open(os.path.join(out, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(result, f)
    dist.barrier()
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
