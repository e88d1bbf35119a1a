"""Checkpoint save/load in the JAX package's layout (the counterpart of
``megatron_llm_tpu/checkpointing.py``).

Reference: ``megatron/checkpointing.py`` — ``latest_checkpointed_iteration.txt``
(:170-174); saved payload is {args, checkpoint_version, iteration, model
state, optimizer state} (:243-337); ``--finetune`` resets
iteration/optim (:482-567); ``--use_checkpoint_args`` re-hydrates model
hyperparams.

The directory layout and ``meta.json`` are the JAX package's::

    <save>/iter_0000100/model/       (params)
    <save>/iter_0000100/optim/       (optimizer state)
    <save>/iter_0000100/meta.json    (iteration, args, scheduler,
                                      consumed_samples, checkpoint_version,
                                      the manifest and its sha256)
    <save>/latest_checkpointed_iteration.txt

with the same hardening: each save is written into ``iter_N.tmp`` and
renamed into place, retried with exponential backoff, checked against a
per-leaf manifest (shape and dtype, keyed by the ``jax.tree_util.keystr``
of the leaf's path, so the two packages' manifests of one model compare
key for key) whose sha256 is in ``meta.json``; a corrupt tracker or a
tracked checkpoint that fails validation falls back to the newest valid
``iter_*`` directory, and ``--save_total_limit`` keeps the newest N.

The leaf payload is the port's own (the JAX package writes orbax /
tensorstore trees, which need JAX): ``model/`` and ``optim/`` each hold
one ``tree.pt``, a ``torch.save`` of a flat ``{keystr: tensor}`` dict,
read back with ``weights_only=True``.  bf16 survives as bf16.  The
optimizer state's scalars (step, loss scale, scaler trackers) are stored
as 0-dim int32 / float32 tensors, the JAX package's dtypes.  One
writer: at tp x dp above 1 every rank gathers each leaf, one at a time,
over tp and (the ZeRO-1 state) over dp (the step's ``TensorParallelPlan``
``gather_leaf``) into rank 0's host memory, and rank 0 writes the one
layout, with the keys, shapes, dtypes, manifest and tracker of a tp-1
save, while the other ranks wait at a barrier with a timeout.  A load
reads the one layout on every rank and cuts each leaf with the plan's
``shard_leaf`` (its tp slice, and its ZeRO-1 dp slice), so a checkpoint
saved at any tp x dp loads at any other, and into the tp-1 server.
At pp > 1 the plan also gathers a layer-stack leaf's rows over the pp
group and puts them back in natural order (the stages hold them
stage-major under the interleaved pipeline), and a load permutes the
natural stack and cuts the stage's rows before its tp and dp slices:
the layout is still the one a tp-1 run writes.  Rank 0 holds the whole
tree in host memory while it writes (ROADMAP item 5).

``async_save`` copies every leaf into host buffers (allocated once and
reused, pinned when the leaf is on the card) and waits for the copies
before it returns, so the in-place optimizer may update the live tensors
at once; a background thread then writes the payload and ``meta.json``
(the manifest and its sha256) into ``iter_N.tmp``.  The rename and the
tracker wait for ``finalize_async_saves()``, which the next save and
every exit path of the train loop and of ``finetune.main`` call; a
failed background write raises there and is never retried as a
synchronous save.  At tp x dp x pp the gather into rank 0's host
buffers runs before the writer thread starts, so the thread, and the
retries of a failed write, issue no collective.  The resilience runtime's save fault hook
(``resilience.set_save_fault_hook``) is consulted on every attempt of
the retry loop, and every retry counts in the global
``counters['save_retries']`` (``global_vars.get_counters``).
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import re
import shutil
import threading
import time
from pathlib import Path
from typing import Any, Optional, Tuple

import torch

from megatron_llm_torch import topology, tracing
from megatron_llm_torch.global_vars import get_counters
from megatron_llm_torch.optimizer.grad_scaler import GradScalerState
from megatron_llm_torch.optimizer.optimizer import OptimizerState
from megatron_llm_torch.tree import tree_leaves_with_path

CHECKPOINT_VERSION = 4.0  # the JAX package's layout version
PAYLOAD = "tree.pt"       # the one file in model/ and optim/

# Hardened-IO knobs (wired from the CLI via configure_save).  total_limit=0
# keeps every checkpoint; retries>0 re-attempts a failed save with
# exponential backoff; every retry increments counters['save_retries'].
_SAVE_CONFIG = {"total_limit": 0, "retries": 2, "retry_backoff": 0.25,
                "barrier_secs": 1800.0}


def configure_save(total_limit: Optional[int] = None,
                   retries: Optional[int] = None,
                   retry_backoff: Optional[float] = None) -> None:
    if total_limit is not None:
        _SAVE_CONFIG["total_limit"] = int(total_limit)
    if retries is not None:
        _SAVE_CONFIG["retries"] = int(retries)
    if retry_backoff is not None:
        _SAVE_CONFIG["retry_backoff"] = float(retry_backoff)


def _fault_hook_check() -> None:
    """Chaos hook: resilience.FaultInjector (when active) raises a
    transient IOError here to exercise the retry path."""
    from megatron_llm_torch.resilience import get_save_fault_hook

    hook = get_save_fault_hook()
    if hook is not None:
        hook()


def get_checkpoint_name(save_dir: str, iteration: int,
                        release: bool = False) -> str:
    # reference: checkpointing.py:77-106
    if release:
        return os.path.join(save_dir, "release")
    return os.path.join(save_dir, f"iter_{iteration:07d}")


def get_checkpoint_tracker_filename(save_dir: str) -> str:
    # reference: checkpointing.py:170-174
    return os.path.join(save_dir, "latest_checkpointed_iteration.txt")


def config_to_args(cfg) -> dict:
    """JSON-safe dict of a (dataclass) model config, for meta.json 'args'.
    Enums and other rich values degrade to strings; the consumers
    (``--use_checkpoint_args``, model rebuild on import) read plain
    fields."""
    def safe(v):
        if isinstance(v, (bool, int, float, str)) or v is None:
            return v
        if isinstance(v, (list, tuple)):
            return [safe(x) for x in v]
        name = getattr(v, "name", None)     # Enum -> member name
        return name.lower() if isinstance(name, str) else str(v)

    if dataclasses.is_dataclass(cfg):
        return {k: safe(v) for k, v in dataclasses.asdict(cfg).items()}
    if isinstance(cfg, dict):
        return {k: safe(v) for k, v in cfg.items()}
    return {}


# -- leaves, keys and the integrity manifest --------------------------------

def keystr(path) -> str:
    """``jax.tree_util.keystr`` of a path of dict keys:
    ``['transformer']['layers']['mlp']``."""
    return "".join(f"[{k!r}]" for k in path)


def dtype_name(t: torch.Tensor) -> str:
    """numpy's name of a tensor's dtype ("float32", "bfloat16", "int32"),
    as the JAX package's manifest writes it."""
    return str(t.dtype).removeprefix("torch.")


def _flat(tree) -> dict:
    """{keystr: tensor} of a nested dict, leaves in sorted key order."""
    if tree is None:
        return {}
    return {keystr(path): leaf
            for path, leaf in tree_leaves_with_path(tree)
            if leaf is not None}


def _key_path(key: str) -> tuple:
    """The dict keys of a ``keystr``."""
    return tuple(re.findall(r"\['((?:[^'\\]|\\.)*)'\]", key))


def _unflat(flat: dict) -> dict:
    """The nested dict of a ``{keystr: tensor}`` dict."""
    out: dict = {}
    for key, leaf in flat.items():
        path = _key_path(key)
        if keystr(path) != key:
            raise ValueError(f"checkpoint key {key!r} is not a path of "
                             f"string dict keys")
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf
    return out


def _tree_manifest(tree) -> dict:
    """{leaf path: {shape, dtype}} — metadata only, no device transfer;
    written into meta.json and verified on load so that a truncated or
    mismatched payload is caught before training resumes on garbage."""
    return {key: {"shape": list(leaf.shape), "dtype": dtype_name(leaf)}
            for key, leaf in _flat(tree).items()}


def _manifest_sha256(manifest: dict) -> str:
    blob = json.dumps(manifest, sort_keys=True).encode()
    return hashlib.sha256(blob).hexdigest()


def _verify_leaves(tree, manifest_section: dict, label: str) -> None:
    """Per-leaf shape/dtype check of a restored tree against the saved
    manifest; raises on any mismatch (a wrong-shape restore must never
    silently enter the optimizer)."""
    if not manifest_section or tree is None:
        return
    for key, leaf in _flat(tree).items():
        want = manifest_section.get(key)
        if want is None:
            continue
        got_shape, got_dtype = list(leaf.shape), dtype_name(leaf)
        if got_shape != want["shape"] or got_dtype != want["dtype"]:
            raise ValueError(
                f"checkpoint leaf {label}{key} mismatches its manifest: "
                f"restored {got_shape}/{got_dtype}, saved "
                f"{want['shape']}/{want['dtype']}")


def validate_checkpoint_dir(ckpt_dir) -> Tuple[bool, str]:
    """Structural validation of one iter_* dir: model payload present,
    meta.json parseable, manifest checksum intact.  (ok, reason)."""
    ckpt_dir = Path(ckpt_dir)
    if not (ckpt_dir / "model" / PAYLOAD).exists():
        return False, (f"missing model/{PAYLOAD} payload (an orbax tree "
                       f"of the JAX package does not load here)"
                       if (ckpt_dir / "model").exists()
                       else "missing model/ payload")
    meta_path = ckpt_dir / "meta.json"
    if not meta_path.exists():
        return False, "missing meta.json"
    try:
        with open(meta_path) as f:
            meta = json.load(f)
    except (OSError, json.JSONDecodeError) as e:
        return False, f"unreadable meta.json ({e})"
    manifest, want = meta.get("manifest"), meta.get("manifest_sha256")
    if manifest is not None and want is not None:
        if _manifest_sha256(manifest) != want:
            return False, "manifest checksum mismatch"
    return True, "ok"


def _iter_checkpoint_dirs(save_dir: str):
    """(iteration, Path) for every iter_* dir, newest first."""
    out = []
    try:
        names = os.listdir(save_dir)
    except OSError:
        return out
    for name in names:
        m = re.fullmatch(r"iter_(\d+)", name)
        if m:
            out.append((int(m.group(1)), Path(save_dir) / name))
    out.sort(reverse=True)
    return out


def _scan_latest_valid(save_dir: str, exclude=None):
    """Newest iter_* dir that passes validation (fallback when the tracker
    or the tracked dir is corrupt).  (iteration, Path) or None."""
    for it, d in _iter_checkpoint_dirs(save_dir):
        if exclude is not None and d == Path(exclude):
            continue
        ok, reason = validate_checkpoint_dir(d)
        if ok:
            return it, d
        print(f" [checkpoint] skipping {d.name}: {reason}", flush=True)
    return None


def _gc_old_checkpoints(save_dir: str) -> None:
    """Keep-last-N: with --save_total_limit set, delete the oldest iter_*
    dirs past the limit (never 'release')."""
    limit = _SAVE_CONFIG["total_limit"]
    if not limit or limit <= 0:
        return
    dirs = _iter_checkpoint_dirs(save_dir)      # newest first
    for it, d in dirs[limit:]:
        print(f" [checkpoint] save_total_limit={limit}: removing "
              f"{d.name}", flush=True)
        shutil.rmtree(d, ignore_errors=True)


def _commit_checkpoint(save_dir: str, iteration: int, release: bool,
                       tmp_dir, final_dir) -> None:
    """Atomic publish: tmp dir -> final name (os.replace), then tracker,
    then GC.  A crash before the rename leaves only a *.tmp dir the
    loader never considers; a crash after it leaves a fully-valid
    checkpoint the tracker may or may not point at — the fallback scan
    finds it either way."""
    final_dir = Path(final_dir)
    if final_dir.exists():
        shutil.rmtree(final_dir)
    os.replace(tmp_dir, final_dir)
    with open(get_checkpoint_tracker_filename(save_dir), "w") as f:
        f.write("release" if release else str(iteration))
    _gc_old_checkpoints(save_dir)


def _write_tree(path: Path, tree) -> int:
    """One ``torch.save`` of the tree's flat dict; returns the bytes of
    its leaves."""
    flat = {k: v.detach() for k, v in _flat(tree).items()}
    path.mkdir(parents=True)
    torch.save(flat, path / PAYLOAD)
    return sum(v.numel() * v.element_size() for v in flat.values())


# The one asynchronous save in flight: its writer thread, the error it
# met, the commit it waits for, and the host buffers it writes from
# (reused by the next async save of the same leaves).
_ASYNC = {"thread": None, "error": None, "slot": None, "buffers": None,
          "t0": 0.0, "nbytes": 0}


def copy_to_host(live, buffers=None):
    """Copy the tensors ``live`` into host buffers and return the buffers:
    ``buffers`` when they match ``live`` in shape and dtype (a previous
    call's), else new ones, pinned for tensors on the card.  The copies
    run on a side stream ordered after the work that made ``live`` and
    are complete when this returns, so the caller may update ``live`` in
    place at once.  Each buffer is its own storage (``torch.save`` writes
    a view's whole storage)."""
    live = [t.detach() for t in live]
    if buffers is None or len(buffers) != len(live) or any(
            b.shape != t.shape or b.dtype != t.dtype
            for b, t in zip(buffers, live)):
        buffers = [torch.empty(t.shape, dtype=t.dtype,
                               pin_memory=t.device.type == "cuda")
                   for t in live]
    cuda = [t for t in live if t.device.type == "cuda"]
    if cuda:
        side = torch.cuda.Stream(device=cuda[0].device)
        side.wait_stream(torch.cuda.current_stream(cuda[0].device))
        with torch.cuda.stream(side):
            for b, t in zip(buffers, live):
                b.copy_(t, non_blocking=True)
        side.synchronize()
    else:
        for b, t in zip(buffers, live):
            b.copy_(t)
    return buffers


def _host_copy(trees):
    """The trees' leaves copied into the async host buffers (kept for the
    next save); the copies are done when this returns."""
    bufs = _ASYNC["buffers"] = copy_to_host(
        [t for tree in trees if tree is not None
         for t in _flat(tree).values()], _ASYNC["buffers"])
    it = iter(bufs)
    return [None if tree is None else
            _unflat({k: next(it) for k in _flat(tree)}) for tree in trees]


def finalize_async_saves() -> None:
    """Wait until the in-flight async save is written, THEN rename it into
    place and write its tracker — a crash mid-async-save must never leave
    the tracker pointing at an incomplete checkpoint.  A failed write
    raises here (``RuntimeError`` from the writer's error).  No-op when
    nothing is pending; the train loop calls this in a finally block so
    every exit path flushes."""
    if _ASYNC["thread"] is None and _ASYNC["slot"] is None:
        return
    with tracing.span("checkpoint_finalize", "checkpoint"):
        if _ASYNC["thread"] is not None:
            _ASYNC["thread"].join()
            _ASYNC["thread"] = None
        err, slot = _ASYNC["error"], _ASYNC["slot"]
        _ASYNC["error"] = _ASYNC["slot"] = None
        if err is not None:
            raise RuntimeError(f"asynchronous checkpoint save failed: "
                               f"{err!r}") from err
        if slot is not None:
            save_dir, iteration, release, tmp_dir, final_dir = slot
            _commit_checkpoint(save_dir, iteration, release, tmp_dir,
                               final_dir)
            print(f" [checkpoint] saved iteration {iteration} to "
                  f"{final_dir}: {_ASYNC['nbytes']} bytes in "
                  f"{time.perf_counter() - _ASYNC['t0']:.3f} s (async)",
                  flush=True)


_STATE_TREES = ("master_params", "exp_avg", "exp_avg_sq")


def _state_leaf(path) -> tuple:
    """(the param path, whether the leaf is ZeRO-1 state) of a path of
    the optimizer tree: its param-shaped trees' leaves carry the param
    path after the tree's name; the scalars carry none."""
    if path and path[0] in _STATE_TREES:
        return tuple(path[1:]), True
    return None, False


def gather_one_layout(plan, params, opt_tree=None, buffers=None,
                      pinned: bool = False):
    """The one-device trees of this rank's ``params`` and optimizer tree
    (``_opt_state_to_tree``), gathered leaf by leaf over tp and dp, and
    a layer-stack leaf's rows over pp in natural order (a collective:
    every rank calls it) into host tensors on global rank 0:
    ``(params, opt_tree, buffers)`` there, ``(None, None, buffers)``
    elsewhere.  Each leaf is copied into ``buffers[i]`` when that matches
    it (a previous call's, ``pinned`` for an async save), else into a new
    host tensor, so the caller may update the live tensors at once."""
    rank0 = topology.is_rank_0()
    bufs = list(buffers or [])
    out, i = [], 0
    for tree, is_opt in ((params, False), (opt_tree, True)):
        if tree is None:
            out.append(None)
            continue
        flat = {}
        for path, leaf in tree_leaves_with_path(tree):
            if is_opt:
                ppath, state = _state_leaf(path)
                full = (plan.gather_leaf(ppath, leaf, sliced=plan.zero1)
                        if state else leaf.detach())
            else:
                full = plan.gather_leaf(path, leaf)
            if rank0:
                if (not pinned and full.device.type == "cpu"
                        and full.untyped_storage().data_ptr()
                        != leaf.untyped_storage().data_ptr()):
                    # a host tensor of the gather's own: no second copy
                    buf = full
                elif i < len(bufs) and bufs[i].shape == full.shape \
                        and bufs[i].dtype == full.dtype:
                    buf = bufs[i]
                    buf.copy_(full)
                else:
                    buf = torch.empty(full.shape, dtype=full.dtype,
                                      pin_memory=pinned and
                                      torch.cuda.is_available())
                    buf.copy_(full)
                if pinned:
                    bufs[i:i + 1] = [buf]
                flat[keystr(path)] = buf
            i += 1
            del full
        out.append(_unflat(flat) if rank0 else None)
    return out[0], out[1], bufs


def _wait_for_rank_0() -> None:
    """The ranks but 0 wait here for rank 0's write, at most
    ``barrier_secs`` under gloo (``monitored_barrier``; NCCL's barrier
    has the process group's timeout)."""
    import datetime

    import torch.distributed as dist

    if dist.get_backend() == "gloo":
        dist.monitored_barrier(timeout=datetime.timedelta(
            seconds=_SAVE_CONFIG["barrier_secs"]))
    else:
        dist.barrier()


def _read_tree(path: Path, device) -> dict:
    flat = torch.load(Path(path) / PAYLOAD, map_location="cpu",
                      weights_only=True, mmap=True)
    return {k: v.to(device) for k, v in flat.items()}


def save_checkpoint(
    save_dir: str,
    iteration: int,
    params,
    opt_state=None,
    scheduler=None,
    *,
    args: Optional[dict] = None,
    consumed_samples: int = 0,
    release: bool = False,
    async_save: bool = False,
    plan=None,
    gathered: bool = False,
) -> str:
    """Reference: save_checkpoint (checkpointing.py:243-337).

    ``async_save``: the leaves are copied to host buffers before this
    returns and written by a background thread; the rename and the
    tracker happen at ``finalize_async_saves()`` (called first by the
    next save, and by the train loop on every exit path).

    Hardened IO: everything is written into ``iter_NNN.tmp`` and atomically
    renamed into place only once complete, so readers never observe a
    half-written checkpoint; transient IO errors are retried with
    exponential backoff (``configure_save``), counted in
    ``counters['save_retries']``.  Prints one line with the bytes written
    and the seconds taken.

    At tp x dp above 1 every rank calls this with its pieces and the
    step's ``plan`` (``parallel/sharding.TensorParallelPlan``): the trees
    are gathered into rank 0's host memory first (the line adds the
    gather's seconds), rank 0 writes them, and a synchronous save returns
    on the other ranks once rank 0 has committed it.  ``gathered``: the
    trees are already the one-device trees (a rescue save from rank 0's
    host snapshot), and this process writes them alone, with no
    collective."""
    if plan is None and not gathered and not topology.is_one_device():
        raise ValueError("at tp x dp x pp above 1 save_checkpoint needs "
                         "the step's plan to gather the one layout")
    if async_save:
        # at most one outstanding save: the previous one becomes durable
        # (rename + tracker) before this one starts
        finalize_async_saves()
    t0 = time.perf_counter()
    final_dir = Path(get_checkpoint_name(save_dir, iteration,
                                         release)).absolute()
    tmp_dir = final_dir.with_name(final_dir.name + ".tmp")

    opt_tree = _opt_state_to_tree(opt_state) if opt_state is not None \
        else None
    gather_secs = None
    if plan is not None:
        params, opt_tree, bufs = gather_one_layout(
            plan, params, opt_tree,
            _ASYNC["buffers"] if async_save else None, pinned=async_save)
        if async_save:
            _ASYNC["buffers"] = bufs
        gather_secs = time.perf_counter() - t0
        if not topology.is_rank_0():
            if not async_save:
                _wait_for_rank_0()
            return str(final_dir)
    final_dir.parent.mkdir(parents=True, exist_ok=True)
    manifest = {"model": _tree_manifest(params),
                "optim": _tree_manifest(opt_tree)}
    meta = {
        "checkpoint_version": CHECKPOINT_VERSION,
        "iteration": iteration,
        "consumed_samples": int(consumed_samples),
        "args": args or {},
        "opt_param_scheduler": scheduler.state_dict() if scheduler else None,
        "manifest": manifest,
        "manifest_sha256": _manifest_sha256(manifest),
    }

    def write(model_tree, optim_tree):
        n = _write_tree(tmp_dir / "model", model_tree)
        if optim_tree is not None:
            n += _write_tree(tmp_dir / "optim", optim_tree)
        with open(tmp_dir / "meta.json", "w") as f:
            json.dump(meta, f, indent=1)
        return n

    retries = max(0, _SAVE_CONFIG["retries"])
    nbytes = 0
    for attempt in range(retries + 1):
        try:
            _fault_hook_check()
            if tmp_dir.exists():
                shutil.rmtree(tmp_dir)
            tmp_dir.mkdir(parents=True)
            with tracing.span("checkpoint_write", "checkpoint",
                              iteration=int(iteration), attempt=attempt,
                              async_save=async_save):
                if async_save:
                    # the gathered trees are host copies already
                    host = ([params, opt_tree] if plan is not None else
                            _host_copy([params, opt_tree]))
                    nbytes = sum(v.numel() * v.element_size()
                                 for tree in host if tree is not None
                                 for v in _flat(tree).values())
                else:
                    nbytes = write(params, opt_tree)
            break
        except (IOError, OSError) as e:
            if attempt >= retries:
                raise
            get_counters()["save_retries"] += 1
            delay = _SAVE_CONFIG["retry_backoff"] * (2 ** attempt)
            print(f" [checkpoint] save attempt {attempt + 1}/{retries + 1} "
                  f"failed ({e}); retrying in {delay:.2f}s", flush=True)
            time.sleep(delay)

    if async_save:
        def writer():
            try:
                write(*host)
            except Exception as exc:   # noqa: BLE001 - raised at finalize
                _ASYNC["error"] = exc

        _ASYNC.update(slot=(save_dir, iteration, release, tmp_dir,
                            final_dir), t0=t0, nbytes=nbytes, error=None)
        _ASYNC["thread"] = threading.Thread(
            target=writer, name="checkpoint-writer", daemon=True)
        _ASYNC["thread"].start()
        print(f" [checkpoint] async save of iteration {iteration}: "
              f"{nbytes} bytes copied to host in "
              f"{time.perf_counter() - t0:.3f} s"
              + _gathered(gather_secs) + f", writing to {tmp_dir}",
              flush=True)
        return str(final_dir)
    _commit_checkpoint(save_dir, iteration, release, tmp_dir, final_dir)
    secs = time.perf_counter() - t0
    print(f" [checkpoint] saved iteration {iteration} to {final_dir}: "
          f"{nbytes} bytes in {secs:.3f} s" + _gathered(gather_secs),
          flush=True)
    if plan is not None and not async_save:
        _wait_for_rank_0()
    return str(final_dir)


def _gathered(secs) -> str:
    return "" if secs is None else \
        f" (the gather over tp x dp {secs:.3f} s of it)"


def load_checkpoint_args(load_dir: str,
                         iteration: Optional[int] = None) -> dict:
    """The 'args' dict recorded in a checkpoint's meta.json, without
    loading any tensors (reference --use_checkpoint_args,
    checkpointing.py:520-560 reads args from the state dict)."""
    release = False
    if iteration is None:
        iteration, release = read_tracker(load_dir)
        if iteration is None and not release:
            return {}
    ckpt_dir = Path(get_checkpoint_name(load_dir, iteration or 0, release))
    meta_path = ckpt_dir / "meta.json"
    if not meta_path.exists():
        return {}
    with open(meta_path) as f:
        return json.load(f).get("args") or {}


def read_tracker(load_dir: str) -> Tuple[Optional[int], bool]:
    # reference: checkpointing.py:570-607
    tracker = get_checkpoint_tracker_filename(load_dir)
    if not os.path.isfile(tracker):
        return None, False
    try:
        with open(tracker) as f:
            s = f.read().strip()
    except OSError as e:
        print(f" [checkpoint] WARNING: unreadable tracker {tracker} ({e}); "
              f"treating as absent", flush=True)
        return None, False
    if s == "release":
        return None, True
    try:
        return int(s), False
    except ValueError:
        # empty/corrupt tracker (killed mid-write, bad copy): not fatal —
        # the loader falls back to scanning iter_* dirs
        print(f" [checkpoint] WARNING: corrupt tracker {tracker} "
              f"(contents {s!r}); treating as absent", flush=True)
        return None, False


def _match_template(flat: dict, template, label: str) -> dict:
    """Hold a restored flat tree to a template tree (tensors, possibly on
    the meta device): the same keys and shapes; leaves are cast to the
    template's dtypes."""
    want = _flat(template)
    if set(flat) != set(want):
        missing = sorted(set(want) - set(flat))[:4]
        extra = sorted(set(flat) - set(want))[:4]
        raise ValueError(f"checkpoint {label} tree does not match the "
                         f"model: missing {missing}, unexpected {extra}")
    out = {}
    for key, leaf in flat.items():
        t = want[key]
        if tuple(leaf.shape) != tuple(t.shape):
            raise ValueError(f"checkpoint leaf {label}{key} has shape "
                             f"{list(leaf.shape)}, the model "
                             f"{list(t.shape)}")
        out[key] = leaf.to(t.dtype)
    return out


def load_checkpoint(
    load_dir: str,
    *,
    iteration: Optional[int] = None,
    release: bool = False,
    params_template=None,
    opt_state_template=None,
    scheduler=None,
    finetune: bool = False,
    load_params: bool = True,
    device="cuda",
    plan=None,
):
    """Load the latest (or given) checkpoint.

    Returns (params, opt_state, meta), leaves on ``device``.
    ``finetune=True`` skips optimizer / scheduler / iteration state
    (reference: --finetune, checkpointing.py:621+).  Templates (trees of
    tensors, on the meta device for a template that allocates nothing:
    the port's ``jax.eval_shape``) hold the restored trees to the
    model's keys and shapes and cast them to its dtypes; the optimizer
    state is restored only against a template, as in the JAX package.

    Resilient load: when no explicit iteration is requested and the tracker
    is missing/corrupt or points at a checkpoint that fails validation
    (missing payload, unreadable meta.json, manifest checksum mismatch),
    the newest iter_* dir that *does* validate is used instead.  An
    explicitly requested iteration is never silently substituted.

    At tp x dp above 1 give the step's ``plan``: every rank reads the one
    layout, held to the one-device templates, and keeps its piece of
    each leaf (``plan.shard_leaf``: the tp slice, and the ZeRO-1 dp
    slice of the optimizer state).
    """
    if plan is None and not topology.is_one_device():
        raise ValueError("at tp x dp x pp above 1 load_checkpoint needs "
                         "the step's plan to cut the one layout")
    t0 = time.perf_counter()
    explicit = iteration is not None or release
    if not explicit:
        iteration, release = read_tracker(load_dir)
        ckpt_dir = None
        if iteration is not None or release:
            cand = Path(get_checkpoint_name(
                load_dir, iteration or 0, release)).absolute()
            ok, reason = validate_checkpoint_dir(cand)
            if ok:
                ckpt_dir = cand
            else:
                print(f" [checkpoint] WARNING: tracked checkpoint "
                      f"{cand.name} invalid ({reason}); scanning for the "
                      f"newest valid one", flush=True)
        if ckpt_dir is None:
            # the invalid tracked dir fails validation again in the scan,
            # so it is skipped naturally — no exclusion needed
            found = _scan_latest_valid(load_dir)
            if found is None:
                return None, None, None
            iteration, ckpt_dir = found
            release = False
            print(f" [checkpoint] falling back to {ckpt_dir.name}",
                  flush=True)
    else:
        ckpt_dir = Path(get_checkpoint_name(
            load_dir, iteration or 0, release)).absolute()

    with open(ckpt_dir / "meta.json") as f:
        meta = json.load(f)
    manifest = meta.get("manifest") or {}

    nbytes = 0
    with tracing.span("checkpoint_load", "checkpoint",
                      iteration=int(iteration or 0)):
        # at tp x dp each leaf is read on the host and cut there
        read_on = "cpu" if plan is not None else device
        params = None
        if load_params:
            flat = _read_tree(ckpt_dir / "model", read_on)
            _verify_leaves(_unflat(flat), manifest.get("model"), "model")
            if params_template is not None:
                flat = _match_template(flat, params_template, "model")
            nbytes += sum(v.numel() * v.element_size()
                          for v in flat.values())
            params = _unflat(flat if plan is None else
                             _cut(plan, flat, False, device))

        opt_state = None
        if not finetune and (ckpt_dir / "optim").exists() \
                and opt_state_template is not None:
            flat = _read_tree(ckpt_dir / "optim", read_on)
            _verify_leaves(_unflat(flat), manifest.get("optim"), "optim")
            flat = _match_template(
                flat, _opt_state_to_tree(opt_state_template), "optim")
            nbytes += sum(v.numel() * v.element_size()
                          for v in flat.values())
            opt_state = _tree_to_opt_state(_unflat(
                flat if plan is None else _cut(plan, flat, True, device)))

    if finetune:
        meta["iteration"] = 0
        meta["consumed_samples"] = 0
    elif scheduler is not None and meta.get("opt_param_scheduler"):
        scheduler.load_state_dict(meta["opt_param_scheduler"])
    if str(device).startswith("cuda"):
        torch.cuda.synchronize(device)
    print(f" [checkpoint] loaded {ckpt_dir.name} from {load_dir}: {nbytes} "
          f"bytes in {time.perf_counter() - t0:.3f} s", flush=True)
    return params, opt_state, meta


def _cut(plan, flat: dict, is_opt: bool, device) -> dict:
    """This rank's pieces of a one-device flat tree, on ``device``."""
    out = {}
    for key, leaf in flat.items():
        path = _key_path(key)
        if is_opt:
            ppath, state = _state_leaf(path)
            piece = (plan.shard_leaf(ppath, leaf, sliced=plan.zero1)
                     if state else leaf)
        else:
            piece = plan.shard_leaf(path, leaf)
        out[key] = piece.to(device)
    return out


# -- opt-state <-> plain tree ------------------------------------------------

def _opt_state_to_tree(opt_state) -> dict:
    """The JAX package's tree of an ``OptimizerState``: the param-shaped
    trees it holds, and its scalars as 0-dim int32 / float32 tensors."""
    assert isinstance(opt_state, OptimizerState)
    dev = next((leaf.device for _, leaf in tree_leaves_with_path(
        opt_state.exp_avg)), torch.device("cpu"))
    if dev.type == "meta":
        dev = torch.device("cpu")

    def scalar(v, dtype):
        return torch.tensor(v, dtype=dtype, device=dev)

    out: dict[str, Any] = {"step": scalar(opt_state.step, torch.int32)}
    for name in ("master_params", "exp_avg", "exp_avg_sq"):
        v = getattr(opt_state, name)
        if v is not None:
            out[name] = v
    gs = opt_state.grad_scaler
    out["grad_scaler"] = {
        "scale": scalar(gs.scale, torch.float32),
        "growth_tracker": scalar(gs.growth_tracker, torch.int32),
        "hysteresis_tracker": scalar(gs.hysteresis_tracker, torch.int32),
    }
    return out


def _tree_to_opt_state(tree: dict) -> OptimizerState:
    gs = tree.get("grad_scaler", {})
    return OptimizerState(
        step=int(tree["step"]),
        master_params=tree.get("master_params"),
        exp_avg=tree.get("exp_avg"),
        exp_avg_sq=tree.get("exp_avg_sq"),
        grad_scaler=GradScalerState(
            scale=float(gs["scale"]),
            growth_tracker=int(gs["growth_tracker"]),
            hysteresis_tracker=int(gs["hysteresis_tracker"]),
        ),
    )
