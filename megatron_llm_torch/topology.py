"""Process-group topology over ``torch.distributed`` (the counterpart of
``megatron_llm_tpu/topology.py``).

The JAX package lays its devices out as one mesh with axes ``('slice',
'pp', 'dp', 'cp', 'tp')``; the port lays the ranks out in the same
order, tp innermost, so that a tensor-parallel group is a block of
consecutive ranks (``rank_grid``).  ``initialize_model_parallel`` derives
dp as world // (slice x tp x pp x cp), as the JAX package does, and
builds one ``torch.distributed`` group for each tp block and one for each
(slice, pp, cp, tp) coordinate, whose ranks stride cp x tp: the dp
group, the JAX mesh's ``dp`` axis.  The getters
answer from the process's own rank (the JAX package answers inside
``shard_map`` with ``axis_index``).  Before ``initialize_model_parallel``
runs, every size is 1 and every rank 0: the single-device paths never
call it.

``initialize_distributed`` boots the process group from torchrun's
environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``,
``MASTER_PORT``) and places the rank on ``cuda:LOCAL_RANK``.  The backend
flag keeps the JAX package's choices: ``xla`` is read as the device's
own backend (NCCL on CUDA, gloo on the CPU).  Two ranks may share one
GPU only under gloo, and then each says so; NCCL refuses a device shared
between ranks, so under NCCL a rank without a GPU of its own raises.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

SLICE_AXIS = "slice"
PP_AXIS = "pp"
DP_AXIS = "dp"
CP_AXIS = "cp"
TP_AXIS = "tp"
MESH_AXES = (SLICE_AXIS, PP_AXIS, DP_AXIS, CP_AXIS, TP_AXIS)

# the sizes of the axes, their ranks for this process, and this process's
# tp and dp groups (None in a world of one process, or at size 1)
_SIZES: Optional[dict] = None
_COORDS: Optional[dict] = None
_TP_GROUP = None
_DP_GROUP = None
_VIRTUAL_PIPELINE_MODEL_PARALLEL_SIZE: Optional[int] = None


def rank_grid(world_size: int, tensor_model_parallel_size: int = 1,
              pipeline_model_parallel_size: int = 1,
              context_parallel_size: int = 1,
              num_slices: int = 1) -> np.ndarray:
    """The ranks as an array ``[slice, pp, dp, cp, tp]`` (the JAX mesh's
    device order): tp neighbours adjacent, cp striding tp, dp striding
    cp x tp, pp striding dp x cp x tp.  Raises ``RuntimeError`` when the
    world does not divide, as the JAX package does."""
    tp, pp = tensor_model_parallel_size, pipeline_model_parallel_size
    cp, sl = context_parallel_size, num_slices
    if sl < 1 or world_size % sl != 0:
        raise RuntimeError(
            f"world size ({world_size}) is not divisible by num_slices "
            f"({sl})")
    if world_size % (sl * tp * pp * cp) != 0:
        raise RuntimeError(
            f"world size ({world_size}) is not divisible by num_slices "
            f"({sl}) x tensor parallel size ({tp}) x pipeline parallel "
            f"size ({pp}) x context parallel size ({cp})")
    dp = world_size // (sl * tp * pp * cp)
    return np.arange(world_size).reshape(sl, pp, dp, cp, tp)


def initialize_model_parallel(
    tensor_model_parallel_size: int = 1,
    pipeline_model_parallel_size: int = 1,
    virtual_pipeline_model_parallel_size: Optional[int] = None,
    context_parallel_size: int = 1,
    num_slices: int = 1,
    world_size: Optional[int] = None,
    rank: Optional[int] = None,
) -> np.ndarray:
    """Lay the ranks out and build the tp and dp groups; returns
    ``rank_grid``'s array.  ``world_size`` and ``rank`` default to the process group's
    (1 and 0 without one).  Given without a process group, only the
    sizes and ranks are set: no group is built (the rank arithmetic of
    the JAX package's mesh tests).  Every rank of a process group must
    call this, in the same order: ``new_group`` is collective."""
    global _SIZES, _COORDS, _TP_GROUP, _DP_GROUP
    global _VIRTUAL_PIPELINE_MODEL_PARALLEL_SIZE
    have_pg = dist.is_available() and dist.is_initialized()
    if world_size is None:
        world_size = dist.get_world_size() if have_pg else 1
    if rank is None:
        rank = dist.get_rank() if have_pg else 0
    grid = rank_grid(world_size, tensor_model_parallel_size,
                     pipeline_model_parallel_size, context_parallel_size,
                     num_slices)
    coords = np.argwhere(grid == rank)[0]
    tp_group = None
    if have_pg and world_size > 1 and tensor_model_parallel_size > 1:
        # every block of tp ranks is a group; each rank keeps its own
        for block in grid.reshape(-1, tensor_model_parallel_size):
            group = dist.new_group([int(r) for r in block])
            if rank in block:
                tp_group = group
    dp_group = None
    dp = grid.shape[2]
    if have_pg and world_size > 1 and dp > 1:
        # the dp axis to the end: each row is one (slice, pp, cp, tp)
        # coordinate's dp ranks, which stride cp x tp
        for row in np.moveaxis(grid, 2, -1).reshape(-1, dp):
            group = dist.new_group([int(r) for r in row])
            if rank in row:
                dp_group = group
    _SIZES = dict(zip(MESH_AXES, grid.shape))
    _COORDS = {a: int(c) for a, c in zip(MESH_AXES, coords)}
    _TP_GROUP = tp_group
    _DP_GROUP = dp_group
    _VIRTUAL_PIPELINE_MODEL_PARALLEL_SIZE = \
        virtual_pipeline_model_parallel_size
    return grid


def model_parallel_is_initialized() -> bool:
    return _SIZES is not None


def destroy_model_parallel() -> None:
    """Forget the layout (the process group itself stays up)."""
    global _SIZES, _COORDS, _TP_GROUP, _DP_GROUP
    global _VIRTUAL_PIPELINE_MODEL_PARALLEL_SIZE
    _SIZES = _COORDS = _TP_GROUP = _DP_GROUP = None
    _VIRTUAL_PIPELINE_MODEL_PARALLEL_SIZE = None


def _size(axis: str) -> int:
    return 1 if _SIZES is None else int(_SIZES[axis])


def _rank(axis: str) -> int:
    return 0 if _COORDS is None else _COORDS[axis]


def get_tensor_model_parallel_world_size() -> int:
    return _size(TP_AXIS)


def get_pipeline_model_parallel_world_size() -> int:
    return _size(PP_AXIS)


def get_data_parallel_world_size() -> int:
    return _size(DP_AXIS)


def get_context_parallel_world_size() -> int:
    return _size(CP_AXIS)


def get_num_slices() -> int:
    return _size(SLICE_AXIS)


def get_virtual_pipeline_model_parallel_world_size() -> Optional[int]:
    return _VIRTUAL_PIPELINE_MODEL_PARALLEL_SIZE


def get_world_size() -> int:
    return int(np.prod([_size(a) for a in MESH_AXES]))


def get_tensor_model_parallel_rank() -> int:
    return _rank(TP_AXIS)


def get_pipeline_model_parallel_rank() -> int:
    return _rank(PP_AXIS)


def get_data_parallel_rank() -> int:
    return _rank(DP_AXIS)


def get_context_parallel_rank() -> int:
    return _rank(CP_AXIS)


def get_slice_rank() -> int:
    return _rank(SLICE_AXIS)


def get_tensor_model_parallel_group():
    """This rank's tp group; raises when tp is 1 (nothing to reduce over)
    or when the layout was set without a process group."""
    if _TP_GROUP is None:
        raise RuntimeError("no tensor-parallel group: tp is 1 or "
                           "initialize_model_parallel ran without a "
                           "process group")
    return _TP_GROUP


def get_data_parallel_group():
    """This rank's dp group; raises when dp is 1 or when the layout was
    set without a process group."""
    if _DP_GROUP is None:
        raise RuntimeError("no data-parallel group: dp is 1 or "
                           "initialize_model_parallel ran without a "
                           "process group")
    return _DP_GROUP


def is_one_device() -> bool:
    """tp and dp are both 1: the rank holds the whole tree and the whole
    optimizer state (the save paths' single-writer case)."""
    return (get_tensor_model_parallel_world_size() == 1
            and get_data_parallel_world_size() == 1)


def resolve_backend(flag: str, device_type: str) -> str:
    """``--distributed_backend`` for a device: ``xla`` is the device's own
    backend, NCCL on CUDA and gloo on the CPU; NCCL on the CPU raises."""
    if flag == "xla":
        return "nccl" if device_type == "cuda" else "gloo"
    if flag == "nccl" and device_type != "cuda":
        raise ValueError("--distributed_backend nccl needs CUDA devices; "
                         "the CPU takes gloo")
    if flag not in ("nccl", "gloo"):
        raise ValueError(f"unknown distributed backend {flag!r}")
    return flag


def initialize_distributed(backend: str = "xla", device: str = "cuda",
                           init_method: Optional[str] = None,
                           timeout_secs: float = 600.0) -> str:
    """Boot the process group from torchrun's environment and place this
    rank; returns the rank's device (``"cuda:<i>"`` or ``"cpu"``).

    A world of one process without a process group is left as it is (the
    single-device path); so is a process group that is already up (a
    caller that booted it with its own store).  ``init_method`` defaults
    to torchrun's ``env://``.  The rank's GPU is ``cuda:LOCAL_RANK``.
    Under gloo, ranks beyond the GPUs there are share them round robin,
    and each such rank prints that it does; under NCCL such a rank
    raises, since NCCL refuses two ranks on one device."""
    world = int(os.environ.get("WORLD_SIZE", "1"))
    rank = int(os.environ.get("RANK", "0"))
    local_rank = int(os.environ.get("LOCAL_RANK", "0"))
    have_pg = dist.is_available() and dist.is_initialized()
    if have_pg:
        world, rank = dist.get_world_size(), dist.get_rank()
    dev_type = "cuda" if str(device).startswith("cuda") else "cpu"
    be = resolve_backend(backend, dev_type)
    placed = "cpu"
    if dev_type == "cuda":
        count = torch.cuda.device_count()
        if count == 0:
            raise RuntimeError("no CUDA device (pass --device cpu to run "
                               "on the CPU)")
        if local_rank >= count:
            if be == "nccl" and world > 1:
                raise RuntimeError(
                    f"rank {rank} (local rank {local_rank}) has no GPU of "
                    f"its own ({count} visible): NCCL refuses two ranks on "
                    f"one device; run one rank a GPU, or share the GPU "
                    f"under --distributed_backend gloo")
            print(f" > rank {rank} (local rank {local_rank}) shares "
                  f"cuda:{local_rank % count} with another rank: {count} "
                  f"GPU(s) for the local ranks, collectives over gloo",
                  flush=True)
        placed = f"cuda:{local_rank % count}"
        torch.cuda.set_device(placed)
    if not have_pg and (world > 1 or init_method is not None or (
            "RANK" in os.environ and "MASTER_ADDR" in os.environ)):
        dist.init_process_group(
            be, init_method=init_method or "env://", world_size=world,
            rank=rank, timeout=datetime.timedelta(seconds=timeout_secs))
    return placed


def is_rank_0() -> bool:
    """True on the process that logs: global rank 0, or the only one."""
    return not (dist.is_available() and dist.is_initialized()) or \
        dist.get_rank() == 0



def refuse_at_tp(what: str) -> None:
    """Raise ``NotImplementedError`` for ``what`` at tp > 1 (a feature
    this slice runs on one device only; ROADMAP item 15)."""
    tp = get_tensor_model_parallel_world_size()
    if tp > 1:
        raise NotImplementedError(
            f"{what} at tensor-parallel size {tp} is not ported yet "
            f"(ROADMAP item 15)")


def refuse_at_dp(what: str, item: str) -> None:
    """Raise ``NotImplementedError`` for ``what`` at dp > 1 (a feature
    whose loss or state this slice does not split over dp; ROADMAP item
    15 ``item``)."""
    dp = get_data_parallel_world_size()
    if dp > 1:
        raise NotImplementedError(
            f"{what} at data-parallel size {dp} is not ported yet "
            f"(ROADMAP item 15 {item})")


def is_distributed() -> bool:
    """A process group is up (torchrun, or a caller's own store)."""
    return dist.is_available() and dist.is_initialized()
