"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` source is compiled by ``nvcc`` for ``sm_90a`` (one
``nvcc`` process per source, all started together), and the objects are
linked into one shared library with a plain C interface, loaded with
``ctypes``.  No PyTorch header is compiled, so a cold build takes
seconds.  The library lands in ``build/torch_kernels/`` at the repo root,
named by a digest of the sources and flags, so an edited source never
loads a stale build.  Nothing here runs at import time: the first
wrapper call on a CUDA tensor builds and loads the library.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional

import torch

CSRC_DIR = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "torch_kernels"
SOURCES = ("paged_attention.cu", "layernorm.cu", "flash_attention.cu")
HEADERS = ("common.cuh", "sm90.cuh")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas=-v")

# dtype codes of the C interface (csrc/common.cuh)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
# what the last build in this process printed (ptxas register and
# shared-memory use of every kernel)
build_log = ""

_c_int, _c_float, _ptr = ctypes.c_int, ctypes.c_float, ctypes.c_void_p
_i64s = ctypes.POINTER(ctypes.c_longlong)
_SIGNATURES = {
    # one packed NormFwdCall / NormBwdCall (csrc/layernorm.cu;
    # ops/kernels/norm_plan.py)
    "mlt_norm_fwd": [ctypes.c_char_p],
    "mlt_norm_bwd": [ctypes.c_char_p],
    "mlt_flash_fwd": [_ptr, _ptr, _ptr, _ptr, _ptr, _i64s, _c_int, _c_int,
                      _c_int, _c_int, _c_int, _c_int, _c_float, _c_int,
                      _c_int, _c_int, _ptr],
    "mlt_flash_bwd": [_ptr, _ptr, _ptr, _ptr, _ptr, _ptr, _ptr, _ptr, _ptr,
                      _ptr, _ptr, _i64s, _c_int, _c_int, _c_int, _c_int,
                      _c_int, _c_int, _c_float, _c_int, _c_int, _c_int,
                      _c_int, _c_int, _ptr],
    "mlt_flash_tiles": [_c_int, _c_int, ctypes.POINTER(ctypes.c_int)],
    "mlt_flash_smem": [_c_int, _c_int, _i64s],
    "mlt_ragged_paged_attention": [_ptr, _ptr, _ptr, _ptr, _ptr, _ptr, _ptr,
                                   _ptr, _ptr, _ptr, _c_int, _c_int, _c_int,
                                   _c_int, _c_int, _c_int, _c_int, _c_float,
                                   _c_int, _c_int, _c_int, _c_int, _ptr],
}


def _nvcc() -> str:
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    cands += [shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"]
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH);"
                       " the CUDA kernels are built from csrc/ at first use")


def source_digest(paths, flags) -> str:
    """A digest of the compiler flags and the named source files: the
    name a build is stored under, so an edited source never loads a
    stale build (the data helpers' g++ build takes it too)."""
    h = hashlib.sha256(" ".join(flags).encode())
    for path in paths:
        h.update(Path(path).name.encode())
        h.update(Path(path).read_bytes())
    return h.hexdigest()[:16]


def _digest() -> str:
    return source_digest([CSRC_DIR / n for n in SOURCES + HEADERS],
                         NVCC_FLAGS)


def build() -> Path:
    """Compile the sources (in parallel) and link the library; returns
    its path.  A library already built from the same sources is reused."""
    global build_log
    lib_path = BUILD_DIR / f"libmlt_kernels_{_digest()}.so"
    if lib_path.exists():
        return lib_path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    tag = f"{lib_path.stem}.{os.getpid()}"
    objs, procs = [], []
    for src in SOURCES:
        obj = BUILD_DIR / f"{Path(src).stem}.{tag}.o"
        objs.append(obj)
        procs.append(subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", str(CSRC_DIR / src), "-o", str(obj)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    logs = []
    failed = []
    for src, p in zip(SOURCES, procs):
        out, _ = p.communicate()
        logs.append(f"== nvcc {src}\n{out}")
        if p.returncode != 0:
            failed.append(src)
    build_log = "\n".join(logs)
    if failed:
        raise RuntimeError(f"nvcc failed for {failed}:\n{build_log}")
    tmp = BUILD_DIR / f"{lib_path.name}.tmp.{os.getpid()}"
    link = subprocess.run(
        [nvcc, "-shared", "-gencode", "arch=compute_90a,code=sm_90a",
         "-o", str(tmp), *map(str, objs)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for obj in objs:
        obj.unlink(missing_ok=True)
    if link.returncode != 0:
        raise RuntimeError(f"linking the kernels failed:\n{link.stdout}")
    os.replace(tmp, lib_path)
    return lib_path


def load_library() -> ctypes.CDLL:
    """The kernels' shared library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = lib
        return _lib


def dtype_code(t: torch.Tensor) -> int:
    try:
        return DTYPE_CODES[t.dtype]
    except KeyError:
        raise TypeError(f"the CUDA kernels take float32 or bfloat16, got "
                        f"{t.dtype}") from None


def stream_handle(t: torch.Tensor) -> int:
    """The raw cudaStream_t of the current stream on t's device (the
    call the compiled wrappers of torch.compile make: no Stream object
    is built for a launch)."""
    return torch._C._cuda_getCurrentRawStream(t.get_device())


def check_rc(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} launch failed with cudaError_t {rc}")


_SM_COUNTS: dict = {}


def sm_count(device) -> int:
    """Streaming multiprocessors of a CUDA device, a torch.device or an
    index (cached)."""
    count = _SM_COUNTS.get(device)     # an index seen before
    if count is not None:
        return count
    idx = device if isinstance(device, int) else (
        device.index if device.index is not None
        else torch.cuda.current_device())
    if idx not in _SM_COUNTS:
        _SM_COUNTS[idx] = torch.cuda.get_device_properties(
            idx).multi_processor_count
    return _SM_COUNTS[idx]


def require_cuda(t: torch.Tensor, name: str) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
