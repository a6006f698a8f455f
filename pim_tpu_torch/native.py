"""Build and bind the port's CUDA kernels (csrc/*.cu) through ctypes.

Each source is compiled with nvcc for sm_90a into an object, all of them at
once in parallel, and the objects are linked into one shared library with a
plain C interface.  The build runs at first use, from the package's own
sources, into `build/pim_tpu_torch/<hash>/` beside the package (the hash
covers the sources and the flags, so an edited kernel is rebuilt and a
fresh checkout builds by itself).  Nothing here has a fallback: a missing
toolkit or a failed compile raises.

Each kernel wrapper counts its launches in `launches` (one per kernel
launch, nowhere else), so a run can show that its main path went through
the kernels.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from dataclasses import dataclass
from typing import Dict, Optional

import torch

_PKG = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_PKG, "csrc")
SOURCES = ("dense_isect.cu", "gather_cols.cu", "cluster_isect.cu", "gather_bilinear.cu",
           "gather_texels.cu")
HEADERS = ("gather_tiles.cuh",)  # included by the sources; in the build hash
BUILD_ROOT = os.path.join(os.path.dirname(_PKG), "build", "pim_tpu_torch")
LIB_NAME = "libpim_tpu_torch.so"
# --fmad=false: the intersection kernels must round every product and sum
# as separate float32 operations (no fused multiply-add), as the reference.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "--fmad=false", "-Xptxas", "-v", "-Xcompiler", "-fPIC",
)

launches: Dict[str, int] = {
    "dense_isect": 0, "dense_anyhit": 0, "gather_cols": 0, "gather_cols_bwd": 0,
    "cluster_isect": 0, "cluster_anyhit": 0, "gather_bilinear": 0,
    "gather_texels": 0, "gather_texels_bwd": 0,
}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


@dataclass
class BuildInfo:
    path: str
    seconds: float     # compile time; 0.0 when the library was already built
    log: str           # nvcc/ptxas output (registers, shared memory, spills)


_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_info: Optional[BuildInfo] = None


def _nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
                 shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (CUDA_HOME/bin, /usr/local/cuda/bin or PATH): "
                       "the port's CUDA kernels cannot be built")


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        with open(os.path.join(CSRC, name), "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def build() -> BuildInfo:
    """Compile csrc/*.cu unless this source hash is already built."""
    out_dir = os.path.join(BUILD_ROOT, source_hash())
    path = os.path.join(out_dir, LIB_NAME)
    if os.path.exists(path):
        return BuildInfo(path=path, seconds=0.0, log="")
    os.makedirs(out_dir, exist_ok=True)
    nvcc = _nvcc()
    tag = f"{os.getpid()}.tmp"
    objs = [os.path.join(out_dir, f"{s}.{tag}.o") for s in SOURCES]
    t0 = time.perf_counter()
    procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", obj, os.path.join(CSRC, src)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for src, obj in zip(SOURCES, objs)]
    logs = []
    failed = []
    for src, proc in zip(SOURCES, procs):
        out, _ = proc.communicate(timeout=600)
        logs.append(f"== {src}\n{out}")
        if proc.returncode != 0:
            failed.append(src)
    log = "".join(logs)
    if failed:
        raise RuntimeError(f"nvcc failed on {failed}:\n{log}")
    tmp = f"{path}.{tag}"
    cmd = [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared", "-o", tmp, *objs]
    res = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    seconds = time.perf_counter() - t0
    log += res.stdout + res.stderr
    if res.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({res.returncode}):\n{' '.join(cmd)}\n{log}")
    os.replace(tmp, path)
    for obj in objs:
        os.remove(obj)
    return BuildInfo(path=path, seconds=seconds, log=log)


def load() -> ctypes.CDLL:
    """The kernel library, built on first use."""
    global _lib, _info
    with _lock:
        if _lib is not None:
            return _lib
        info = build()
        lib = ctypes.CDLL(info.path)
        bind(lib)
        _lib, _info = lib, info
        return _lib


def bind(lib) -> None:
    """Sets the argument and result types of every C entry point of `lib`."""
    p, i, ll, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
    # tris, ntri, ro/rd x6, t_near, t_far (or null), t_far for all rays
    ray_args = [p, i] + [p] * 6 + [f, p, f]
    lib.pim_dense_isect.argtypes = ray_args + [i, p, p, p]
    lib.pim_dense_isect.restype = i
    lib.pim_dense_anyhit.argtypes = ray_args + [i, i, p, p]  # n, warp_below, out, stream
    lib.pim_dense_anyhit.restype = i
    # table (or gradient), f, t, idx, n, out (or gradient table), the
    # variant (staged, wide, vec), stream
    for fn in (lib.pim_gather_cols_i32, lib.pim_gather_cols_i64, lib.pim_gather_texels,
               lib.pim_gather_cols_bwd_i32, lib.pim_gather_cols_bwd_i64,
               lib.pim_gather_texels_bwd):
        fn.argtypes = [p, i, i, p, ll, p, i, i, i, p]
        fn.restype = i
    # row-major table copy (or gradient), f, t, idx, n, out (or row-major
    # gradient table), wide, vec, stream
    for fn in (lib.pim_gather_cols_rows_i32, lib.pim_gather_cols_rows_i64,
               lib.pim_gather_cols_bwd_rows_i32, lib.pim_gather_cols_bwd_rows_i64,
               lib.pim_gather_texels_bwd_rows):
        fn.argtypes = [p, i, i, p, ll, p, i, i, p]
        fn.restype = i
    # scb, spad, clb, n_sc, tris, stride, the ray arguments, lane_loop_min
    cluster_args = [p, i, p, i, p, i] + [p] * 6 + [f, p, f, i, i]
    lib.pim_cluster_isect.argtypes = cluster_args + [p, p, p]
    lib.pim_cluster_isect.restype = i
    lib.pim_cluster_anyhit.argtypes = cluster_args + [p, p]
    lib.pim_cluster_anyhit.restype = i
    # texel rows, c, t, idx, tx, ty, valid, k * n, out, stream
    lib.pim_gather_bilinear.argtypes = [p, i, i, p, p, p, p, ll, p, p]
    lib.pim_gather_bilinear.restype = i
    lib.pim_cuda_error_string.argtypes = [i]
    lib.pim_cuda_error_string.restype = ctypes.c_char_p


def build_info() -> BuildInfo:
    load()
    return _info


def check(lib: ctypes.CDLL, rc: int, name: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if rc != 0:
        msg = lib.pim_cuda_error_string(rc).decode()
        raise RuntimeError(f"{name}: CUDA launch failed with error {rc} ({msg})")


def stream_ptr(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def require_cuda(name: str, t: torch.Tensor, dtype: torch.dtype, shape, device) -> None:
    """Raise unless `t` is a contiguous CUDA tensor of `dtype` and `shape`
    on `device`."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor, got {type(t).__name__}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")
