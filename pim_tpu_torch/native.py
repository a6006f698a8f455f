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

The host-side BVH builder (csrc/bvh_builder.cpp, a copy of the JAX
package's) is built here too, with g++ and the JAX package's flags, into
its own directory under the same root; `build_bvh_native` runs it.  A
failed compile raises: there is no quiet fallback to the numpy builder,
whose tree (and so the `bvh` backend's ties) differs.
"""

from __future__ import annotations

import ctypes
import fcntl
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
           "gather_texels.cu", "mt_isect.cu", "bsdf.cu", "sky.cu", "rng.cu", "media.cu")
HEADERS = ("gather_tiles.cuh", "rng.cuh")  # included by the sources; in the build hash
BUILD_ROOT = os.path.join(os.path.dirname(_PKG), "build", "pim_tpu_torch")
LIB_NAME = "libpim_tpu_torch.so"
# --fmad=false: the intersection kernels must round every product and sum
# as separate float32 operations (no fused multiply-add), as the reference;
# the BSDF, sky and media kernels as PyTorch's one-op kernels do.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "--fmad=false", "-Xptxas", "-v", "-Xcompiler", "-fPIC",
)

launches: Dict[str, int] = {
    "dense_isect": 0, "dense_anyhit": 0, "gather_cols": 0, "gather_cols_bwd": 0,
    "cluster_isect": 0, "cluster_anyhit": 0, "gather_bilinear": 0,
    "gather_texels": 0, "gather_texels_bwd": 0,
    "brute_isect": 0, "brute_anyhit": 0, "bvh_isect": 0, "bvh_anyhit": 0,
    "bsdf_scatter": 0, "bsdf_refract_finish": 0, "bsdf_eval": 0,
    "sky_bake": 0, "sky_bake_bwd": 0, "sky_grad_sum": 0,
    "rng_seed": 0, "rng_draw": 0,
    "media_scatter": 0, "media_transmittance": 0,
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
    # positions, tri count, the ray arguments, n, t, tri, u, v, det, stream
    mt_args = [p, i] + [p] * 6 + [f, p, f, i]
    lib.pim_brute_isect.argtypes = mt_args + [p] * 6
    lib.pim_brute_isect.restype = i
    lib.pim_brute_anyhit.argtypes = mt_args + [p, p]
    lib.pim_brute_anyhit.restype = i
    # node_lo, node_hi, node_a, node_b, tri_order, max_leaf, positions, the
    # ray arguments, n, outputs as above, stream
    bvh_args = [p] * 5 + [i, p] + [p] * 6 + [f, p, f, i]
    lib.pim_bvh_isect.argtypes = bvh_args + [p] * 6
    lib.pim_bvh_isect.restype = i
    lib.pim_bvh_anyhit.argtypes = bvh_args + [p, p]
    lib.pim_bvh_anyhit.restype = i
    # the pointer table, lut, lut size, n, refractive_path, out, words, probe, stream
    lib.pim_bsdf_scatter.argtypes = [p, p, i, ll, i, p, p, p, p]
    lib.pim_bsdf_scatter.restype = i
    # probe, t_hit, albedo x/y/z, roughness, n, out, stream
    lib.pim_bsdf_refract_finish.argtypes = [p] * 6 + [ll, p, p]
    lib.pim_bsdf_refract_finish.restype = i
    # the pointer table, lut, lut size, n, out, stream
    lib.pim_bsdf_eval.argtypes = [p, p, i, ll, p, p]
    lib.pim_bsdf_eval.restype = i
    # directions x/y/z, light_dir, luminance, the constants, trips, split, n,
    # out, stream
    lib.pim_sky_bake.argtypes = [p] * 6 + [i, i, ll, p, p]
    lib.pim_sky_bake.restype = i
    # as pim_sky_bake to n, then grad, partial, stream
    lib.pim_sky_bake_bwd.argtypes = [p] * 6 + [i, i, ll, p, p, p]
    lib.pim_sky_bake_bwd.restype = i
    # partial, n, out, stream
    lib.pim_sky_grad_sum.argtypes = [p, ll, p, p]
    lib.pim_sky_grad_sum.restype = i
    # pix, n, then for the sample id and the seed: pointer (or null), element
    # size, step, value; words, stream
    key = [p, i, i, ctypes.c_uint]
    lib.pim_rng_seed.argtypes = [p, ll] + key + key + [p, p]
    lib.pim_rng_seed.restype = i
    # x, y, z, w, n, k, words, out, stream
    lib.pim_rng_draw.argtypes = [p] * 4 + [ll, i, p, p, p]
    lib.pim_rng_draw.restype = i
    # the lane pointer table, the medium's constants, octaves, n, out,
    # scattered, words, tally (or null), stream
    lib.pim_media_scatter.argtypes = [p, p, i, ll, p, p, p, p, p]
    lib.pim_media_scatter.restype = i
    # the lane pointer table, the medium's constants, octaves, n, out, words,
    # tally (or null), stream
    lib.pim_media_transmittance.argtypes = [p, p, i, ll, p, p, p, p]
    lib.pim_media_transmittance.restype = i
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


# ---------------------------------------------------------------------------
# The host-side BVH builder (g++)
# ---------------------------------------------------------------------------

BVH_SOURCE = "bvh_builder.cpp"
BVH_LIB_NAME = "libpim_bvh_builder.so"
# the JAX package's loader's flags (its native/__init__.py), so that on one
# host both packages' builders compile to the same code
GXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared", "-march=native")

_bvh_lock = threading.Lock()
_bvh_lib: Optional[ctypes.CDLL] = None


def _gxx() -> str:
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found on PATH: the BVH builder cannot be built")
    return gxx


def bvh_builder_hash(gxx: str) -> str:
    """The builder's build hash: its source, the flags, and what
    -march=native resolves to on this host (a tree built elsewhere may use
    instructions this CPU lacks, and a different arch may round the SAH
    costs differently)."""
    target = subprocess.run([gxx, "-march=native", "-Q", "--help=target"], capture_output=True,
                            text=True, timeout=60).stdout
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode() + target.encode())
    with open(os.path.join(CSRC, BVH_SOURCE), "rb") as f:
        h.update(f.read())
    return h.hexdigest()[:16]


def build_bvh_builder() -> str:
    """Compile csrc/bvh_builder.cpp unless this hash is already built;
    returns the library's path.  The compile writes a temporary name and
    renames it into place under a lock file, so processes that build at
    once neither race nor load a half-written library."""
    gxx = _gxx()
    out_dir = os.path.join(BUILD_ROOT, "bvh_" + bvh_builder_hash(gxx))
    path = os.path.join(out_dir, BVH_LIB_NAME)
    if os.path.exists(path):
        return path
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, ".lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if os.path.exists(path):  # another process built it meanwhile
            return path
        tmp = f"{path}.{os.getpid()}.tmp"
        cmd = [gxx, *GXX_FLAGS, "-o", tmp, os.path.join(CSRC, BVH_SOURCE)]
        res = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
        if res.returncode != 0:
            raise RuntimeError(f"g++ failed ({res.returncode}) on {BVH_SOURCE}:\n"
                               f"{' '.join(cmd)}\n{res.stdout}{res.stderr}")
        os.replace(tmp, path)
    return path


def load_bvh_builder() -> ctypes.CDLL:
    """The BVH builder's library, built on first use."""
    global _bvh_lib
    with _bvh_lock:
        if _bvh_lib is not None:
            return _bvh_lib
        lib = ctypes.CDLL(build_bvh_builder())
        p, ll = ctypes.c_void_p, ctypes.c_int64
        lib.pim_bvh_build.restype = p
        lib.pim_bvh_build.argtypes = [p, ll, ctypes.c_int]
        lib.pim_bvh_counts.restype = None
        lib.pim_bvh_counts.argtypes = [p, ctypes.POINTER(ll), ctypes.POINTER(ll)]
        lib.pim_bvh_export.restype = None
        lib.pim_bvh_export.argtypes = [p] * 6
        lib.pim_bvh_free.restype = None
        lib.pim_bvh_free.argtypes = [p]
        _bvh_lib = lib
        return lib


def build_bvh_native(positions, max_leaf: int = 4):
    """Binned-SAH build in C++ of a [V, 3] float32 flat triangle soup
    (V = 3*T); returns geom.bvh.BvhArrays."""
    import numpy as np

    from pim_tpu_torch.geom.bvh import BvhArrays

    lib = load_bvh_builder()
    v = np.ascontiguousarray(positions, np.float32)
    handle = lib.pim_bvh_build(v.ctypes.data, v.shape[0] // 3, int(max_leaf))
    try:
        nn, nt = ctypes.c_int64(), ctypes.c_int64()
        lib.pim_bvh_counts(handle, ctypes.byref(nn), ctypes.byref(nt))
        out = BvhArrays(np.empty((nn.value, 3), np.float32), np.empty((nn.value, 3), np.float32),
                        np.empty(nn.value, np.int32), np.empty(nn.value, np.int32),
                        np.empty(nt.value, np.int32))
        lib.pim_bvh_export(handle, *(a.ctypes.data for a in out))
    finally:
        lib.pim_bvh_free(handle)
    return out
