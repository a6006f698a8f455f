"""What a traced window records of the calls into the intersection and
gather layers (the benchmark's own spans around the port's wrappers).

Inside `recording()`, each of the port's intersection wrappers (K1/K2,
K4/K5 and the Moller-Trumbore kernels) and gather wrappers (K3, K6, K7 and
their backward passes) is replaced by a function that keeps references to
its arguments and then calls the wrapper.  It launches nothing itself: the
live rays and the distinct columns are counted from the kept tensors after
the window.  The originals are restored on exit."""

from __future__ import annotations

import contextlib
import importlib
from dataclasses import dataclass, field
from typing import List

# (module, attribute, kind): kind "closest" or "any" for a ray call, or the
# gather's name
ISECT = (
    ("pim_tpu_torch.render.dense_kernels", "dense_isect", "closest"),
    ("pim_tpu_torch.render.dense_kernels", "dense_anyhit", "any"),
    ("pim_tpu_torch.render.cluster", "cluster_isect", "closest"),
    ("pim_tpu_torch.render.cluster", "cluster_anyhit", "any"),
    ("pim_tpu_torch.render.intersect", "brute_isect", "closest"),
    ("pim_tpu_torch.render.intersect", "brute_anyhit", "any"),
    ("pim_tpu_torch.render.intersect", "bvh_isect", "closest"),
    ("pim_tpu_torch.render.intersect", "bvh_anyhit", "any"),
)
GATHER = (
    ("pim_tpu_torch.render.gather_kernel", "gather_cols_fwd", "K3"),
    ("pim_tpu_torch.render.gather_kernel", "gather_cols_bwd", "K3-bwd"),
    ("pim_tpu_torch.render.table_gather", "gather_texels_fwd", "K7"),
    ("pim_tpu_torch.render.table_gather", "gather_texels_bwd", "K7-bwd"),
    ("pim_tpu_torch.render.table_gather", "gather_bilinear", "K6"),
    ("pim_tpu_torch.render.surface", "gather_bilinear", "K6"),
    ("pim_tpu_torch.render.sky", "gather_bilinear", "K6"),
)


@dataclass
class Calls:
    rays: List[tuple] = field(default_factory=list)     # (kind, n, t_far)
    gathers: List[tuple] = field(default_factory=list)  # (kind, args)


def _ray_wrapper(fn, kind, calls):
    def wrapped(*args, **kw):
        # every ray wrapper takes (..., ro, rd, t_near, t_far[, max_leaf])
        i = next(k for k, a in enumerate(args) if hasattr(a, "x"))
        calls.rays.append((kind, int(args[i].x.shape[0]), args[i + 3]))
        return fn(*args, **kw)
    return wrapped


def _gather_wrapper(fn, kind, calls):
    def wrapped(*args, **kw):
        calls.gathers.append((kind, args))
        return fn(*args, **kw)
    return wrapped


@contextlib.contextmanager
def recording():
    """Yields a Calls that fills while the block runs."""
    calls = Calls()
    saved = []
    try:
        for mod_name, attr, kind in ISECT + GATHER:
            mod = importlib.import_module(mod_name)
            fn = getattr(mod, attr)
            saved.append((mod, attr, fn))
            wrap = _gather_wrapper if (mod_name, attr, kind) in GATHER else _ray_wrapper
            setattr(mod, attr, wrap(fn, kind, calls))
        yield calls
    finally:
        for mod, attr, fn in reversed(saved):
            setattr(mod, attr, fn)
