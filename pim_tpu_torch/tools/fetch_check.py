"""What K3-bwd, K7-bwd and K6 are checked on and held against, shared by
chip_smoke.py, tests/test_torch_fetch_check.py and tools/fetch_variants.py.

- Calls: `recorded_calls` keeps a copy of the arguments that the main path
  hands gather_cols_bwd (K3-bwd), gather_texels_bwd (K7-bwd) and
  gather_bilinear (K6, atlas and sky apart); `training_step_calls` and
  `serving_step_calls` record them over one e1m1 training step and one
  serving step.
- References: `scatter_error` holds a backward kernel's output against its
  plain version summed in float64, within gamma(adds - 1) * sum |g| per
  output, the bound of any summation order; `lane_counts` counts a K3-bwd
  call's lanes at index 0 and with an all-zero gradient.
- Yardsticks: `index_add_call` and `embedding_bag_call`, one PyTorch call
  computing the same function, its inputs made beforehand.

Every import of the package is made inside the function that needs it, so
tools/fetch_variants.py can load this file beside an older tree of the
package and drive that tree's wrappers.
"""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def recorded_calls():
    """Within it, every call of gather_cols_bwd appends a copy of (g, idx,
    t) to the yielded {"k3_bwd": [...]}, every call of gather_texels_bwd
    one to "k7_bwd", and every call of gather_bilinear from the surface
    shading (the atlas) or the sky one of (corner_planes, idx, tx, ty,
    valid, c) to "k6_atlas" or "k6_sky" (the planes themselves, the rest
    copied)."""
    from pim_tpu_torch.render import gather_kernel as gk
    from pim_tpu_torch.render import sky, surface
    from pim_tpu_torch.render import table_gather as tg

    calls = {"k3_bwd": [], "k7_bwd": [], "k6_atlas": [], "k6_sky": []}
    patched = ((gk, "gather_cols_bwd", "k3_bwd"), (tg, "gather_texels_bwd", "k7_bwd"),
               (surface, "gather_bilinear", "k6_atlas"), (sky, "gather_bilinear", "k6_sky"))
    kept = [getattr(module, name) for module, name, _ in patched]

    def recording(kind, fn):
        def wrapper(*args, **kwargs):
            if kind.startswith("k6"):
                planes, *rest = args
                calls[kind].append((planes, *(a.clone() for a in rest), kwargs["c"]))
            else:
                g, idx, t = args
                calls[kind].append((g.clone(), idx.clone(), t))
            return fn(*args, **kwargs)
        return wrapper

    for (module, name, kind), fn in zip(patched, kept):
        setattr(module, name, recording(kind, fn))
    try:
        yield calls
    finally:
        for (module, name, _), fn in zip(patched, kept):
            setattr(module, name, fn)


def training_step_calls(scene, width: int = 512, height: int = 512, bounces: int = 3,
                        sky_steps: int = 8, seed: int = 7) -> dict:
    """The K3-bwd and K7-bwd calls (`recorded_calls`) of one training step
    of the differentiable path on `scene` at width x height, `bounces`
    bounces, 1 spp, every parameter group trainable, Adam against a target
    rendered with the albedos moved (x0.8)."""
    from pim_tpu_torch.app import SUN_DIR, SUN_LUM, bench_camera
    from pim_tpu_torch.render import diff

    meta, arrays, lights = scene
    cam = bench_camera("e1m1" if meta.has_sky else "cornell", width, height)
    params = diff.extract_params(meta, arrays, cam, sun_dir=SUN_DIR, sun_lum=(SUN_LUM,) * 3)
    render = diff.make_render_fn(meta, width, height, bounces, sky_steps=sky_steps)
    with torch.no_grad():
        target, _ = render(params._replace(mat_albedo=params.mat_albedo * 0.8), arrays, lights,
                           cam, seed)
    init, step = diff.make_train_step(meta, width, height, bounces, sky_steps=sky_steps)
    opt = init(params)
    with recorded_calls() as calls:
        step(params, opt, arrays, lights, cam, target, seed)
    return calls


def serving_step_calls(scene, width: int = 512, height: int = 512, bounces: int = 10) -> dict:
    """The K6 calls (`recorded_calls`) of one 1-spp step of the e1m1 bench
    camera at width x height, `bounces` bounces."""
    from pim_tpu_torch.app import bench_camera, render_step

    with recorded_calls() as calls:
        render_step(scene, bench_camera("e1m1", width, height), width, height, bounces, 1, 0)
    return calls


def sum_bound(bwd_plain, g, idx, t) -> torch.Tensor:
    """The error bound of a float32 sum in any order, per output of the
    scatter-add `bwd_plain`: gamma(adds - 1) * sum |g|, gamma(k) = k u /
    (1 - k u), u = 2^-24."""
    ku = torch.clamp_min(bwd_plain(torch.ones_like(g, dtype=torch.float64), idx, t) - 1.0,
                         0.0) * 2.0 ** -24
    return ku / (1.0 - ku) * bwd_plain(g.abs().double(), idx, t)


def scatter_error(out, bwd_plain, g, idx, t):
    """(whether `out`, a scatter-add of g at idx into t columns, lies within
    `sum_bound` of the float64 plain sum everywhere; its largest absolute
    error; its largest error over the bound)."""
    err = (out.double() - bwd_plain(g.double(), idx, t)).abs()
    bound = sum_bound(bwd_plain, g, idx, t)
    ok = bool((err <= bound).all())
    return ok, float(err.max()), float((err / torch.clamp_min(bound, 1e-300)).max())


def lane_counts(g, idx) -> dict:
    """A K3-bwd call's lanes: all, at index 0, with an all-zero gradient
    column, and both."""
    zero = ~(g != 0).any(dim=0)
    at0 = idx == 0
    return {"lanes": int(idx.numel()), "idx0": int(at0.sum()), "g0": int(zero.sum()),
            "idx0_g0": int((at0 & zero).sum())}


def index_add_call(g, idx, t):
    """fn() running one `index_add_` that computes gather_cols_bwd(g, idx,
    t) (lanes outside [0, t) moved to column 0 with a zero gradient)."""
    ok = (idx >= 0) & (idx < t)
    idx_in = torch.where(ok, idx, 0).to(torch.int64)
    g_in = torch.where(ok[None, :], g, 0.0)
    buf = torch.zeros((g.shape[0], t), dtype=torch.float32, device=g.device)
    return lambda: buf.index_add_(1, idx_in, g_in)


def texel_index_add_call(g, idx, t):
    """fn() running one `index_add_` that computes gather_texels_bwd(g,
    idx, t)."""
    c = g.shape[0]
    idx_in = idx.clamp(0, t - 1).to(torch.int64).reshape(-1)
    g_flat = g.reshape(c, -1)
    buf = torch.zeros((c, t), dtype=torch.float32, device=g.device)
    return lambda: buf.index_add_(1, idx_in, g_flat)


def embedding_bag_call(planes, idx, tx, ty, valid, c: int):
    """fn() running one `embedding_bag` (sum, per-sample weights) over the
    four corner rows of row-major planes, weighted by the sanitised weights
    (0 where the query is invalid): gather_bilinear's function as [K*N, C]."""
    t = planes.shape[1]
    i = idx.clamp(0, t - 1).to(torch.int64).reshape(-1)
    idx4 = torch.stack([i, i + t, i + 2 * t, i + 3 * t], dim=1)
    ok = valid.reshape(-1)
    tx_v = torch.where(ok, tx.reshape(-1), 0.0)
    ty_v = torch.where(ok, ty.reshape(-1), 0.0)
    w = torch.stack([torch.where(ok, (1.0 - tx_v) * (1.0 - ty_v), 0.0), tx_v * (1.0 - ty_v),
                     (1.0 - tx_v) * ty_v, tx_v * ty_v], dim=1)
    planes_t = planes.reshape(4, c, t).permute(0, 2, 1).reshape(4 * t, c).contiguous()
    return lambda: torch.nn.functional.embedding_bag(idx4, planes_t, per_sample_weights=w,
                                                     mode="sum")
