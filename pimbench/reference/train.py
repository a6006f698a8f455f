"""The reference of the train traffic (see `pimbench.drivers.train`).

It builds the scene again through the frozen copy (its whole light grid
baked itself, as in `reference.render.build`), takes the scene's
parameters itself, renders its own target from them moved by the same
drawn amounts, and runs the frozen `diff.make_train_step` for the same
set-up steps and sample ids.  Compared: each step's loss; the first
step's gradient norm of each parameter group (the worst group, against the
larger of its reference norm and the median group's); each group's change
over the steps, likewise, leaving out groups whose reference gradient is
under a thousandth of the median group's (they move under Adam by rounding
alone).  Then the window's last step: the reference runs it once from the
program's parameters and optimizer state before it (the one step it
cannot reach by itself) and compares its loss, its gradient norms and the
change it makes, by the same rules (`last_*`).

Control (`control=True`): the reference one precision lower (its geometry
in bfloat16) in the program's place.
"""

from __future__ import annotations

import statistics
import sys
import time

import torch

from pimbench import scenes

# [lo, hi) of each drawn scale; the offsets are fixed (chip_smoke.py's)
PERTURB_KEYS = ("albedo_scale", "rome_scale", "atlas_scale", "sun_lum_scale")


def perturbation(seed: int, tr: dict) -> dict:
    """The amounts the target's parameters are moved by, drawn from the
    seed within the traffic's ranges (the same sizes for every seed)."""
    from pimbench.drivers.common import generator
    g = generator(seed, 3)
    out = dict(tr["perturb"])
    for k in PERTURB_KEYS:
        lo, hi = tr["perturb"][k]
        out[k] = lo + (hi - lo) * float(torch.rand((), generator=g, dtype=torch.float64))
    return out


def perturb(params, d: dict):
    """Target parameters: every group moved off the scene's (either side's
    DiffParams)."""
    dev = params.sun_dir.device
    off = torch.tensor(d["sun_dir_offset"], dtype=torch.float32, device=dev)
    eye = torch.tensor(d["eye_offset"], dtype=torch.float32, device=dev)
    return params._replace(
        mat_albedo=torch.clamp(params.mat_albedo * d["albedo_scale"] + d["albedo_offset"],
                               0.0, 1.0),
        mat_rome=torch.clamp(params.mat_rome * d["rome_scale"] + d["rome_offset"], 0.0, 1.0),
        atlas_planes=params.atlas_planes * d["atlas_scale"],
        sun_dir=params.sun_dir + off,
        sun_lum=params.sun_lum * d["sun_lum_scale"],
        cam_eye=params.cam_eye + eye)


def sun(cfg: dict):
    """(sun_dir, sun_lum) of the configuration's sky, else the defaults of
    `diff.extract_params`."""
    sky = cfg["scene"].get("sky")
    if sky is None:
        return (0.0, 1.0, 0.0), (1.0, 1.0, 1.0)
    return tuple(sky["sun_dir"]), (float(sky["sun_lum"]),) * 3


def _norms(ts):
    return [float(t.double().norm()) for t in ts]


def follow(cfg, tr, seed: int, sample, scene, steps: int, last: dict):
    """The frozen train step on `scene`: (losses, first gradient norms,
    change norms) of its first `steps` steps, and (loss, gradient norms,
    change norms) of one step from the state `last` (the parameters and
    the optimizer's state before the window's last step, and its number
    `k`)."""
    from pimbench.reference.frozen.render import diff

    meta, arrays, lights = scene
    w, h = int(cfg["width"]), int(cfg["height"])
    bounces, sky_steps = int(tr["bounces"]), int(tr["sky_steps"])
    cam = scenes.camera(cfg, "reference")
    sun_dir, sun_lum = sun(cfg)
    params = diff.extract_params(meta, arrays, cam, sun_dir=sun_dir, sun_lum=sun_lum)
    render = diff.make_render_fn(meta, w, h, bounces, sky_steps)
    with torch.no_grad():
        target, _ = render(perturb(params, perturbation(seed, tr)), arrays, lights, cam,
                           sample(-1))
    init, step = diff.make_train_step(meta, w, h, bounces, sky_steps,
                                      float(tr["learning_rate"]))
    opt = init(params)
    start = [p.detach().clone() for p in params]
    losses, grads = [], None
    t0 = time.perf_counter()
    for k in range(steps):
        loss, params, opt = step(params, opt, arrays, lights, cam, target, sample(k))
        losses.append(float(loss))
        print(f"# reference train step {k}: {time.perf_counter() - t0:.3f} s", file=sys.stderr)
        if k == 0:
            grads = _norms(p.grad for p in params)
    changes = _norms(p.detach() - s for p, s in zip(params, start))

    params = type(params)(*[p.detach().clone() for p in last["params"]])
    opt = init(params)
    for p, state in zip(params, last["opt"]):
        if state:
            opt.state[p] = {key: v.clone() for key, v in state.items()}
    loss, params, opt = step(params, opt, arrays, lights, cam, target, sample(last["k"]))
    print(f"# reference train step {last['k']} (the window's last): "
          f"{time.perf_counter() - t0:.3f} s", file=sys.stderr)
    one = (float(loss), _norms(p.grad for p in params),
           _norms(p.detach() - s for p, s in zip(params, last["params"])))
    return (losses, grads, changes), one


def leaf_gap(prog, ref, keep=None) -> float:
    """The worst leaf's |prog - ref| over the larger of its reference norm
    and the median leaf's."""
    med = statistics.median(ref)
    idx = range(len(ref)) if keep is None else keep
    gaps = [abs(prog[i] - ref[i]) / max(ref[i], med, 1e-30) for i in idx]
    return max(gaps) if gaps else 0.0


def check(cfg, tr, seed: int, drv, prog: dict, dev, control: bool = False):
    """[(name, value, limit)] of the train check (module docstring)."""
    from pimbench.reference.render import build, control_scene, grid_gap, grid_state

    limits = tr["limits"]
    scene = build(cfg, dev)
    ref_grid = grid_state(*scene[1:])
    steps = len(prog["losses"])
    ref, ref_last = follow(cfg, tr, seed, drv.sample, scene, steps, prog["last"])
    got = (prog["losses"], prog["grad_norms"], prog["change_norms"])
    got_last = (prog["last"]["loss"], prog["last"]["grad_norms"], prog["last"]["change_norms"])
    grid = grid_gap(prog["grid"], ref_grid)
    if control:
        low = control_scene(scene)
        got, got_last = follow(cfg, tr, seed, drv.sample, low, steps, prog["last"])
        grid = grid_gap(grid_state(*low[1:]), ref_grid)

    def moved(grads):
        med = statistics.median(grads)
        return [i for i, g in enumerate(grads) if g >= 1e-3 * med]

    loss_gap = max(abs(p - r) / max(abs(r), 1e-30) for p, r in zip(got[0], ref[0]))
    return [("loss_gap", loss_gap, limits["loss_gap"]),
            ("grad_gap", leaf_gap(got[1], ref[1]), limits["grad_gap"]),
            ("update_gap", leaf_gap(got[2], ref[2], moved(ref[1])), limits["update_gap"]),
            ("last_loss_gap", abs(got_last[0] - ref_last[0]) / max(abs(ref_last[0]), 1e-30),
             limits["last_loss_gap"]),
            ("last_grad_gap", leaf_gap(got_last[1], ref_last[1]), limits["last_grad_gap"]),
            ("last_update_gap", leaf_gap(got_last[2], ref_last[2], moved(ref_last[1])),
             limits["last_update_gap"]),
            ("grid_gap", grid, limits["grid_gap"])]
