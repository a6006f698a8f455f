"""AD against central finite differences for the roughness gradient, over an eps ladder.

    python -m pim_tpu_torch.tools.grad_eps_sweep [--device cuda|cpu]

Counterpart of `tools/grad_eps_sweep.py`.  On the Cornell box at RES^2,
BOUNCES bounces, sample SEED, through `render/diff.py::make_loss_fn` (L2
against a black target): the directional derivative of the loss along
the roughness column of every material (`mat_rome[:, 0]`) by autograd, and
central differences (L(p + eps d) - L(p - eps d)) / 2 eps at each eps of
LADDER.  Roughness moves the sampled GGX direction, so a large eps can
step over a kink and a small one drowns in float32 rounding; the ladder
shows where the two meet.
"""

from __future__ import annotations

import argparse

import torch

RES = 16
BOUNCES = 3
SEED = 7
LADDER = (2e-3, 5e-4, 1e-4, 2e-5, 5e-6)


def sweep(scene, res: int = RES, bounces: int = BOUNCES, seed: int = SEED,
          ladder=LADDER) -> dict:
    """{"ad": autograd's derivative, "fd": [(eps, central difference)]} on
    a built Cornell scene."""
    from pim_tpu_torch.app import bench_camera
    from pim_tpu_torch.render.diff import extract_params, make_loss_fn

    meta, arrays, lights = scene
    cam = bench_camera("cornell", res, res)
    params = extract_params(meta, arrays, cam)
    loss = make_loss_fn(meta, res, res, max_bounces=bounces)
    target = torch.zeros((res * res, 3), dtype=torch.float32, device=arrays.tri_table.device)
    d = torch.zeros_like(params.mat_rome)
    d[:, 0] = 1.0

    rome = params.mat_rome.clone().requires_grad_(True)
    value, _ = loss(params._replace(mat_rome=rome), arrays, lights, cam, target, seed)
    (grad,) = torch.autograd.grad(value, rome)
    ad = float(torch.sum(grad * d))
    fd = []
    with torch.no_grad():
        for eps in ladder:
            lp = float(loss(params._replace(mat_rome=params.mat_rome + eps * d), arrays, lights,
                            cam, target, seed)[0])
            lm = float(loss(params._replace(mat_rome=params.mat_rome - eps * d), arrays, lights,
                            cam, target, seed)[0])
            fd.append((eps, (lp - lm) / (2.0 * eps)))
    return {"ad": ad, "fd": fd}


def main(argv=None) -> int:
    from pim_tpu_torch.app import build_cornell_scene, check_device

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    check_device(device)
    r = sweep(build_cornell_scene(device))
    print(f"AD {r['ad']:+.6f}")
    for eps, fd in r["fd"]:
        print(f"eps {eps:.0e}: FD {fd:+.6f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
