"""Sample-to-sample decorrelation of the integrator on the Cornell box.

    python -m pim_tpu_torch.tools.corr_check [--device cuda|cpu]

Counterpart of `tools/corr_check.py`.  Traces SAMPLES one-sample images
(sample ids 0 .. SAMPLES - 1) of the Cornell box at RES^2 through
`integrator.trace_rays` and prints the largest and mean off-diagonal
correlation of their deviations from the per-pixel mean (near 0 when the
samples' RNG streams are independent), the image's max and 99.9th
percentile, and, raw and with the radiance clipped at 5, the ratio of the
variance of single samples to that of 4-sample means (near 4 for
independent samples).
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

RES = 24
BOUNCES = 4
SAMPLES = 16
CLIP = 5.0


def images(scene, res: int = RES, bounces: int = BOUNCES, samples: int = SAMPLES) -> np.ndarray:
    """[samples, res * res, 3] one-sample images of `scene` (Cornell)."""
    from pim_tpu_torch.app import bench_camera
    from pim_tpu_torch.core import rng
    from pim_tpu_torch.render.camera import generate_primary_rays
    from pim_tpu_torch.render.integrator import trace_rays

    meta, arrays, lights = scene
    cam = bench_camera("cornell", res, res)
    pix = torch.arange(res * res, device=arrays.tri_table.device)
    out = []
    for s in range(samples):
        state = rng.make_state(pix, s)
        state, ro, rd = generate_primary_rays(cam, res, res, state)
        out.append(trace_rays(meta, arrays, lights, ro, rd, state, bounces).color.cpu().numpy())
    return np.stack(out)


def statistics(imgs: np.ndarray) -> dict:
    """The decorrelation statistics of [S, N, 3] images (S a multiple of 4,
    at least 16)."""
    s = imgs.shape[0]
    flat = imgs.reshape(s, -1).astype(np.float64)
    dev = flat - flat.mean(axis=0, keepdims=True)
    off = np.corrcoef(dev)[~np.eye(s, dtype=bool)]
    out = {"max_abs_offdiag_corr": float(np.abs(off).max()),
           "mean_offdiag_corr": float(off.mean()), "img_max": float(imgs.max()),
           "p999": float(np.percentile(imgs, 99.9))}
    for tag, im in (("raw", imgs), (f"clip{CLIP:g}", np.clip(imgs, 0.0, CLIP))):
        singles = im[:4]
        means4 = np.stack([im[4 * g : 4 * g + 4].mean(axis=0) for g in range(4)])
        vs = float(np.var(singles, axis=0).mean())
        vm = float(np.var(means4, axis=0).mean())
        out[tag] = {"var_single": vs, "var_mean4": vm, "ratio": vs / max(vm, 1e-12)}
    return out


def report(st: dict) -> str:
    lines = [f"max |offdiag corr| {st['max_abs_offdiag_corr']:.3f}  mean "
             f"{st['mean_offdiag_corr']:.4f}",
             f"img max value {st['img_max']:.1f}, 99.9pct {st['p999']:.2f}"]
    for tag in ("raw", f"clip{CLIP:g}"):
        v = st[tag]
        lines.append(f"{tag}: var_single {v['var_single']:.4f}  var_mean4 {v['var_mean4']:.4f}  "
                     f"ratio {v['ratio']:.2f}")
    return "\n".join(lines)


def main(argv=None) -> int:
    from pim_tpu_torch.app import build_cornell_scene, check_device

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    check_device(device)
    print(report(statistics(images(build_cornell_scene(device)))))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
