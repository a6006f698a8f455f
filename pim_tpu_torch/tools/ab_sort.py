"""A/B of the ray sort on the e1m1 map: sorted against unsorted cluster traces.

    python -m pim_tpu_torch.tools.ab_sort [--res 128] [--device cuda|cpu]

Counterpart of `tools/ab_sort.py`.  Builds e1m1 (the cluster backend) and
traces one RES^2, BOUNCES-bounce sample with `sort_rays=False` and with
`sort_rays=True` (`dataclasses.replace` of the scene's meta): after one
warm-up step of each, ROUNDS rounds in turns (unsorted first
in even rounds, sorted first in odd ones), each side ITERS steps of the
same sample timed by the host clock with one sync at the end; ms a step is
the median over the rounds.  It prints that, the rays traced and the image
mean of each.  K4 and K5 cull by each ray's own slab tests, so a sort only
reorders the rays a kernel is handed: the images and ray counts must be bit
for bit equal, and the exit code is 1 when they are not.
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import torch

RES = 128
BOUNCES = 10
ITERS = 5
ROUNDS = 4


def run(scene, device: torch.device, res: int = RES, bounces: int = BOUNCES,
        iters: int = ITERS, rounds: int = ROUNDS, scene_name: str = "e1m1") -> dict:
    """The A/B on a built scene (meta, arrays, lights) seen from the bench
    camera of `scene_name`: per side its ms a step (median over rounds and
    each round's), rays traced and image mean, and whether the two images
    and ray counts are bit for bit equal."""
    import statistics

    from pim_tpu_torch.app import bench_camera, render_step, sync

    meta, arrays, lights = scene
    cam = bench_camera(scene_name, res, res)
    sides = {tag: (dataclasses.replace(meta, sort_rays=sort), arrays, lights)
             for tag, sort in (("nosort", False), ("sort", True))}
    out = {tag: {"rounds_ms": []} for tag in sides}
    for tag, side in sides.items():
        res_ = render_step(side, cam, res, res, bounces, 1, 0)
        out[tag].update(color=res_.color.cpu(), rays=float(res_.rays_traced),
                        mean=float(res_.color.mean()))
    for r in range(rounds):
        for tag in (("nosort", "sort") if r % 2 == 0 else ("sort", "nosort")):
            t0 = time.perf_counter()
            for _ in range(iters):
                render_step(sides[tag], cam, res, res, bounces, 1, 0)
            sync(device)
            out[tag]["rounds_ms"].append((time.perf_counter() - t0) / iters * 1e3)
    for v in out.values():
        v["ms"] = statistics.median(v["rounds_ms"]) if v["rounds_ms"] else float("nan")
    a, b = out["nosort"], out["sort"]
    diff = (a["color"] - b["color"]).abs()
    return {
        "scene": scene_name, "res": res, "bounces": bounces, "iters": iters,
        "rounds": rounds, "tris": meta.tri_count, "backend": meta.backend,
        **{f"{tag}_{k}": v[k] for tag, v in out.items()
           for k in ("ms", "rounds_ms", "rays", "mean")},
        "rays_equal": a["rays"] == b["rays"],
        "images_equal": bool(torch.equal(a["color"].view(torch.int32),
                                         b["color"].view(torch.int32))),
        "max_abs_diff": float(diff.max()), "pixels_differing": int((diff > 0).any(-1).sum()),
        "sort_gain": (a["ms"] - b["ms"]) / a["ms"],
    }


def report(r: dict, card: str = "") -> str:
    return (f"ab_sort {r['scene']} {r['res']}^2 {r['bounces']} bounces ({r['tris']} tris, "
            f"{r['backend']}): nosort {r['nosort_ms']:.3f} ms/step "
            f"{[round(x, 3) for x in r['nosort_rounds_ms']]}, sort {r['sort_ms']:.3f} ms/step "
            f"{[round(x, 3) for x in r['sort_rounds_ms']]} (sort saves {r['sort_gain']:+.4f} "
            f"of the unsorted step); rays "
            f"{r['nosort_rays']:.0f} / {r['sort_rays']:.0f} equal {r['rays_equal']}; images "
            f"equal {r['images_equal']} (max |diff| {r['max_abs_diff']:.3g}, "
            f"{r['pixels_differing']} pixels); means {r['nosort_mean']:.6f} / "
            f"{r['sort_mean']:.6f}" + (f" [{card}]" if card else ""))


def main(argv=None) -> int:
    from pim_tpu_torch.app import build_e1m1_scene, card, check_device

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--res", type=int, default=RES)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    check_device(device)
    r = run(build_e1m1_scene(device), device, args.res)
    print(report(r, ", ".join(str(c) for c in card(device))))
    return 0 if r["images_equal"] and r["rays_equal"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
