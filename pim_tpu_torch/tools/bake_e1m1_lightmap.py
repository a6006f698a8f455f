"""The full-map e1m1 progressive lightmap bake on the card, end to end.

Counterpart of tools/bake_e1m1_lightmap.py.  It packs e1m1's 81,552
triangles at the release density (4 texels/m: a 1024^2 atlas with 87,159
live texels), builds the map with the same sun and 32^2 sky, and bakes over
a compacted view of the live texels: the shelf-packed atlas is ~8% live,
so the view gathers the live texels once (padded to whole chunks of
min(2^18, max(2^12, the next power of two of the live count)) lanes; the
padding lanes are dead) and each frame bakes it chunk by chunk, 4 bounces.
The bake keys each texel's RNG by its index in the compacted view, as the
reference tool's code does (one of its comments says it keys them by atlas
index; the code does not: ROADMAP F12).  Mid-run it saves the atlas to a
crate, loads it and continues, and requires the continuation to equal the
one in memory bit for bit.  It prints ms a bake frame and Mtexel-samples/s
over the live texels, then writes the crate and a DenoiseType.Lightmap
preview of the irradiance atlas under build/ (never over the committed
data/e1m1/lmpack.npz).

    python -m pim_tpu_torch.tools.bake_e1m1_lightmap [--frames 64] [--density 4]
"""

from __future__ import annotations

import argparse
import os
import time
from dataclasses import dataclass

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
OUT_DIR = os.path.join(ROOT, "build", "e1m1_lightmap")
BOUNCES = 4
CRATE_KEY = "e1m1_lmpack"


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


@dataclass
class Compacted:
    """The dense view of a pack's live texels, in chunks of `chunk` lanes."""
    live_idx: torch.Tensor  # [n_live] atlas indices of the live texels
    lidx: torch.Tensor      # [n_pad] the view's atlas indices (padding repeats texel 0)
    pad_dead: torch.Tensor  # [n_pad] 1 on live lanes, 0 on padding
    chunk: int

    @staticmethod
    def of(pack) -> "Compacted":
        counts = pack.sample_counts.cpu().numpy()
        live_idx = np.nonzero(counts > 0)[0]
        n = len(live_idx)
        chunk = min(1 << 18, max(1 << 12, 1 << int(np.ceil(np.log2(n)))))
        n_pad = -(-n // chunk) * chunk
        pad_dead = np.zeros(n_pad, np.float32)
        pad_dead[:n] = 1.0
        dev = pack.sample_counts.device
        return Compacted(torch.from_numpy(live_idx).to(dev),
                         torch.from_numpy(np.pad(live_idx, (0, n_pad - n))).to(dev),
                         torch.from_numpy(pad_dead).to(dev), chunk)

    @property
    def n_live(self) -> int:
        return int(self.live_idx.shape[0])

    def compact(self, pack):
        return pack._replace(position=pack.position[:, self.lidx],
                             normal=pack.normal[:, self.lidx], probes=pack.probes[self.lidx],
                             sample_counts=pack.sample_counts[self.lidx] * self.pad_dead)

    def scatter_back(self, full, dense):
        n = self.n_live
        probes = full.probes.clone()
        probes[self.live_idx] = dense.probes[:n]
        counts = full.sample_counts.clone()
        counts[self.live_idx] = dense.sample_counts[:n]
        return full._replace(probes=probes, sample_counts=counts)


def bake_frame(scene, view: Compacted, dense, frame: int, bounces: int = BOUNCES):
    """One bake pass over the compacted view, chunk by chunk."""
    from pim_tpu_torch.render import lightmap as lm

    meta, arrays, lights = scene
    for off in range(0, int(view.lidx.shape[0]), view.chunk):
        dense = lm.bake_step(meta, arrays, lights, dense, frame, max_bounces=bounces,
                             texel_offset=off, texel_count=view.chunk)
    return dense


def preview(pack, path: str) -> tuple:
    """The denoised (DenoiseType.Lightmap) irradiance atlas, Reinhard-mapped
    and cropped to the occupied shelf rows, as a PNG; returns its (width,
    height)."""
    from pim_tpu_torch.render.denoise import DenoiseType, denoise
    from pim_tpu_torch.render.lightmap import lightmap_irradiance
    from pim_tpu_torch.render.screenshot import write_png

    s = pack.size
    nrm = pack.normal.T.contiguous()
    irr = lightmap_irradiance(pack, nrm).reshape(s, s, 3)
    den = denoise(DenoiseType.Lightmap, s, s, irr, torch.ones_like(irr), nrm.reshape(s, s, 3))
    img = (den / (1.0 + den)).cpu().numpy()
    occ = (pack.sample_counts > 0).reshape(s, s).cpu().numpy()
    rows = np.nonzero(occ.any(axis=1))[0]
    img = img[: int(rows.max()) + 1 if rows.size else s]
    rgb8 = np.clip(np.power(np.clip(img, 0, 1), 1 / 2.2) * 255 + 0.5, 0, 255).astype(np.uint8)
    write_png(path, rgb8)
    return rgb8.shape[1], rgb8.shape[0]


def bake(scene, pack, frames: int, out_dir: str = OUT_DIR, bounces: int = BOUNCES,
         log=print) -> dict:
    """Bake `frames` passes (at least 4) of `pack` over its compacted live
    texels, with the crate resume check after frame 2; returns the baked
    pack, the timings and the paths written."""
    from pim_tpu_torch.core.crate import Crate
    from pim_tpu_torch.render import lightmap as lm

    if frames < 4:
        raise ValueError("frames: the bake needs 4 (warm-up, a timed frame, the resume check, "
                         "a timed run)")
    dev = pack.position.device
    view = Compacted.of(pack)
    n_live = view.n_live
    log(f"compacted view: {n_live} live texels in {int(view.lidx.shape[0]) // view.chunk} "
        f"chunk(s) of {view.chunk} lanes, {bounces} bounces")

    dense = bake_frame(scene, view, view.compact(pack), 0, bounces)  # warm-up
    _sync(dev)
    t0 = time.perf_counter()
    dense = bake_frame(scene, view, dense, 1, bounces)
    _sync(dev)
    frame_s = time.perf_counter() - t0
    log(f"bake frame: {frame_s * 1e3:.3f} ms for {n_live} live texels "
        f"({n_live / frame_s / 1e6:.4f} Mtexel-samples/s)")

    # mid-run crate resume: save -> load -> continue equals continuing in memory
    os.makedirs(out_dir, exist_ok=True)
    crate_path = os.path.join(out_dir, "lmpack.crate")
    crate = Crate()
    crate.set(CRATE_KEY, lm.lmpack_to_crate_entry(view.scatter_back(pack, dense)))
    crate.save(crate_path)
    loaded = lm.lmpack_from_crate_entry(Crate.load(crate_path).get(CRATE_KEY), dev)
    a = bake_frame(scene, view, dense, 2, bounces)
    b = bake_frame(scene, view, view.compact(loaded), 2, bounces)
    same = bool(torch.equal(a.probes[:n_live], b.probes[:n_live])
                and torch.equal(a.sample_counts[:n_live], b.sample_counts[:n_live]))
    log(f"crate resume: bit-identical {same} after save/load/continue")
    if not same:
        raise AssertionError("the resumed bake differs from the one continued in memory")
    dense = a

    _sync(dev)
    t0 = time.perf_counter()
    for f in range(3, frames):
        dense = bake_frame(scene, view, dense, f, bounces)
    _sync(dev)
    run_s = time.perf_counter() - t0
    done = frames - 3
    rate = done * n_live / run_s / 1e6
    log(f"baked {frames} frames: {done} timed in {run_s:.3f} s, {run_s / done * 1e3:.3f} ms a "
        f"frame ({rate:.4f} Mtexel-samples/s over live texels)")

    out = view.scatter_back(pack, dense)
    crate.set(CRATE_KEY, lm.lmpack_to_crate_entry(out))
    crate.save(crate_path)
    png = os.path.join(out_dir, "e1m1_lightmap_preview.png")
    w, h = preview(out, png)
    log(f"wrote {crate_path} and {png} ({w}x{h})")
    return {"pack": out, "n_live": n_live, "chunk": view.chunk, "frame_ms": frame_s * 1e3,
            "run_ms_per_frame": run_s / done * 1e3, "mtexel_samples_per_s": rate,
            "resume_bit_identical": same, "crate": crate_path, "preview": png}


def build(device, density: float = 4.0):
    """(e1m1 scene with its sun and 32^2 sky, its lightmap pack, pack seconds)."""
    from pim_tpu_torch.app import build_e1m1_scene, E1M1_GLTF
    from pim_tpu_torch.geom.entities import flatten
    from pim_tpu_torch.geom.gltf import load_gltf_scene
    from pim_tpu_torch.render import lightmap as lm

    scene = build_e1m1_scene(device)
    ents, _ = load_gltf_scene(E1M1_GLTF)
    flat = flatten(ents)
    t0 = time.perf_counter()
    pack = lm.pack_lightmaps(flat.positions, flat.normals, texels_per_meter=density,
                             device=device)
    return scene, pack, time.perf_counter() - t0


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--frames", type=int, default=64)
    ap.add_argument("--density", type=float, default=4.0)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--out-dir", default=OUT_DIR)
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA device is available")
    scene, pack, pack_s = build(dev, args.density)
    live = int((pack.sample_counts > 0).sum())
    print(f"pack: atlas {pack.size}^2, {pack.size * pack.size} texels ({live} live) at "
          f"{args.density} texels/m in {pack_s:.1f} s")
    bake(scene, pack, args.frames, args.out_dir)


if __name__ == "__main__":
    main()
