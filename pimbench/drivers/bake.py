"""The shell's `lm_gen` pass: progressive SG lightmap bake passes over the
whole lightmap pack, with the shell's cvars (`lm_timeslice` 1, `lm_spp`
1, `lm_density` texels a metre) and the configuration's bounces (the
shell's `pt_max_bounces`).

Set-up builds the scene and packs the lightmap (`lightmap.pack_lightmaps`,
as `lm_gen` packs it on its first frame).  Pass i is `lightmap.bake_step`
over every texel with bake frame first_frame + i (the RNG streams are
keyed by texel and frame); first_frame is the run's seed.

The check (after the window): the pack at a sample of live texels drawn
from the seed against the reference's own pack (position, normal, sample
count); the first and the last pass at those texels recomputed by the
reference from the state before each (`probes_off`).
"""

from __future__ import annotations

import torch

from pimbench import scenes
from pimbench.drivers import common


class Bake:
    def __init__(self, cell, seed: int, dev):
        from pim_tpu_torch.geom.entities import flatten
        from pim_tpu_torch.render import lightmap as lm

        self.cfg, self.tr, self.dev = cell.config, cell.traffic, dev
        self.seed = seed
        self.first_frame = common.seed32(seed)
        self.bounces = int(self.cfg["bounces"])
        self.trace_steps = int(self.tr["trace_steps"])

        def build():
            ents = scenes.entities(self.cfg, "program")
            scene = scenes.build(self.cfg, dev, "program", ents=ents)
            flat = flatten(ents[0])
            pack = lm.pack_lightmaps(flat.positions, flat.normals,
                                     texels_per_meter=float(self.tr["texels_per_meter"]),
                                     device=dev)
            return scene, pack

        (self.scene, self.pack0), self.scene_build_s = common.timed(build, dev)
        live = torch.nonzero(self.pack0.sample_counts > 0.0).flatten().cpu()
        g = common.generator(seed, 4)
        p = min(int(self.tr["check_texels"]), live.numel())
        self.texels = torch.sort(live[torch.randperm(live.numel(), generator=g)[:p]]).values
        self.texels = self.texels.to(dev)
        self.live_texels = int(live.numel())
        for i in range(int(self.tr["warmup_steps"])):
            self._pass(self.pack0, i)
        common.sync(dev)
        self.pack = self.pack0
        self.first = None
        self.steps = 0

    def _pass(self, pack, i: int):
        from pim_tpu_torch.render import lightmap as lm

        meta, arrays, lights = self.scene
        return lm.bake_step(meta, arrays, lights, pack, self.first_frame + i,
                            max_bounces=self.bounces)

    def step(self, i: int) -> None:
        before = self.pack
        self.pack = self._pass(before, i)
        if i == 0:
            self.first = self.pack
        self.before_last = before
        self.steps = i + 1

    def end_to_end(self, w) -> dict:
        return {"bake_mtexels_per_s": self.live_texels * w.steps / w.wall_s / 1e6}

    def check(self, control: bool = False):
        from pimbench.reference import bake as B

        meta, arrays, lights = self.scene
        tx = self.texels
        last = self.steps - 1

        def at(pack):
            return {"probes": pack.probes[tx].clone(), "counts": pack.sample_counts[tx].clone()}

        prog = {
            "passes": self.steps,
            "first_frame": self.first_frame,
            "pack0": {"position": self.pack0.position[:, tx].clone(),
                      "normal": self.pack0.normal[:, tx].clone(),
                      "counts": self.pack0.sample_counts[tx].clone(), "size": self.pack0.size},
            "after": {0: at(self.first), last: at(self.pack)},
            "before": {0: at(self.pack0), last: at(self.before_last)},
            "grid": common.grid_state(arrays, lights),
        }
        del self.scene, self.pack, self.pack0, self.first, self.before_last, meta, arrays, lights
        common.free(self.dev)
        return B.check(self.cfg, self.tr, tx, prog, self.dev, control=control)


def setup(cell, seed: int, dev) -> Bake:
    return Bake(cell, seed, dev)
