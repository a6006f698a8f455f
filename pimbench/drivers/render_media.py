"""Progressive 1-sample render steps through a participating medium.

`drivers.render`'s loop (each step `render_system.trace_samples`, then
`integrator.accumulate`, then the exposure pass where the traffic and the
configuration ask for it) on a scene built with the configuration's
medium: `scene.build_scene(..., media_enabled=True, media=<its MediaDesc>)`,
which the scene carries to the integrator through `trace_samples`.  The
medium is every field of `render/media.py:make_media_desc`, written out
under the configuration's `media`.

The check is `drivers.render`'s, with the reference's scene built with the
same medium (`reference/render_media.py`).
"""

from __future__ import annotations

import torch

from pimbench import scenes
from pimbench.drivers import common, render


class RenderMedia(render.Render):
    def __init__(self, cell, seed: int, dev):
        from pim_tpu_torch.render.media import make_media_desc

        self.cfg, self.tr, self.dev = cell.config, cell.traffic, dev
        if self.cfg.get("exposure") and self.tr.get("exposure", False):
            raise ValueError("render_media: the reference's media check has no exposure pass")
        self.w, self.h = int(self.cfg["width"]), int(self.cfg["height"])
        self.bounces = int(self.cfg["bounces"])
        self.spp = int(self.tr["spp"])
        self.seed = seed
        self.seed32 = common.seed32(seed)
        self.trace_steps = int(self.tr["trace_steps"])
        self.exp_params = self.exp_dt = None
        self.medium = make_media_desc(**self.cfg["media"])

        self.scene, self.scene_build_s = common.timed(
            lambda: scenes.build(self.cfg, dev, "program", media_enabled=True,
                                 media=self.medium), dev)
        self.cam = scenes.camera(self.cfg, "program")

        g = common.generator(seed, 1)
        n = self.w * self.h
        p = min(int(self.tr["check_pixels"]), n)
        self.pix = torch.sort(torch.randperm(n, generator=g)[:p]).values.to(dev)
        self.early = int(torch.randint(0, int(self.tr["check_early_steps"]), (1,),
                                       generator=g))
        for i in range(int(self.tr["warmup_steps"])):
            self._trace(i)
        common.sync(dev)
        self._reset()

    def check(self, control: bool = False):
        from pimbench.reference import render_media as R

        last_i, last_color, _ = self.last
        self.full[last_i] = (last_color, None)
        steps = sorted(self.full)
        meta, arrays, lights = self.scene
        prog = {
            "steps": steps,
            "values": {i: self.kept[i] for i in steps},
            "kept": torch.stack(self.kept),
            "accum": torch.cat([self.bufs.color, self.bufs.albedo, self.bufs.normal],
                               dim=1)[self.pix],
            "grid": common.grid_state(arrays, lights),
        }
        del self.scene, self.bufs, self.full, self.last, self.kept, meta, arrays, lights
        common.free(self.dev)
        return R.check(self.cfg, self.tr, self.seed32, self.pix, prog, self.dev,
                       control=control)


def setup(cell, seed: int, dev) -> RenderMedia:
    return RenderMedia(cell, seed, dev)
