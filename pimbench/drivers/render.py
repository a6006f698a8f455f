"""Progressive 1-sample render steps, as the port's shell frames (`pt_spp`).

Each step is `render_system.trace_samples` (the port's `app.render_step`
with the run's RNG seed): `spp` one-sample traces of every pixel with
sample ids step*spp .. step*spp + spp-1, `bounces` bounces; then
`integrator.accumulate` into the progressive buffers with weight
1/(step+1); where the traffic and the configuration ask for it, the
histogram auto-exposure of the step's image (`exposure.exposure_pass`, a
fresh state, as the port's bench runs it).

The check (after the window): a sample of pixels drawn from the seed,
traced again by the reference for two of the window's steps (one drawn
from the seed among the first ones, and the last), compared value by
value (color, albedo and normal AOVs); the accumulated buffers at those
pixels against the reference's accumulation of the program's step values;
the exposure of those two steps against the reference's exposure of the
program's images; and the program's whole light grid against the one the
reference bakes itself.
"""

from __future__ import annotations

import torch

from pimbench import scenes
from pimbench.drivers import common


class Render:
    def __init__(self, cell, seed: int, dev):
        from pim_tpu_torch.render.exposure import ExposureParams

        self.cfg, self.tr, self.dev = cell.config, cell.traffic, dev
        self.w, self.h = int(self.cfg["width"]), int(self.cfg["height"])
        self.bounces = int(self.cfg["bounces"])
        self.spp = int(self.tr["spp"])
        self.seed = seed
        self.seed32 = common.seed32(seed)
        self.trace_steps = int(self.tr["trace_steps"])
        exp = self.cfg.get("exposure") if self.tr.get("exposure", False) else None
        self.exp_params = ExposureParams(**exp["params"]) if exp else None
        self.exp_dt = float(exp["dt"]) if exp else None

        self.scene, self.scene_build_s = common.timed(
            lambda: scenes.build(self.cfg, dev, "program"), dev)
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

    def _reset(self):
        from pim_tpu_torch.render.integrator import make_trace_buffers

        self.bufs = make_trace_buffers(self.w, self.h, self.dev)
        self.kept = []      # [P, 9] of every step at the sampled pixels
        self.full = {}      # step -> (color [N, 3], exposure state or None)
        self.steps = 0

    def _trace(self, i: int):
        from pim_tpu_torch.render.exposure import exposure_pass, make_exposure_state
        from pim_tpu_torch.render.render_system import trace_samples

        res = trace_samples(self.scene, self.cam, self.w, self.h, self.bounces, self.spp,
                            i * self.spp, seed=self.seed32)
        exp = None
        if self.exp_params is not None:
            exp = exposure_pass(res.color, self.exp_params, make_exposure_state(self.dev),
                                self.exp_dt)
        return res, exp

    def step(self, i: int) -> None:
        from pim_tpu_torch.render.integrator import accumulate

        res, exp = self._trace(i)
        self.bufs = accumulate(self.bufs, res, 1.0 / (i + 1))
        self.kept.append(torch.cat([res.color, res.albedo, res.normal], dim=1)[self.pix])
        if i == self.early:
            self.full[i] = (res.color, exp)
        self.last = (i, res.color, exp)
        self.steps = i + 1

    def end_to_end(self, w) -> dict:
        import statistics

        samples = self.w * self.h * self.spp * w.steps
        ivs = sorted(w.intervals_ms)
        p90 = statistics.quantiles(ivs, n=10, method="inclusive")[8] if len(ivs) > 1 else ivs[0]
        return {"render_msamples_per_s": samples / w.wall_s / 1e6,
                "render_step_ms_p90": p90}

    def check(self, control: bool = False):
        from pimbench.reference import render as R

        last_i, last_color, last_exp = self.last
        self.full[last_i] = (last_color, last_exp)
        steps = sorted(self.full)
        meta, arrays, lights = self.scene
        prog = {
            "steps": steps,
            "values": {i: self.kept[i] for i in steps},
            "kept": torch.stack(self.kept),
            "accum": torch.cat([self.bufs.color, self.bufs.albedo, self.bufs.normal],
                               dim=1)[self.pix],
            "images": {i: self.full[i][0] for i in steps},
            "exposure": {i: (None if self.full[i][1] is None else
                             torch.stack([self.full[i][1].avg_lum, self.full[i][1].exposure]))
                         for i in steps},
            "grid": common.grid_state(arrays, lights),
        }
        del self.scene, self.bufs, self.full, self.last, self.kept, meta, arrays, lights
        common.free(self.dev)
        return R.check(self.cfg, self.tr, self.seed32, self.pix, prog, self.dev,
                       control=control)


def setup(cell, seed: int, dev) -> Render:
    return Render(cell, seed, dev)
