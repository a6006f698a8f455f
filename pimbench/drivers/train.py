"""Inverse rendering: `render/diff.py::make_train_step` (Adam) on the
configuration's scene and camera, every parameter group trainable, the sky
re-baked each step where the scene has one.

Set-up builds the scene, renders the target from parameters moved off the
scene's by amounts drawn from the seed (`reference.train.perturb`, as the
port's chip_smoke.py perturbs them), and drives the one train step object
through its first `set_up_steps` steps (sample ids seed+0, seed+1, ...):
they warm up every shape and are what the reference follows (each step's
loss, the first gradient as the optimizer got it, each group's change over
the steps).  The window goes on with the same object from there; before
each window step the parameters and the optimizer's state are copied
aside, so that the reference can run the window's last step from them and
compare its loss, gradients and update.
"""

from __future__ import annotations

import torch

from pimbench import scenes
from pimbench.drivers import common
from pimbench.reference.train import perturbation, perturb, sun


class Train:
    def __init__(self, cell, seed: int, dev):
        from pim_tpu_torch.render import diff

        self.cfg, self.tr, self.dev = cell.config, cell.traffic, dev
        self.seed = seed
        self.seed32 = common.seed32(seed)
        self.trace_steps = int(self.tr["trace_steps"])
        w, h = int(self.cfg["width"]), int(self.cfg["height"])
        bounces, sky_steps = int(self.tr["bounces"]), int(self.tr["sky_steps"])

        self.scene, self.scene_build_s = common.timed(
            lambda: scenes.build(self.cfg, dev, "program"), dev)
        meta, arrays, lights = self.scene
        self.cam = scenes.camera(self.cfg, "program")
        sun_dir, sun_lum = sun(self.cfg)
        params = diff.extract_params(meta, arrays, self.cam, sun_dir=sun_dir, sun_lum=sun_lum)
        self.pert = perturbation(seed, self.tr)
        render = diff.make_render_fn(meta, w, h, bounces, sky_steps)
        with torch.no_grad():
            self.target, _ = render(perturb(params, self.pert), arrays, lights, self.cam,
                                    self.sample(-1))
        init, self.train_step = diff.make_train_step(
            meta, w, h, bounces, sky_steps, float(self.tr["learning_rate"]))
        self.params = params
        self.opt = init(params)
        start = [p.detach().clone() for p in params]
        self.losses, self.grads = [], None
        self.set_up_steps = int(self.tr["set_up_steps"])
        for k in range(self.set_up_steps):
            self._step(k)
            self.losses.append(self.loss.clone())
            if k == 0:
                self.grads = [p.grad.detach().clone() for p in self.params]
        self.changes = [p.detach() - s for p, s in zip(self.params, start)]
        self.kept = None
        common.sync(dev)

    def sample(self, k: int) -> int:
        return (self.seed32 + 1 + k) & common.MASK32

    def _step(self, k: int) -> None:
        meta, arrays, lights = self.scene
        self.loss, self.params, self.opt = self.train_step(
            self.params, self.opt, arrays, lights, self.cam, self.target, self.sample(k))

    def _keep_state(self, k: int) -> None:
        """Copy the parameters and the optimizer's state before step k into
        buffers of the check's (the reference runs the window's last step
        from them)."""
        if self.kept is None:
            self.kept = {"params": [p.detach().clone() for p in self.params],
                         "opt": [{key: v.clone() for key, v in self.opt.state[p].items()}
                                 for p in self.params]}
        else:
            for b, p in zip(self.kept["params"], self.params):
                b.copy_(p.detach())
            for b, p in zip(self.kept["opt"], self.params):
                for key, v in self.opt.state[p].items():
                    b[key].copy_(v)
        self.kept["k"] = k

    def step(self, i: int) -> None:
        k = self.set_up_steps + i
        self._keep_state(k)
        self._step(k)

    def end_to_end(self, w) -> dict:
        return {"train_step_ms": w.wall_s / w.steps * 1e3}

    def check(self, control: bool = False):
        from pimbench.reference import train as T

        meta, arrays, lights = self.scene
        prog = {
            "losses": [float(x) for x in self.losses],
            "grad_norms": [float(g.double().norm()) for g in self.grads],
            "change_norms": [float(c.double().norm()) for c in self.changes],
            "last": dict(self.kept, loss=float(self.loss),
                         grad_norms=[float(p.grad.double().norm()) for p in self.params],
                         change_norms=[float((p.detach() - b).double().norm())
                                       for p, b in zip(self.params, self.kept["params"])]),
            "grid": common.grid_state(arrays, lights),
        }
        del self.scene, self.params, self.opt, self.target, self.grads, self.changes
        del meta, arrays, lights
        common.free(self.dev)
        return T.check(self.cfg, self.tr, self.seed, self, prog, self.dev, control=control)


def setup(cell, seed: int, dev) -> Train:
    return Train(cell, seed, dev)
