"""Faults planted in the program under test, for the checks' own tests
(`tests/test_faults.py`) and for reading a fault's numbers on the card
(`run.py --fault <name>`); never in a benchmark run.

Each fault replaces one function of the port for the rest of the process:
  unchanged   a step that returns its state unchanged (the progressive
              buffers, the lightmap pack, the parameters);
  half_batch  half of the batch left out, the mean taken over the rest
              (the second half of a step's pixels takes the first half's
              values; every other texel keeps its state; a loss over the
              first half of the pixels);
  altered     an answer altered where it is produced (the traced
              radiance, the baked probes, the loss, scaled by 1.01).
The exchange between chips has no fault here: every cell is one chip.
"""

from __future__ import annotations

import torch

FAULTS = ("unchanged", "half_batch", "altered")


def _halved(x: torch.Tensor) -> torch.Tensor:
    """x [N, ...] with its second half replaced by its first half."""
    h = x.shape[0] // 2
    return torch.cat([x[:h], x[:x.shape[0] - h]], dim=0)


def plant(fault: str) -> None:
    from pim_tpu_torch.render import diff, integrator, lightmap, render_system

    if fault not in FAULTS:
        raise ValueError(f"unknown fault {fault!r}: {FAULTS}")
    trace_samples = render_system.trace_samples
    bake_step = lightmap.bake_step
    make_loss_fn = diff.make_loss_fn

    if fault == "unchanged":
        make_train_step = diff.make_train_step

        def frozen_train_step(*a, **k):
            init, step = make_train_step(*a, **k)

            def init_no_update(params):
                opt = init(params)
                opt.step = lambda closure=None: None  # this optimizer alone
                return opt
            return init_no_update, step
        integrator.accumulate = lambda buffers, result, sample_weight: buffers
        lightmap.bake_step = lambda meta, arrays, lights, pack, *a, **k: pack
        diff.make_train_step = frozen_train_step
        return

    if fault == "half_batch":
        def traced(*a, **k):
            r = trace_samples(*a, **k)
            return r._replace(color=_halved(r.color), albedo=_halved(r.albedo),
                              normal=_halved(r.normal))

        def baked(meta, arrays, lights, pack, frame, *a, **k):
            new = bake_step(meta, arrays, lights, pack, frame, *a, **k)
            n = new.probes.shape[0]
            keep = torch.arange(n, device=new.probes.device) % 2 == 0  # every other texel
            return new._replace(
                probes=torch.where(keep[:, None, None], new.probes, pack.probes),
                sample_counts=torch.where(keep, new.sample_counts, pack.sample_counts))

        def half_loss(meta, width, height, *a, **k):
            loss_fn = make_loss_fn(meta, width, height, *a, **k)

            def half(params, arrays, lights, cam, target, sample_idx, pixel_ids=None):
                n = width * height
                ids = torch.arange(n // 2, dtype=torch.int64, device=target.device)
                return loss_fn(params, arrays, lights, cam, target[: n // 2], sample_idx, ids)
            return half
        render_system.trace_samples = traced
        lightmap.bake_step = baked
        diff.make_loss_fn = half_loss
        return

    def altered_trace(*a, **k):
        r = trace_samples(*a, **k)
        return r._replace(color=r.color * 1.01)

    def altered_bake(*a, **k):
        new = bake_step(*a, **k)
        return new._replace(probes=new.probes * 1.01)

    def altered_loss(*a, **k):
        loss_fn = make_loss_fn(*a, **k)

        def scaled(*b, **kw):
            loss, live = loss_fn(*b, **kw)
            return loss * 1.01, live
        return scaled
    render_system.trace_samples = altered_trace
    lightmap.bake_step = altered_bake
    diff.make_loss_fn = altered_loss
