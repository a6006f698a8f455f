"""Compact irradiance probes: an ambient cube and L1 spherical harmonics.

Counterpart of `pim_tpu.render.probes`: a pass traces `samples` uniform
sphere rays from the probe's origin (one `trace_rays` call) and folds them
into the running ambient-cube and L1 SH fits with weight 1/(1 + passes),
two encodings of the same field.  The shell's `probe_bake` and
`probe_report` commands drive it, and checkpoints carry it.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from pim_tpu_torch.core import rng
from pim_tpu_torch.math.sampling import sample_unit_sphere
from pim_tpu_torch.math.sh import (AmbCube, ambcube_eval, ambcube_fit, sh_l1_eval,
                                   sh_l1_irradiance, sh_l1_project)
from pim_tpu_torch.math.vec3 import V3
from pim_tpu_torch.render.integrator import trace_rays

PROBE_SEED = 0x0A3BC0DE


class LightProbe(NamedTuple):
    """The running fit of one probe position, on one device."""

    origin: torch.Tensor        # [3]
    faces: torch.Tensor         # [6, 3] ambient cube rgb per +-x, +-y, +-z
    sh: torch.Tensor            # [4, 3] L1 SH coefficients
    sample_count: torch.Tensor  # 0-d int32: completed bake passes


def probe_new(origin, device="cuda") -> LightProbe:
    return LightProbe(
        origin=torch.as_tensor(np.asarray(origin, np.float32), device=device),
        faces=torch.zeros((6, 3), dtype=torch.float32, device=device),
        sh=torch.zeros((4, 3), dtype=torch.float32, device=device),
        sample_count=torch.zeros((), dtype=torch.int32, device=device),
    )


def probe_rays(probe: LightProbe, samples: int):
    """(state, ro, rd) of the probe's next pass: `samples` uniform-sphere
    rays from its origin, keyed by (ray, passes done)."""
    dev = probe.origin.device
    state = rng.make_state(torch.arange(samples, device=dev), probe.sample_count,
                           seed=PROBE_SEED)
    state, (u, v) = rng.next_f32x2(state)
    rd = sample_unit_sphere(u, v)
    ro = V3(*(probe.origin[i].expand(samples).contiguous() for i in range(3)))
    return state, ro, rd


def probe_bake_step(meta, arrays, lights, probe: LightProbe, samples: int = 1024,
                    max_bounces: int = 4) -> LightProbe:
    """One progressive pass: trace the `probe_rays` and fold them into the
    running cube and SH fits."""
    state, ro, rd = probe_rays(probe, samples)
    res = trace_rays(meta, arrays, lights, ro, rd, state, max_bounces)

    dirs = rd.aos()       # [S, 3]
    radiance = res.color  # [S, 3]
    batch_cube = ambcube_fit(dirs, radiance).faces
    batch_sh = sh_l1_project(dirs, radiance)

    w = 1.0 / (1.0 + probe.sample_count.to(torch.float32))
    return probe._replace(
        faces=probe.faces + (batch_cube - probe.faces) * w,
        sh=probe.sh + (batch_sh - probe.sh) * w,
        sample_count=probe.sample_count + 1,
    )


def _on(probe: LightProbe, x) -> torch.Tensor:
    """x (a tensor or an array-like of floats) as a float32 tensor on the
    probe's device."""
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.asarray(x, np.float32))
    return x.to(device=probe.faces.device, dtype=torch.float32)


def probe_irradiance(probe: LightProbe, normals) -> torch.Tensor:
    """Cosine-weighted irradiance along [..., 3] normals from the ambient
    cube."""
    return ambcube_eval(AmbCube(faces=probe.faces), _on(probe, normals))


def probe_sh_irradiance(probe: LightProbe, normals) -> torch.Tensor:
    """The same estimate from the L1 SH fit (cosine-convolved bands)."""
    return sh_l1_irradiance(probe.sh, _on(probe, normals))


def probe_radiance(probe: LightProbe, dirs) -> torch.Tensor:
    """The raw L1 radiance along [..., 3] directions."""
    return sh_l1_eval(probe.sh, _on(probe, dirs))


def probe_to_crate_entry(probe: LightProbe) -> dict:
    def host(t, dtype):
        return t.detach().cpu().numpy().astype(dtype)

    return {
        "origin": host(probe.origin, np.float32),
        "faces": host(probe.faces, np.float32),
        "sh": host(probe.sh, np.float32),
        "sample_count": host(probe.sample_count, np.int32),
    }


def probe_from_crate_entry(entry: dict, device="cuda") -> LightProbe:
    def dev_t(a, dtype):
        return torch.from_numpy(np.array(a, dtype)).to(device)

    return LightProbe(
        origin=dev_t(entry["origin"], np.float32),
        faces=dev_t(entry["faces"], np.float32),
        sh=dev_t(entry["sh"], np.float32),
        sample_count=dev_t(entry["sample_count"], np.int32),
    )
