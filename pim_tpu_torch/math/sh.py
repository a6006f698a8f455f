"""L1 spherical harmonics and ambient cubes.

Counterpart of `pim_tpu.math.sh`: compact radiance probes fit from
uniformly sampled rays.  The projections sum products over the samples in
float32 (elementwise products, then one sum), so no matrix unit (TF32)
takes part on the card.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from pim_tpu_torch.math.vec3 import PI, f32

# L1 SH basis constants
_Y0 = 0.282094791  # 1/(2 sqrt(pi))
_Y1 = 0.488602512  # sqrt(3)/(2 sqrt(pi))
_A0 = PI                                        # cosine lobe, band 0
_A1 = f32(np.float32(2.0 * PI) / np.float32(3.0))  # band 1: 2 pi / 3


def sh_l1_basis(dirs):
    """[..., 3] unit dirs -> [..., 4] (Y00, Y1-1, Y10, Y11)."""
    x, y, z = dirs[..., 0], dirs[..., 1], dirs[..., 2]
    ones = torch.ones_like(x)
    return torch.stack([_Y0 * ones, _Y1 * y, _Y1 * z, _Y1 * x], dim=-1)


def sh_l1_project(dirs, radiance):
    """Monte-Carlo projection of radiance samples onto L1 SH (uniform sphere
    pdf): dirs [S, 3], radiance [S, 3] -> coeffs [4, 3]."""
    basis = sh_l1_basis(dirs)  # [S, 4]
    s = dirs.shape[0]
    acc = torch.sum(basis[:, :, None] * radiance[:, None, :], dim=0)
    return acc * f32(np.float32(4.0 * PI) / np.float32(s))


def _bands(basis, coeffs):
    """[..., 4] band weights times coeffs [4, 3] -> [..., 3]."""
    return torch.sum(basis[..., :, None] * coeffs, dim=-2)


def sh_l1_eval(coeffs, dirs):
    """coeffs [4, 3], dirs [..., 3] -> radiance [..., 3]."""
    return _bands(sh_l1_basis(dirs), coeffs)


def sh_l1_irradiance(coeffs, normal):
    """Cosine-convolved irradiance from L1 SH (A0 = pi, A1 = 2 pi / 3)."""
    basis = sh_l1_basis(normal)
    bands = torch.tensor([_A0, _A1, _A1, _A1], dtype=torch.float32, device=basis.device)
    return _bands(basis * bands, coeffs) / PI


class AmbCube(NamedTuple):
    """6-directional ambient cube: rgb per +x, -x, +y, -y, +z, -z."""

    faces: torch.Tensor  # [6, 3]


def ambcube_fit(dirs, radiance) -> AmbCube:
    """Fit an ambient cube from uniform sphere samples."""
    w = torch.stack(
        [
            torch.clamp_min(dirs[..., 0], 0.0),
            torch.clamp_min(-dirs[..., 0], 0.0),
            torch.clamp_min(dirs[..., 1], 0.0),
            torch.clamp_min(-dirs[..., 1], 0.0),
            torch.clamp_min(dirs[..., 2], 0.0),
            torch.clamp_min(-dirs[..., 2], 0.0),
        ],
        dim=-1,
    )  # [S, 6]
    wsum = torch.clamp_min(torch.sum(w, dim=0), 1e-6)  # [6]
    faces = torch.sum(w[:, :, None] * radiance[:, None, :], dim=0) / wsum[:, None]
    return AmbCube(faces=faces)


def ambcube_eval(cube: AmbCube, normal):
    """Irradiance estimate along normal [..., 3] -> [..., 3]."""
    n2 = normal * normal
    pos = normal > 0.0
    x = torch.where(pos[..., 0:1], cube.faces[0], cube.faces[1])
    y = torch.where(pos[..., 1:2], cube.faces[2], cube.faces[3])
    z = torch.where(pos[..., 2:3], cube.faces[4], cube.faces[5])
    return x * n2[..., 0:1] + y * n2[..., 1:2] + z * n2[..., 2:3]
