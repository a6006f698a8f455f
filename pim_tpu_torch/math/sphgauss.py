"""Spherical gaussians: basis eval, irradiance, progressive fitting.

Counterpart of `pim_tpu.math.sphgauss`: the 5-lobe SG basis of the GI
lightmapper.  An SG set is (axes [K, 4]: xyz direction and sharpness,
amplitudes [..., K, 4]: rgb and the running basis weight in w).

The 3-term dot products are written out term by term (left to right), so
no matrix unit (TF32) takes part on the card.

`sg_accumulate` is Roughton's running least-squares fit: each new
(direction, radiance) sample nudges every lobe's amplitude toward the
residual it should explain; sample_weight = 1/N gives the running average.
`lightmap.bake_step` folds its samples with its own inline copy of this
fit, which has no first-sample reset; the two are kept apart as the
reference keeps them.
"""

from __future__ import annotations

import numpy as np
import torch

from pim_tpu_torch.math.vec3 import EPS, TAU, lerp, saturate

# the lightmapper's 5 fixed GI directions
GI_AXII = np.array(
    [
        [0.000000, 0.000000, 1.000000, 4.999773],
        [0.577350, 0.577350, 0.577350, 4.999773],
        [-0.577350, 0.577350, 0.577350, 4.999773],
        [0.577350, -0.577350, 0.577350, 4.999773],
        [-0.577350, -0.577350, 0.577350, 4.999773],
    ],
    np.float32,
)


def axes_dot(axes: torch.Tensor, dirs: torch.Tensor) -> torch.Tensor:
    """cos between each axis and each direction: axes [K, >=3], dirs
    [..., 3] -> [..., K]."""
    d = dirs[..., None, :]
    return d[..., 0] * axes[:, 0] + d[..., 1] * axes[:, 1] + d[..., 2] * axes[:, 2]


def sg_basis_eval(axes: torch.Tensor, dirs: torch.Tensor) -> torch.Tensor:
    """e^(sharpness * (cos theta - 1)); axes [K, 4], dirs [..., 3] -> [..., K]."""
    return torch.exp(axes[:, 3] * (axes_dot(axes, dirs) - 1.0))


def sg_eval(axes, amplitudes, dirs):
    """Radiance of the SG set along dirs: [..., K, 4] amps -> [..., 3]."""
    basis = sg_basis_eval(axes, dirs)  # [..., K]
    return torch.sum(amplitudes[..., :3] * basis[..., None], dim=-2)


def sg_basis_integral(sharpness):
    return TAU * (1.0 - torch.exp(-2.0 * sharpness)) / sharpness


def sg_irradiance(axes, amplitudes, normal):
    """Hill's fitted hemispherical irradiance.  axes [K, 4], amplitudes
    [..., K, 4], normal [..., 3] -> [..., 3]."""
    mu_dot_n = axes_dot(axes, normal)  # [..., K]
    lam = axes[:, 3]
    c0 = 0.36
    c1 = 1.0 / (4.0 * 0.36)
    eml = torch.exp(-lam)
    eml2 = eml * eml
    rl = 1.0 / lam
    scale = 1.0 + 2.0 * eml2 - rl
    bias = (eml - eml2) * rl - eml2
    x = torch.sqrt(torch.clamp_min(1.0 - scale, EPS))
    x0 = c0 * mu_dot_n
    x1 = c1 * x
    n = x0 + x1
    y = torch.where(torch.abs(x0) <= x1, (n * n) / x, saturate(mu_dot_n))
    norm_irr = scale * y + bias  # [..., K]
    integral = amplitudes[..., :3] * sg_basis_integral(lam)[..., None]
    return torch.sum(integral * norm_irr[..., None], dim=-2)


def sg_accumulate(sample_weight, dirs, radiance, axes, amplitudes):
    """Progressive SG fit of one sample per texel (Roughton running fit).

    dirs [..., 3], radiance [..., 3], amplitudes [..., K, 4] (w = running
    basis weight); sample_weight a float or [...]: 1/sampleCount per
    texel.  Returns the new amplitudes; where sample_weight >= 1 the old
    ones are zeroed first."""
    sw = torch.as_tensor(sample_weight, dtype=torch.float32, device=dirs.device)
    if sw.ndim < dirs.ndim - 1:
        sw = torch.broadcast_to(sw, dirs.shape[:-1])
    first = (sw >= 1.0)[..., None, None]
    amplitudes = torch.where(first, 0.0, amplitudes)

    basis = sg_basis_eval(axes, dirs)  # [..., K]
    estimate = torch.sum(amplitudes[..., :3] * basis[..., None], dim=-2)  # [..., 3]

    amp_rgb = amplitudes[..., :3]
    weight = amplitudes[..., 3]
    new_weight = lerp(weight, basis, sw[..., None])
    other = estimate[..., None, :] - amp_rgb * basis[..., None]
    this_lobe = (radiance[..., None, :] - other) * (
        basis / torch.clamp_min(new_weight, EPS))[..., None]
    new_rgb = lerp(amp_rgb, this_lobe, sw[..., None, None])
    new_rgb = torch.clamp_min(new_rgb, 0.0)
    active = (basis > 0.0)[..., None]
    out_rgb = torch.where(active, new_rgb, amp_rgb)
    out_w = torch.where(basis > 0.0, new_weight, weight)
    return torch.cat([out_rgb, out_w[..., None]], dim=-1)
