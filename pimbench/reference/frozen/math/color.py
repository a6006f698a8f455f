"""Color: the emission scale and the average luminance (the two pieces of
the port's `math/color.py` that the reference reaches)."""

from __future__ import annotations

import torch

from pimbench.reference.frozen.math.vec3 import f32

K_EMISSION_SCALE = 100.0
_THIRD = f32(1.0 / 3.0)


def avg_lum(c: torch.Tensor) -> torch.Tensor:
    """Mean of rgb of [..., 3] colors (the reference's 'average luminance')."""
    return (c[..., 0] + c[..., 1] + c[..., 2]) * _THIRD
