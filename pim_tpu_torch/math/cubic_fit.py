"""Randomized curve fitting for tonemap curves.

Counterpart of `pim_tpu.math.cubic_fit`: a population of candidate
coefficient sets, each mutated at 22 scales 1/2^bit per round, keeping the
best; the best of the population wins.  The reference draws its mutations
from `jax.random`; the port draws them from a seeded `torch.Generator` on
the CPU (so a fit does not depend on the device), and so its coefficients
are a fit of the same quality, not the reference's bits.

Curve models:
  cubic:  a*x + b*x^2 + c*x^3
  sqrtic: a*sqrt(x) + b*x^(1/4) + c*x^(1/8)
  tmap:   (x*(a*x + b)) / (x*(c*x + d) + e)       (GT-tonemap-ish rational)
  poly:   (b*x + c*x^2 + d*x^3) / (e + f*x + g*x^2 + h*x^3)
"""

from __future__ import annotations

from typing import Tuple

import torch

_NUM_COEFFS = 8
_MUT_BITS = 22


def cubic_eval(x, coeffs):
    """coeffs [..., 8] (the first 3 used)."""
    a, b, c = coeffs[..., 0], coeffs[..., 1], coeffs[..., 2]
    return a * x + b * x * x + c * x * x * x


def sqrtic_eval(x, coeffs):
    s1 = torch.sqrt(torch.clamp_min(x, 0.0))
    s2 = torch.sqrt(s1)
    s3 = torch.sqrt(s2)
    return coeffs[..., 0] * s1 + coeffs[..., 1] * s2 + coeffs[..., 2] * s3


def tmap_eval(x, coeffs):
    a, b, c, d, e = (coeffs[..., i] for i in range(5))
    denom = x * (c * x + d) + e
    return (x * (a * x + b)) / torch.where(torch.abs(denom) > 1e-12, denom, 1e-12)


def poly_eval(x, coeffs):
    x2 = x * x
    x3 = x2 * x
    nom = coeffs[..., 1] * x + coeffs[..., 2] * x2 + coeffs[..., 3] * x3
    den = coeffs[..., 4] + coeffs[..., 5] * x + coeffs[..., 6] * x2 + coeffs[..., 7] * x3
    return nom / torch.where(torch.abs(den) > 1e-12, den, 1e-12)


_EVALS = {
    "cubic": cubic_eval,
    "sqrtic": sqrtic_eval,
    "tmap": tmap_eval,
    "poly": poly_eval,
}


def _rms_error(eval_fn, xs, ys, coeffs):
    """sqrt(mean((f(x) - y)^2)); coeffs [..., 8], xs/ys [S] -> [...]."""
    d = eval_fn(xs, coeffs[..., None, :]) - ys
    return torch.sqrt(torch.mean(d * d, dim=-1))


def curve_fit(xs, ys, kind: str = "cubic", iterations: int = 64, population: int = 64,
              seed: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fit `kind` to the samples (xs, ys): (coeffs [8], rms error), on the
    samples' device."""
    eval_fn = _EVALS[kind]
    xs = torch.as_tensor(xs, dtype=torch.float32)
    ys = torch.as_tensor(ys, dtype=torch.float32, device=xs.device)
    dev = xs.device
    iters = max(iterations, 2 * (xs.shape[0] + 1))
    gen = torch.Generator(device="cpu").manual_seed(int(seed))
    fits = torch.rand((population, _NUM_COEFFS), generator=gen).to(dev)
    errs = _rms_error(eval_fn, xs, ys, fits)
    scales = (1.0 / (2.0 ** torch.arange(_MUT_BITS, dtype=torch.float32, device=dev)))[None, :, None]
    rows = torch.arange(population, device=dev)
    for _ in range(iters):
        # a signed mutation at each of the 22 scales
        xi = torch.rand((population, _MUT_BITS, _NUM_COEFFS), generator=gen).to(dev) * 2.0 - 1.0
        cand = fits[:, None, :] + xi * scales
        cerr = _rms_error(eval_fn, xs, ys, cand)  # [P, 22]
        best = torch.argmin(cerr, dim=1)
        berr = cerr[rows, best]
        better = berr < errs
        fits = torch.where(better[:, None], cand[rows, best], fits)
        errs = torch.where(better, berr, errs)
    win = torch.argmin(errs)
    return fits[win], errs[win]
