"""Histogram auto-exposure: 256-bin log-luminance, cdf-windowed average.

Counterpart of `pim_tpu.render.exposure`.  The histogram is a
`scatter_add_` of ones into 256 bins; the cdf runs strictly left to right,
as the reference's float32 prefix sum; the result stays on the device.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from pim_tpu_torch.core.profiler import spanned
from pim_tpu_torch.math.color import avg_lum
from pim_tpu_torch.math.dist1d import cumsum_seq
from pim_tpu_torch.math.vec3 import EPS, LOG2_EPS, f32, saturate

HISTOGRAM_SIZE = 256


class ExposureParams(NamedTuple):
    """Exposure settings (float32 constants)."""

    manual: bool
    standard: bool      # standard vs saturation exposure
    aperture: float     # f-stops
    shutter_time: float
    iso: float
    adapt_rate: float
    offset_ev: float
    min_ev: float
    max_ev: float
    min_cdf: float
    max_cdf: float

    @classmethod
    def from_cvars(cls) -> "ExposureParams":
        from pim_tpu_torch.core import cvars as cv

        return cls(
            manual=bool(cv.cv_exp_manual.get()),
            standard=bool(cv.cv_exp_standard.get()),
            aperture=f32(cv.cv_exp_aperture.get()),
            shutter_time=f32(cv.cv_exp_shutter.get()),
            iso=f32(100.0),
            adapt_rate=f32(cv.cv_exp_adaptrate.get()),
            offset_ev=f32(cv.cv_exp_evoffset.get()),
            min_ev=f32(cv.cv_exp_evmin.get()),
            max_ev=f32(cv.cv_exp_evmax.get()),
            min_cdf=f32(cv.cv_exp_cdfmin.get()),
            max_cdf=f32(cv.cv_exp_cdfmax.get()),
        )


class ExposureState(NamedTuple):
    avg_lum: torch.Tensor   # adapted average luminance (scalar f32)
    exposure: torch.Tensor  # final scale factor (scalar f32)


def make_exposure_state(device="cpu") -> ExposureState:
    return ExposureState(avg_lum=torch.zeros((), dtype=torch.float32, device=device),
                         exposure=torch.ones((), dtype=torch.float32, device=device))


def lum_to_ev100(lum):
    return torch.log2(torch.clamp_min(lum, EPS)) + 3.0


def ev100_to_lum(ev100):
    return torch.exp2(ev100 - 3.0)


def lum_to_bin(lum, min_ev: float, max_ev: float):
    """Bin 0 holds near-black."""
    ev = lum_to_ev100(lum)
    t = (ev - min_ev) / max(f32(max_ev - min_ev), EPS)
    bin_ = (1.5 + t * float(HISTOGRAM_SIZE - 2)).to(torch.int32)
    bin_ = torch.clamp(bin_, 0, HISTOGRAM_SIZE - 1)
    return torch.where(lum > EPS, bin_, 0)


def bin_to_ev(i, min_ev: float, max_ev: float):
    rcp = f32(1.0 / (HISTOGRAM_SIZE - 1))
    ev = min_ev + f32(max_ev - min_ev) * ((i.to(torch.float32) - 0.5) * rcp)
    return torch.where(i != 0, ev, LOG2_EPS)


def manual_ev100(aperture: float, shutter_time: float, iso: float) -> float:
    a = f32(f32(aperture * aperture) / shutter_time)
    b = f32(100.0 / iso)
    return f32(math.log2(f32(a * b)))


def saturation_exposure(ev100):
    factor = f32(78.0 / (100.0 * 0.65))
    return 1.0 / (factor * torch.exp2(ev100))


def standard_exposure(ev100):
    factor = f32(10.0 / (100.0 * 0.65))
    return 0.18 / (factor * torch.exp2(ev100))


def exposure_compensation_curve(ev100):
    """Krawczyk key value."""
    l = ev100_to_lum(ev100)
    key = 1.03 - 2.0 / (torch.log10(l + 1.0) + 2.0)
    return key / 0.18


def adapt_luminance(lum0, lum1, dt: float, tau: float):
    lum0 = torch.clamp_min(lum0, EPS)
    lum1 = torch.clamp_min(lum1, EPS)
    t = saturate(1.0 - torch.exp(torch.full_like(lum0, f32(-np.float32(dt) * np.float32(tau)))))
    return lum0 + (lum1 - lum0) * t


def calc_exposure(params: ExposureParams, avg):
    avg = torch.clamp_min(avg, EPS)
    if params.manual:
        ev100 = torch.full_like(avg, manual_ev100(params.aperture, params.shutter_time,
                                                  params.iso))
    else:
        ev100 = lum_to_ev100(avg)
    comp = exposure_compensation_curve(ev100)
    ev100 = torch.clamp(ev100 - params.offset_ev, params.min_ev, params.max_ev)
    exp_ = standard_exposure(ev100) if params.standard else saturation_exposure(ev100)
    return exp_ * comp


def build_histogram(light: torch.Tensor, min_ev: float, max_ev: float) -> torch.Tensor:
    """light [N, 3] -> counts [256] int32."""
    bins = lum_to_bin(avg_lum(light), max(min_ev, LOG2_EPS), max_ev)
    counts = torch.zeros((HISTOGRAM_SIZE,), dtype=torch.int32, device=light.device)
    return counts.scatter_add_(0, bins.to(torch.int64), torch.ones_like(bins))


@spanned("pt.exposure")
def exposure_pass(light: torch.Tensor, params: ExposureParams, state: ExposureState,
                  dt: float) -> ExposureState:
    """One frame of auto-exposure: the cdf-windowed weighting w = pdf * w0
    * w1 drops the darkest min_cdf and brightest (1 - max_cdf) of pixels."""
    n = light.shape[0]
    min_ev = max(params.min_ev, LOG2_EPS)
    counts = build_histogram(light, min_ev, params.max_ev)
    pdf = counts.to(torch.float32) / f32(n)
    cdf_before = torch.cat([torch.zeros(1, dtype=torch.float32, device=light.device),
                            cumsum_seq(pdf)[:-1]])
    rcp_pdf = 1.0 / torch.clamp_min(pdf, EPS)
    w0 = 1.0 - saturate((params.min_cdf - cdf_before) * rcp_pdf)
    w1 = saturate((params.max_cdf - cdf_before) * rcp_pdf)
    w = pdf * w0 * w1
    i = torch.arange(HISTOGRAM_SIZE, device=light.device)
    lum_i = ev100_to_lum(bin_to_ev(i, min_ev, params.max_ev))
    avg = torch.sum(lum_i * w)
    adapted = adapt_luminance(state.avg_lum, avg, dt, params.adapt_rate)
    return ExposureState(avg_lum=adapted, exposure=calc_exposure(params, adapted))
