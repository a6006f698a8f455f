"""media_ms_per_step.<kind>: device ms a step of the kernels whose
innermost program span is `pt.media` (the null-scattering march, the phase
sampling and their glue in `render/media.py:scatter_ray`) or `pt.media.tr`
(the ratio-tracked transmittance, `calc_transmittance`, of the in-media and
the surface NEE), over the stackless pass (pimbench/spans.py).  A program
without those spans, or a scene without media, reads nothing."""

from pimbench import spans

SPANS = ("pt.media", "pt.media.tr")


def read(t, kind):
    s = spans.of(t)
    if s is None:
        return None
    us = sum(s.by_span[n].device_self_us for n in SPANS if n in s.by_span)
    return us / s.steps / 1e3 if us > 0 else None
