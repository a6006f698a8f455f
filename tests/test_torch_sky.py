"""The sky bake's dispatch on the CPU (render/sky.py): `atmosphere_plain_vjp`,
the plain counterpart of csrc/sky.cu's backward, equals autograd of
`atmosphere_plain` (rtol 1e-5 on the scale of the largest component); CPU
inputs take the plain form and launch nothing; the kernels' wrapper
refuses a wrong dtype, shape or device;
`sky.calls` and `sky.kernel` count only while tracing; the cached cube
directions bake the same cube bits as directions made anew.  The kernels
themselves run on the card: tests/test_torch_sky_card.py."""

import numpy as np
import pytest
import torch

from pim_tpu_torch import native
from pim_tpu_torch.core import profiler
from pim_tpu_torch.math.vec3 import V3
from pim_tpu_torch.render import sky

MED = sky.earth_atmosphere()
RO = (0.0, float(MED.r_crust), 0.0)
SUNS = {"high": (0.3, 0.9, 0.3), "low": (0.9, 0.05, 0.4), "below": (0.6, -0.2, 0.7)}
LUM = (3.0, 2.5, 1.7)


def _cube(size):
    d = sky.cube_dirs(size, "cpu")
    return V3(d[0], d[1], d[2])


@pytest.mark.parametrize("sun", sorted(SUNS))
@pytest.mark.parametrize("steps", [1, 8])
@pytest.mark.parametrize("size", [2, 3, 4])
def test_plain_vjp_is_autograd_of_the_plain_form(size, steps, sun):
    rd = _cube(size)
    s = torch.tensor(SUNS[sun])
    s = (s / s.norm()).requires_grad_()
    lum = torch.tensor(LUM, requires_grad=True)
    out = sky.atmosphere_plain(MED, RO, rd, s, lum, steps)
    gen = torch.Generator().manual_seed(1000 * size + 10 * steps + sorted(SUNS).index(sun))
    g = V3(*(torch.randn(rd.x.shape[0], generator=gen) for _ in range(3)))
    want = torch.autograd.grad(sum((o * c).sum() for o, c in zip(out, g)), [s, lum])
    got = sky.atmosphere_plain_vjp(MED, RO, rd, s.detach(), lum.detach(), steps, g)
    for a, b in zip(got, want):
        # autograd sums in float32: a component that cancels to ~1e-3 of the
        # largest carries its rounding, so the scale is the largest's
        assert a.dtype == torch.float64
        torch.testing.assert_close(a, b.double(), rtol=1e-5, atol=1e-5 * float(b.abs().max()))
    if sun != "below":
        assert all(float(v.abs().max()) > 0.0 for v in want)


@pytest.mark.parametrize("grad", [False, True])
def test_cpu_inputs_take_the_plain_form_and_launch_nothing(grad):
    rd = _cube(3)
    s = torch.tensor(SUNS["low"])
    lum = torch.tensor(LUM, requires_grad=grad)
    before = dict(native.launches)
    got = sky.atmosphere(MED, RO, rd, s, lum, 2)
    assert native.launches == before
    want = sky.atmosphere_plain(MED, RO, rd, s, lum, 2)
    for a, b in zip(got, want):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
        assert a.requires_grad == grad


def test_the_wrapper_refuses_what_it_does_not_take():
    rd = _cube(2)
    ld = torch.ones(3)
    consts, trips = sky.sky_consts(MED, RO, 4), sky.steps_to_trips(4)
    with pytest.raises(TypeError, match="dtype"):
        sky.sky_bake(rd, ld.double(), ld, consts, trips)
    with pytest.raises(TypeError, match="dtype"):
        sky.sky_bake(V3(*(c.double() for c in rd)), ld, ld, consts, trips)
    with pytest.raises(ValueError, match="shape"):
        sky.sky_bake(rd, torch.ones(4), ld, consts, trips)
    with pytest.raises(ValueError, match="expected"):
        sky.sky_bake(V3(*(c.reshape(2, -1) for c in rd)), ld, ld, consts, trips)
    with pytest.raises(ValueError, match="contiguous"):
        sky.sky_bake(rd, ld, torch.ones(6)[::2], consts, trips)
    with pytest.raises(ValueError, match="meta"):
        sky.sky_bake(rd, ld.to("meta"), ld, consts, trips)
    with pytest.raises(ValueError, match="view steps"):
        sky.sky_bake(rd, ld, ld, consts, 1025)
    with pytest.raises(ValueError, match="no gradient"):
        sky.sky_bake(rd._replace(x=rd.x.clone().requires_grad_()), ld, ld, consts, trips)
    with pytest.raises(ValueError, match="CUDA"):
        sky.sky_bake(rd, ld, ld, consts, trips)
    with pytest.raises(ValueError, match="CUDA"):
        sky.sky_bake_bwd(rd, ld, ld, consts, trips, torch.ones(3, rd.x.shape[0]))


@pytest.mark.parametrize("traced", [False, True])
def test_the_bake_counts_its_calls_while_tracing(traced):
    profiler.reset_counters()
    profiler.set_tracing(traced)
    try:
        sky.bake_sky_cubemap(MED, SUNS["high"], 120.0, 2, 1)
        counts = profiler.counters()
    finally:
        profiler.set_tracing(False)
        profiler.reset_counters()
    assert counts == ({"sky.calls": 1, "sky.kernel": 0} if traced else {})


def test_cached_cube_directions_bake_the_same_bits():
    size, steps, sun = 4, 2, SUNS["high"]
    assert sky.cube_dirs(size, "cpu") is sky.cube_dirs(size, torch.device("cpu"))
    fresh = torch.from_numpy(np.ascontiguousarray(sky.cubemap_dirs(size).reshape(-1, 3).T))
    assert torch.equal(sky.cube_dirs(size, "cpu"), fresh)
    s = np.asarray(sun, np.float32)
    s = s / np.sqrt(np.maximum(np.sum(s * s), np.float32(1e-12)))
    want = sky.atmosphere_plain(MED, RO, V3(fresh[0], fresh[1], fresh[2]), s, 120.0, steps)
    want = want.aos().reshape(6, size, size, 3)
    got = sky.bake_sky_cubemap(MED, sun, 120.0, size, steps)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
