"""The sky kernels (csrc/sky.cu) on the card: sky_bake against
atmosphere_plain on e1m1's cube as the serving bake and the training step
take it, on an earth_sky fan and on a 4^2 cube (bit for bit where the
order of the 96-step sum is torch.sum's, which `sky.torch_sum_split`
names and a test holds; a value that differs at most 1e-6 relative),
sky_bake_bwd and sky_grad_sum against autograd of the plain form (rtol
1e-4), and two backward runs to the same bits.

Every test needs a CUDA card and skips without one.  tests/conftest.py
imports jax, which the card's machine lacks, so run the file there with
    python -m pytest --noconftest -p no:cacheprovider -m card tests/test_torch_sky_card.py
"""

import pytest
import torch

from pim_tpu_torch import native
from pim_tpu_torch.core import profiler
from pim_tpu_torch.render import sky
from pim_tpu_torch.tools import sky_check as sc

pytestmark = pytest.mark.card

GRAD_SEED = 2_236_067_977
CASES = ("e1m1 cube, serving", "e1m1 cube, training", "earth_sky fan", "4^2 cube, serving")


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.fixture(scope="module")
def cases(dev):
    return {c.label: c for c in sc.cases(dev)}


@pytest.mark.parametrize("label", CASES)
def test_forward_is_the_plain_form(cases, label):
    case = cases[label]
    before = dict(native.launches)
    got = sc.kernel_out(case)
    launched = native.launches["sky_bake"] - before["sky_bake"]
    want = sc.plain_out(case)
    assert launched == 1
    differ, gap = sc.forward_gap(got, want)
    print(f"{label}: {differ} of {got.numel()} values differ, largest relative gap {gap:.3e}")
    assert gap <= 1e-6
    assert got.requires_grad == torch.is_tensor(case.light_dir)


@pytest.mark.parametrize("n", [96, 126, 128, 4096, 6144])
def test_torch_sum_split_names_the_order_of_torch_sum(dev, n):
    """The kernels' order of a sun march's 96-step sum is torch.sum's on
    this card (else the forward's bits differ in the last place)."""
    gen = torch.Generator().manual_seed(n)
    x = torch.rand(96, n, generator=gen).to(dev)
    want = torch.sum(x, dim=0)
    got = sc.ordered_sum(x, sky.torch_sum_split(n))
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def test_backward_is_autograd_of_the_plain_form(cases):
    case = cases["e1m1 cube, training"]
    g = sc.cube_grad(case, GRAD_SEED)
    before = dict(native.launches)
    got = sc.kernel_grads(case, g)
    assert native.launches["sky_bake_bwd"] == before["sky_bake_bwd"] + 1
    assert native.launches["sky_grad_sum"] == before["sky_grad_sum"] + 1
    want = sc.plain_grads(case, g)
    for name, a, b in zip(("light_dir", "luminance"), got, want):
        print(f"{name}: kernel {a.tolist()}, autograd {b.tolist()}")
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-6 * float(b.abs().max()))


def test_two_backward_runs_give_the_same_bits(cases):
    case = cases["e1m1 cube, training"]
    g = sc.cube_grad(case, GRAD_SEED + 1)
    first = sc.kernel_grads(case, g)
    second = sc.kernel_grads(case, g)
    for a, b in zip(first, second):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))


def test_the_bake_counts_its_calls(dev):
    profiler.reset_counters()
    profiler.set_tracing(True)
    try:
        sky.bake_sky_cubemap(sky.earth_atmosphere(), sc.E1M1_SUN, sc.E1M1_LUM, 4, 2, device=dev)
        counts = profiler.counters()
    finally:
        profiler.set_tracing(False)
        profiler.reset_counters()
    assert counts == {"sky.calls": 1, "sky.kernel": 1}


def test_the_wrapper_refuses_what_it_does_not_take(cases, dev):
    case = cases["e1m1 cube, serving"]
    rd, ld = case.rd, torch.ones(3, device=dev)
    consts, trips = sky.sky_consts(sky.earth_atmosphere(), case.ro, 8), sky.steps_to_trips(8)
    with pytest.raises(TypeError):
        sky.sky_bake(rd, ld.double(), ld, consts, trips)
    with pytest.raises(ValueError):
        sky.sky_bake(rd, torch.ones(4, device=dev), ld, consts, trips)
    with pytest.raises(ValueError):
        sky.sky_bake(rd, ld.cpu(), ld, consts, trips)
    with pytest.raises(ValueError):
        sky.sky_bake(rd._replace(x=rd.x.clone().requires_grad_()), ld, ld, consts, trips)
    with pytest.raises(ValueError):
        sky.atmosphere(sky.earth_atmosphere(), case.ro, rd, ld.cpu(), 1.0, 8)
