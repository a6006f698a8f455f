"""The media kernels (csrc/media.cu) on the card: media_scatter (ME1) and
media_transmittance (ME2) bit for bit the plain form on 262,144 seeded
lanes through the dense medium, the cornell-media cell's medium and a
random one, their tallies (live steps, steps in the noise band) the plain
form's; one launch a call, no host sync, the counters; an input that
requires grad keeping the plain form under autograd.

Every test needs a CUDA card and skips without one.  tests/conftest.py
imports jax, which the card's machine lacks, so run the file there with
    python -m pytest --noconftest -p no:cacheprovider -m card tests/test_torch_media_card.py
"""

import pytest
import torch

from pim_tpu_torch import native
from pim_tpu_torch.core import profiler
from pim_tpu_torch.math.vec3 import V3
from pim_tpu_torch.render import media
from pim_tpu_torch.tools import media_check as mc

pytestmark = pytest.mark.card

LANES = 262_144
SEED = 3_141_592_653
MEDIA = {"dense": mc.DENSE, "cell": mc.CELL, "random": mc.random_medium(SEED)}


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.fixture(scope="module")
def lanes(dev):
    return mc.random_lanes(LANES, SEED, dev)


@pytest.mark.parametrize("medium", sorted(MEDIA))
def test_scatter_is_bitwise_the_plain_form(lanes, medium):
    desc = media.make_media_desc(**MEDIA[medium])
    before = dict(native.launches)
    diffs = mc.scatter_differences(desc, *lanes)
    torch.cuda.synchronize()
    assert native.launches["media_scatter"] == before["media_scatter"] + 1
    assert not any(diffs.values()), diffs
    _, m = media.march(desc, lanes[3], *lanes[:3])
    share = float(m.scattered.float().mean())
    assert 0.0 < share < 1.0, share


@pytest.mark.parametrize("medium", sorted(MEDIA))
def test_transmittance_is_bitwise_the_plain_form(lanes, medium):
    desc = media.make_media_desc(**MEDIA[medium])
    before = native.launches["media_transmittance"]
    diffs = mc.transmittance_differences(desc, *lanes)
    torch.cuda.synchronize()
    assert native.launches["media_transmittance"] == before + 1
    assert not any(diffs.values()), diffs


@pytest.mark.parametrize("kernel", ["scatter", "tr"])
@pytest.mark.parametrize("medium", sorted(MEDIA))
def test_the_kernels_tally_what_the_plain_form_tallies(lanes, kernel, medium):
    desc = media.make_media_desc(**MEDIA[medium])
    diffs = mc.tally_differences(kernel, desc, *lanes)
    assert not any(diffs.values()), diffs


def test_the_kernels_never_wait_on_the_host(lanes):
    desc = media.make_media_desc(**mc.CELL)
    ro, rd, length, state = lanes
    media.march(desc, state, ro, rd, length)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        state2, _ = media.march(desc, state, ro, rd, length)
        media.calc_transmittance(desc, state2, ro, rd, length)
    finally:
        torch.cuda.set_sync_debug_mode("default")


def test_counters_and_spans(lanes):
    desc = media.make_media_desc(**mc.CELL)
    ro, rd, length, state = lanes
    profiler.reset_counters()
    profiler.set_tracing(True)
    try:
        state, ms = media.scatter_ray(desc, state, ro, rd, length)
        media.calc_transmittance(desc, state, ro, rd, length)
        counts = profiler.counters()
    finally:
        profiler.set_tracing(False)
        profiler.reset_counters()
    assert counts["media.calls"] == counts["media.kernel"] == 2
    assert counts["media.march_lanes"] == counts["media.tr_lanes"] == LANES
    assert counts["media.lanes"] == counts["media.tr_live"] == LANES
    assert counts["media.scattered"] == int(ms.scattered.sum())
    for k in ("march", "tr"):
        assert 0 < counts[f"media.{k}_band"] < counts[f"media.{k}_steps"] < 32 * LANES


def test_an_input_that_requires_grad_keeps_the_plain_form(dev):
    ro, rd, length, state = mc.random_lanes(1024, SEED, dev)
    desc = media.make_media_desc(**mc.DENSE)
    length = length.clone().requires_grad_()
    before = {k: native.launches[k] for k in ("media_scatter", "media_transmittance")}
    _, m = media.march(desc, state, ro, rd, length)
    _, tr = media.calc_transmittance(desc, state, ro, rd, length)
    assert {k: native.launches[k] for k in before} == before
    ro_g = ro.x.clone().requires_grad_()
    _, tr = media.calc_transmittance(desc, state, V3(ro_g, ro.y, ro.z), rd, length)
    tr.x.sum().backward()
    assert {k: native.launches[k] for k in before} == before
    assert ro_g.grad is not None and torch.isfinite(ro_g.grad).all()
