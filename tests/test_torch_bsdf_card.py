"""The BSDF kernels (csrc/bsdf.cu) on the card: bsdf_scatter,
bsdf_refract_finish and bsdf_eval bit for bit the plain form on 262,144
seeded lanes and on the edge lanes of tools/bsdf_check.py, and an input
that requires grad keeping the plain form under autograd.

Every test needs a CUDA card and skips without one.  tests/conftest.py
imports jax, which the card's machine lacks, so run the file there with
    python -m pytest --noconftest -p no:cacheprovider -m card tests/test_torch_bsdf_card.py
"""

import pytest
import torch

from pim_tpu_torch import native
from pim_tpu_torch.core import profiler
from pim_tpu_torch.math.brdf import BrdfLut, bake_brdf_lut
from pim_tpu_torch.render import bsdf
from pim_tpu_torch.tools import bsdf_check as bc

pytestmark = pytest.mark.card

LANES = 262_144
SEED = 2_718_281_828


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.fixture(scope="module")
def lut(dev):
    return bake_brdf_lut(device=dev)


@pytest.fixture(scope="module", params=["random", "edge"])
def lanes(request, dev):
    if request.param == "random":
        return bc.random_lanes(LANES, SEED, dev)
    return bc.edge_lanes(dev)


@pytest.mark.parametrize("refract", [False, True])
def test_scatter_is_bitwise_the_plain_form(lut, lanes, refract):
    before = dict(native.launches)
    diffs = bc.scatter_differences(lut, lanes, refract)
    torch.cuda.synchronize()
    assert native.launches["bsdf_scatter"] == before["bsdf_scatter"] + 1
    assert native.launches["bsdf_refract_finish"] == before["bsdf_refract_finish"] + refract
    assert not any(diffs.values()), diffs


def test_eval_is_bitwise_the_plain_form(lut, lanes):
    before = native.launches["bsdf_eval"]
    diffs = bc.eval_differences(lut, lanes)
    torch.cuda.synchronize()
    assert native.launches["bsdf_eval"] == before + 1
    assert not any(diffs.values()), diffs


def _bsdf_launches() -> dict:
    """The BSDF kernels' launch counts (the plain form's draws launch
    csrc/rng.cu's kernels on the card)."""
    return {k: v for k, v in native.launches.items() if k.startswith("bsdf_")}


def test_an_input_that_requires_grad_keeps_the_plain_form(lut, dev):
    lanes = bc.random_lanes(4096, SEED, dev)
    albedo = lanes.surf.albedo.x.clone().requires_grad_()
    surf = lanes.surf._replace(albedo=lanes.surf.albedo._replace(x=albedo))
    before = _bsdf_launches()
    _, scat = bsdf.scatter_principled(lut, surf, lanes.i, lanes.state, bc.probe_stub([]))
    atten, _ = bsdf.eval_principled(lut, surf, lanes.i, lanes.l)
    assert _bsdf_launches() == before
    assert scat.attenuation.x.requires_grad and atten.x.requires_grad
    (scat.attenuation.x.sum() + atten.x.sum()).backward()
    assert torch.isfinite(albedo.grad).all() and albedo.grad.abs().sum() > 0
    # a learnable LUT too
    learnable = BrdfLut(texels=lut.texels.clone().requires_grad_())
    bsdf.eval_principled(learnable, lanes.surf, lanes.i, lanes.l)
    assert _bsdf_launches() == before


def test_traced_calls_count_the_kernels(lut, dev):
    lanes = bc.random_lanes(4096, SEED, dev)
    profiler.reset_counters()
    profiler.set_tracing(True)
    try:
        bsdf.scatter_principled(lut, lanes.surf, lanes.i, lanes.state, bc.probe_stub([]))
        bsdf.eval_principled(lut, lanes.surf, lanes.i, lanes.l)
        counts = profiler.counters()
    finally:
        profiler.set_tracing(False)
        profiler.reset_counters()
    assert counts == {"bsdf.calls": 2, "bsdf.kernel": 2}
