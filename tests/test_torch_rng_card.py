"""The RNG kernels (csrc/rng.cu) on the card: rng_seed and rng_draw behind
every helper of core/rng.py bit for bit the plain int64 form, on the edge
words of tools/rng_check.py at 0, 1, 262,144 and 1,048,576 lanes, with the
words as rows of one block and as tensors of their own; a chain of 30
draws; no host sync; and bsdf_scatter's words (csrc/bsdf.cu, which shares
rng.cuh) still the plain form's rounds.

Every test needs a CUDA card and skips without one.  tests/conftest.py
imports jax, which the card's machine lacks, so run the file there with
    python -m pytest --noconftest -p no:cacheprovider -m card tests/test_torch_rng_card.py
"""

import pytest
import torch

from pim_tpu_torch import native
from pim_tpu_torch.core import profiler, rng
from pim_tpu_torch.math.brdf import bake_brdf_lut
from pim_tpu_torch.render import bsdf
from pim_tpu_torch.tools import bsdf_check as bc
from pim_tpu_torch.tools import rng_check as rc

pytestmark = pytest.mark.card

SIZES = (0, 1, 262_144, 1_048_576)
SEED = 1_618_033_988
CHAIN = 30


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _keys(dev, n):
    """(label, sample id, seed): Python ints, device scalars of both int
    dtypes, and one word a lane."""
    return (
        ("ints", 2**32 - 1, 0x11671),
        ("int64 scalars", torch.tensor(-5, device=dev), torch.tensor(2**40 + 3, device=dev)),
        ("int32 scalar", torch.tensor(-7, dtype=torch.int32, device=dev), rng.DEFAULT_SEED),
        ("[N] words", 7, torch.arange(n, device=dev) * 2654435761 - 3),
    )


@pytest.mark.parametrize("n", SIZES)
def test_make_state_is_the_plain_form(dev, n):
    ids = rc.edge_ids(n, dev)
    for label, sample_id, seed in _keys(dev, n):
        before = native.launches["rng_seed"]
        diffs = rc.seed_differences(ids, sample_id, seed)
        assert native.launches["rng_seed"] == before + (n > 0), label
        assert not any(diffs), (label, diffs)


@pytest.mark.parametrize("layout", ["block", "separate"])
@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("helper", sorted(rc.HELPERS))
def test_draws_are_the_plain_form(dev, helper, n, layout):
    state = rng.make_state_plain(rc.edge_ids(n, dev), 3, SEED)
    state = rc.block_state(state) if layout == "block" else rc.separate_state(state)
    before = native.launches["rng_draw"]
    diffs = rc.helper_differences(helper, state)
    assert native.launches["rng_draw"] == before + (n > 0)
    assert not any(diffs), diffs


def test_a_chain_of_draws_is_the_plain_chain(dev):
    ids = rc.edge_ids(262_144, dev)
    got, want = rng.make_state(ids, 12, SEED), rng.make_state_plain(ids, 12, SEED)
    names = sorted(rc.HELPERS)
    for step in range(CHAIN):
        helper, plain = rc.HELPERS[names[step % len(names)]]
        (got, g), (want, w) = helper(got), plain(want)
        diffs = rc.differing([*got, *g], [*want, *w])
        assert not any(diffs), (step, diffs)


def test_the_helpers_do_not_sync_with_the_host(dev):
    ids = rc.edge_ids(4096, dev)
    sample = torch.tensor(3, device=dev)
    rng.make_state(ids, sample, SEED)  # load the library and warm up, unwatched
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        state = rng.make_state(ids, sample, torch.arange(4096, device=dev))
        for name in sorted(rc.HELPERS):
            state, _ = rc.HELPERS[name][0](state)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()


def test_traced_calls_count_the_kernels(dev):
    profiler.reset_counters()
    profiler.set_tracing(True)
    try:
        state = rng.make_state(rc.edge_ids(4096, dev), 1)
        rng.next_f32x2(state)
        rng.next_u32(state)
        counts = profiler.counters()
    finally:
        profiler.set_tracing(False)
        profiler.reset_counters()
    assert counts == {"rng.calls": 3, "rng.kernel": 3}


@pytest.mark.parametrize("refract", [False, True])
def test_bsdf_scatter_words_are_the_plain_rounds(dev, refract):
    """bsdf_scatter draws two rounds (four on the glass path) on every lane;
    its words are those rounds of the int64 form."""
    lanes = bc.random_lanes(262_144, SEED, dev)
    fields = [t.contiguous() for t in bsdf.scatter_fields(lanes.surf, lanes.i, lanes.state)]
    _, words, _ = bsdf.bsdf_scatter(bake_brdf_lut(device=dev).texels, fields, refract)
    want = lanes.state
    for _ in range(4 if refract else 2):
        want = rng.next_state_plain(want)
    assert not any(rc.differing(list(words), list(want)))
