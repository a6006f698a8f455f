"""What the RNG kernels (csrc/rng.cu) are checked on and held against,
shared by chip_smoke.py and the tests.

- Ids: `edge_ids`, pixel ids whose last words sit at the 32-bit edges
  (tests/test_torch_rng.py's `_ids`), with ids outside [0, 2^32) first
  (negative and wide: the seed takes their low 32 bits).
- `HELPERS`: each helper of core/rng.py beside its plain int64 form, both
  as functions of a state; `helper_differences` runs both on one state
  and counts, per output, the lanes whose bits differ; `block_state` and
  `separate_state` give the same words as rows of one [4, N] block and as
  four tensors of their own; `differing` is bsdf_check's.
- `*_bytes`: each kernel's bytes, every input read once and every output
  written once.
"""

from __future__ import annotations

import numpy as np
import torch

from pim_tpu_torch.core import rng
from pim_tpu_torch.tools.bsdf_check import differing

EDGE_WORDS = (2**32 - 1, 2**32 - 2, 2**32 - 3, 2**31, 2**31 - 1, 0xDEADBEEF)
WIDE_IDS = (-1, -(2**31), 2**40 + 7)


def edge_ids(n: int, dev) -> torch.Tensor:
    """[n] int64 pixel ids 0..n-1 with the last words at the 32-bit edges
    and, where n > 8, the first ones outside [0, 2^32)."""
    ids = np.arange(n, dtype=np.int64)
    k = min(len(EDGE_WORDS), n)
    if k:
        ids[n - k:] = EDGE_WORDS[len(EDGE_WORDS) - k:]
    if n > 8:
        ids[:len(WIDE_IDS)] = WIDE_IDS
    return torch.from_numpy(ids).to(dev)


def _next_f32(state):
    state, u = rng.next_f32(state)
    return state, (u,)


def _next_u32(state):
    state, x = rng.next_u32(state)
    return state, (x,)


def _next_u32_plain(state):
    state = rng.next_state_plain(state)
    return state, (state.x,)


# name -> (the helper, its plain form), each (state) -> (state, values)
HELPERS = {
    "next_state": (lambda s: (rng.next_state(s), ()), lambda s: (rng.next_state_plain(s), ())),
    "next_f32": (_next_f32, lambda s: rng.draw_plain(s, 1)),
    "next_f32x2": (rng.next_f32x2, lambda s: rng.draw_plain(s, 2)),
    "next_f32x3": (rng.next_f32x3, lambda s: rng.draw_plain(s, 3)),
    "next_f32x4": (rng.next_f32x4, lambda s: rng.draw_plain(s, 4)),
    "next_u32": (_next_u32, _next_u32_plain),
}


def _outputs(result) -> list:
    state, vals = result
    return [*state, *vals]


def helper_differences(name: str, state: rng.RngState) -> list:
    """The helper and its plain form on one state: per output (the four
    words, then the values) the lanes whose bits differ."""
    helper, plain = HELPERS[name]
    return differing(_outputs(helper(state)), _outputs(plain(state)))


def seed_differences(ids: torch.Tensor, sample_id, seed) -> list:
    """make_state against make_state_plain: per word the lanes whose bits
    differ."""
    return differing(list(rng.make_state(ids, sample_id, seed)),
                     list(rng.make_state_plain(ids, sample_id, seed)))


def block_state(state: rng.RngState) -> rng.RngState:
    """The words as rows of one [4, N] block."""
    return rng.RngState(*torch.stack(list(state)))


def separate_state(state: rng.RngState) -> rng.RngState:
    """The words as four tensors of their own."""
    return rng.RngState(*(w.clone() for w in state))


def seed_bytes(n: int, keyed_lanes: int = 0) -> int:
    """rng_seed: the ids (8 B a lane) and each key given as an [N] tensor
    read, four int64 words written."""
    return n * 8 * (1 + keyed_lanes) + n * 32


def draw_bytes(n: int, k: int) -> int:
    """rng_draw: four int64 words read and written, k floats written."""
    return n * (64 + 4 * k)
