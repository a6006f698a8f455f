"""Counter-based per-ray RNG streams, bit-exact with `pim_tpu.core.rng`.

Each ray owns a 4-word pcg4d state seeded by hashing (pixel_id, sample_id,
seed).  torch has no uint32 `+` or `>>` on the CPU, so every word is carried
as an int64 tensor holding a value in [0, 2^32).  Products are formed from
16-bit halves of one factor so that no int64 product exceeds 2^49 (signed
overflow is never relied on), then masked back to 32 bits.

All draw helpers are functional: (state) -> (new_state, values).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

MASK32 = 0xFFFFFFFF
_MUL = 1664525
_ADD = 1013904223
_TO_FLOAT = 1.0 / (1 << 24)
DEFAULT_SEED = 0x9E3779B9  # the reference's default stream seed (cvar pt_seed)


class RngState(NamedTuple):
    x: torch.Tensor  # [N] int64 words in [0, 2^32)
    y: torch.Tensor
    z: torch.Tensor
    w: torch.Tensor


def mul32(a, b):
    """(a * b) mod 2^32 for words in [0, 2^32); `b` may be a Python int."""
    b_lo = b & 0xFFFF
    b_hi = (b >> 16) & 0xFFFF
    return (a * b_lo + (((a * b_hi) & 0xFFFF) << 16)) & MASK32


def add32(a, b):
    return (a + b) & MASK32


def _pcg4d_comps(x, y, z, w):
    """Jarzynski-Olano pcg4d on separate component words
    (pim_tpu/core/rng.py:_pcg4d_comps)."""
    x = add32(mul32(x, _MUL), _ADD)
    y = add32(mul32(y, _MUL), _ADD)
    z = add32(mul32(z, _MUL), _ADD)
    w = add32(mul32(w, _MUL), _ADD)
    x = add32(x, mul32(y, w))
    y = add32(y, mul32(z, x))
    z = add32(z, mul32(x, y))
    w = add32(w, mul32(y, z))
    x = x ^ (x >> 16)
    y = y ^ (y >> 16)
    z = z ^ (z >> 16)
    w = w ^ (w >> 16)
    x = add32(x, mul32(y, w))
    y = add32(y, mul32(z, x))
    z = add32(z, mul32(x, y))
    w = add32(w, mul32(y, z))
    return x, y, z, w


def pcg4d(v: torch.Tensor) -> torch.Tensor:
    """[..., 4] 32-bit words (any integer dtype) -> [..., 4] int64 words:
    pcg4d of each row, the reference's AoS form."""
    v = v.to(torch.int64) & MASK32
    return torch.stack(_pcg4d_comps(v[..., 0], v[..., 1], v[..., 2], v[..., 3]), dim=-1)


def to_float(bits: torch.Tensor) -> torch.Tensor:
    """32-bit word -> float32 in [0, 1) (top 24 bits, exact)."""
    return (bits >> 8).to(torch.float32) * _TO_FLOAT


def make_state(pixel_id: torch.Tensor, sample_id, seed=DEFAULT_SEED) -> RngState:
    """Seed per-ray streams from (pixel_id, sample_id, seed).

    pixel_id: integer tensor [N] (its device is the state's); sample_id and
    seed: Python ints or integer tensors broadcastable to [N]."""
    pix = pixel_id.to(torch.int64) & MASK32

    def word(v):
        if isinstance(v, torch.Tensor):
            v = v.to(device=pix.device, dtype=torch.int64)
            return torch.broadcast_to(v & MASK32, pix.shape)
        return torch.full(pix.shape, int(v) & MASK32, dtype=torch.int64,
                          device=pix.device)

    beef = torch.full(pix.shape, 0xDEADBEEF, dtype=torch.int64, device=pix.device)
    s = _pcg4d_comps(*_pcg4d_comps(pix, word(sample_id), word(seed), beef))
    return RngState(*s)


def next_state(state: RngState) -> RngState:
    return RngState(*_pcg4d_comps(*state))


def next_f32(state: RngState):
    state = next_state(state)
    return state, to_float(state.x)


def next_f32x2(state: RngState):
    """Returns (state, (u, v)) — a 2-tuple of [N] floats."""
    state = next_state(state)
    return state, (to_float(state.x), to_float(state.y))


def next_f32x4(state: RngState):
    state = next_state(state)
    return state, (
        to_float(state.x), to_float(state.y), to_float(state.z), to_float(state.w)
    )


def next_u32(state: RngState):
    state = next_state(state)
    return state, state.x
