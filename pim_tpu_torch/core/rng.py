"""Counter-based per-ray RNG streams, bit-exact with `pim_tpu.core.rng`.

Each ray owns a 4-word pcg4d state seeded by hashing (pixel_id, sample_id,
seed).  torch has no uint32 `+` or `>>` on the CPU, so every word is carried
as an int64 tensor holding a value in [0, 2^32).  Products are formed from
16-bit halves of one factor so that no int64 product exceeds 2^49 (signed
overflow is never relied on), then masked back to 32 bits.

All draw helpers are functional: (state) -> (new_state, values).

Two forms compute the seed and the draws.  The plain one
(`make_state_plain`, `next_state_plain`, `draw_plain`) is the int64 code
above; CPU words take it.  Words on a CUDA card take the hand-written
kernels of `csrc/rng.cu` instead, one launch a call (`rng_seed`,
`rng_draw`), bit for bit the plain form: the new state is the rows of one
[4, N] int64 block, and a draw's floats the rows of one [k, N] block.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from pim_tpu_torch import native
from pim_tpu_torch.core import profiler as prof

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


def pcg1(v: torch.Tensor) -> torch.Tensor:
    """Scalar PCG hash of 32-bit words held in int64."""
    v = v.to(torch.int64) & MASK32
    v = add32(mul32(v, 747796405), 2891336453)
    v = mul32((v >> ((v >> 28) + 4)) ^ v, 277803737)
    return (v >> 22) ^ v


def to_float(bits: torch.Tensor) -> torch.Tensor:
    """32-bit word -> float32 in [0, 1) (top 24 bits, exact)."""
    return (bits >> 8).to(torch.float32) * _TO_FLOAT


def make_state_plain(pixel_id: torch.Tensor, sample_id, seed=DEFAULT_SEED) -> RngState:
    """`make_state` composed of int64 ops."""
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


def next_state_plain(state: RngState) -> RngState:
    return RngState(*_pcg4d_comps(*state))


def draw_plain(state: RngState, k: int):
    """One round and the first k new words as floats: (state, k-tuple)."""
    state = next_state_plain(state)
    return state, tuple(to_float(w) for w in state[:k])


# --- the kernels (csrc/rng.cu)

def _key(v, shape, dev):
    """A seed key for the kernel: (tensor or None, element size, step,
    value).  A Python int is a value; a tensor stays on the device and is
    read there, one element for every lane (step 0) or one a lane."""
    if not isinstance(v, torch.Tensor):
        return None, 8, 0, int(v) & MASK32
    if v.dtype not in (torch.int32, torch.int64):
        v = v.to(torch.int64)
    v = v.to(dev)
    if v.numel() == 1:
        return v, v.element_size(), 0, 0
    return torch.broadcast_to(v, shape).contiguous(), v.element_size(), 1, 0


def rng_seed(pixel_id: torch.Tensor, sample_id, seed) -> torch.Tensor:
    """The seed kernel: [4, *pixel_id.shape] int64 words of make_state's
    streams, from CUDA pixel ids (their low 32 bits) and a sample id and
    seed each a Python int or an integer tensor broadcastable to the ids."""
    lib = native.load()
    dev = pixel_id.device
    if dev.type != "cuda":
        raise ValueError(f"rng_seed: the kernel takes CUDA tensors, got {dev}")
    pix = pixel_id if pixel_id.dtype == torch.int64 else pixel_id.to(torch.int64)
    pix = pix.contiguous()
    words = torch.empty((4, *pix.shape), dtype=torch.int64, device=dev)
    n = pix.numel()
    if n == 0:
        return words
    keys = []
    for v in (sample_id, seed):
        t, size, step, value = _key(v, pix.shape, dev)
        keys += [None if t is None else t.data_ptr(), size, step, value]
    rc = lib.pim_rng_seed(pix.data_ptr(), n, *keys, words.data_ptr(), native.stream_ptr(dev))
    native.check(lib, rc, "rng_seed")
    native.launches["rng_seed"] += 1
    return words


def rng_draw(state: RngState, k: int):
    """The draw kernel: (words [4, *shape] int64, the next state; floats
    [k, *shape] float32, its first k words in [0, 1), or None for k = 0)
    from a state of CUDA int64 words (rows of one block or separate)."""
    lib = native.load()
    x = state[0]
    dev = x.device
    words_in = [t.contiguous() for t in state]
    for name, t in zip("xyzw", words_in):
        native.require_cuda(f"rng_draw.{name}", t, torch.int64, x.shape, dev)
    if dev.type != "cuda":
        raise ValueError(f"rng_draw: the kernel takes CUDA tensors, got {dev}")
    if not 0 <= k <= 4:
        raise ValueError(f"rng_draw: k = {k}, expected 0 to 4")
    words = torch.empty((4, *x.shape), dtype=torch.int64, device=dev)
    out = torch.empty((k, *x.shape), dtype=torch.float32, device=dev) if k else None
    n = x.numel()
    if n == 0:
        return words, out
    rc = lib.pim_rng_draw(*(t.data_ptr() for t in words_in), n, k, words.data_ptr(),
                          None if out is None else out.data_ptr(), native.stream_ptr(dev))
    native.check(lib, rc, "rng_draw")
    native.launches["rng_draw"] += 1
    return words, out


# --- the helpers: the kernels for CUDA words, else the plain form

def _on_card(t: torch.Tensor) -> bool:
    return t.device.type == "cuda"


def _count(kernel: bool) -> None:
    if prof.tracing():
        prof.count("rng.calls", 1)
        prof.count("rng.kernel", int(kernel))


def make_state(pixel_id: torch.Tensor, sample_id, seed=DEFAULT_SEED) -> RngState:
    """Seed per-ray streams from (pixel_id, sample_id, seed).

    pixel_id: integer tensor [N] (its device is the state's); sample_id and
    seed: Python ints or integer tensors broadcastable to [N].  One
    `rng_seed` launch on a card, else the plain form."""
    kernel = _on_card(pixel_id)
    _count(kernel)
    if not kernel:
        return make_state_plain(pixel_id, sample_id, seed)
    return RngState(*rng_seed(pixel_id, sample_id, seed))


def _draw(state: RngState, k: int):
    kernel = _on_card(state[0])
    _count(kernel)
    if not kernel:
        return draw_plain(state, k)
    words, out = rng_draw(state, k)
    return RngState(*words), () if out is None else tuple(out)


def next_state(state: RngState) -> RngState:
    return _draw(state, 0)[0]


def next_f32(state: RngState):
    state, (u,) = _draw(state, 1)
    return state, u


def next_f32x2(state: RngState):
    """Returns (state, (u, v)) — a 2-tuple of [N] floats."""
    return _draw(state, 2)


def next_f32x3(state: RngState):
    return _draw(state, 3)


def next_f32x4(state: RngState):
    return _draw(state, 4)


def next_u32(state: RngState):
    state, _ = _draw(state, 0)
    return state, state.x
