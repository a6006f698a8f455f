"""K7 (the texel gather) and the backward kernels of K3 and K7: their plain
versions, which the wrappers run for CPU tensors, against pim_tpu.

- Plain K7 against the interpret-mode Pallas `gather_texels_pallas`: bit for
  bit at parts = 3 (the exact three-term bf16 split) on float32 planes, and
  at parts = 1 on bf16-valued texels (the atlas's), indices outside [0, T)
  included (both clip them).
- Plain K3 backward against `jax.vjp` of `_fetch_cols_pallas` (the custom
  VJP whose backward the kernel replaces), indices outside [0, T) adding
  nothing; plain K7 backward against `jax.vjp` of the clipped `jnp.take`,
  also on indices piled the main path's way (most lanes clipped onto texel
  0 or T-1, nearly all of those with a zero gradient).
  Both sum in another order than XLA's scatter-add, so they are held within
  4 eps of the sum of |g| that lands in each output (float32 rounding of a
  sum of that many terms is far inside it), not bitwise.
- The autograd Functions route their backward through the wrappers (the
  plain versions here), and nothing launches on the CPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_kernels import pallas_interpret

from pim_tpu.render.fetch import _fetch_cols_pallas
from pim_tpu.render.table_gather import gather_texels_pallas
from pim_tpu_torch import native
from pim_tpu_torch.render import gather_kernel as gk
from pim_tpu_torch.render import table_gather as tg

torch.set_num_threads(2)

EPS32 = float(np.finfo(np.float32).eps)


def _idx(rs, k, n, t):
    idx = rs.integers(-3, t + 3, (k, n)).astype(np.int32)
    idx[0, :2] = [-1, t]
    return idx


def _bf16_values(x: np.ndarray) -> np.ndarray:
    return torch.from_numpy(x).to(torch.bfloat16).to(torch.float32).numpy()


@pytest.mark.parametrize("parts,c,t,k,n", [(3, 4, 3000, 3, 2048), (1, 4, 3000, 4, 1024),
                                           (3, 3, 384, 4, 1024)])
def test_k7_plain_matches_pallas_bitwise(parts, c, t, k, n):
    rs = np.random.default_rng(parts * 100 + c)
    planes = rs.normal(size=(c, t)).astype(np.float32)
    if parts == 1:
        planes = _bf16_values(planes)
    idx = _idx(rs, k, n, t)
    with pallas_interpret():
        ref = np.asarray(jax.block_until_ready(
            gather_texels_pallas(jnp.asarray(planes), jnp.asarray(idx), interpret=True,
                                 parts=parts)))
    before = dict(native.launches)
    out = tg.gather_texels(torch.from_numpy(planes), torch.from_numpy(idx), parts=parts)
    assert native.launches == before
    assert out.shape == (c, k, n) and ref.shape == (c, k, n)
    np.testing.assert_array_equal(out.numpy().view(np.int32), ref.view(np.int32))


def _assert_sum_close(got, want, bound):
    assert got.shape == want.shape
    assert np.all(np.abs(got - want) <= 4 * EPS32 * bound + 1e-30), \
        float(np.max(np.abs(got - want) / (bound + 1e-30)))


@pytest.mark.parametrize("f,t,n", [(48, 108, 4096), (4, 9, 4096), (24, 600, 2048)])
def test_k3_bwd_plain_matches_fetch_vjp(f, t, n):
    rs = np.random.default_rng(f + t)
    table = rs.normal(size=(f, t)).astype(np.float32)
    idx = rs.integers(-3, t + 3, n).astype(np.int32)
    idx[:2] = [-1, t]
    g = rs.normal(size=(f, n)).astype(np.float32)
    with pallas_interpret():
        _, vjp = jax.vjp(lambda tb: _fetch_cols_pallas(tb, jnp.asarray(idx)), jnp.asarray(table))
        (want,) = jax.block_until_ready(vjp(jnp.asarray(g)))
    got = gk.gather_cols_bwd(torch.from_numpy(g), torch.from_numpy(idx), t).numpy()
    ok = (idx >= 0) & (idx < t)
    bound = np.zeros((f, t), np.float64)
    np.add.at(bound.T, idx[ok], np.abs(g[:, ok]).T)
    _assert_sum_close(got, np.asarray(want), bound)
    # lanes outside [0, T) add nothing: their gradient lands nowhere
    assert np.allclose(got.sum(axis=1), g[:, ok].sum(axis=1), rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("c,t,k,n,piled", [(4, 3000, 12, 1024, False), (3, 384, 4, 2048, False),
                                           (4, 3000, 12, 1024, True), (3, 384, 4, 2048, True)])
def test_k7_bwd_plain_matches_take_vjp(c, t, k, n, piled):
    rs = np.random.default_rng(c * t)
    planes = rs.normal(size=(c, t)).astype(np.float32)
    idx = _idx(rs, k, n, t)
    g = rs.normal(size=(c, k, n)).astype(np.float32)
    if piled:
        # the main path's way: untextured and miss lanes clipped onto texel 0
        # and T-1, nearly all of them with a zero gradient
        pile = rs.random((k, n)) < 0.7
        idx[pile] = rs.choice([-5, -1, 0, t - 1, t, t + 7], size=int(pile.sum()))
        g[:, pile & (rs.random((k, n)) < 0.95)] = 0.0
    _, vjp = jax.vjp(lambda p: jnp.take(p, jnp.clip(jnp.asarray(idx), 0, t - 1), axis=1),
                     jnp.asarray(planes))
    (want,) = vjp(jnp.asarray(g))
    got = tg.gather_texels_bwd(torch.from_numpy(g), torch.from_numpy(idx), t).numpy()
    bound = np.zeros((c, t), np.float64)
    np.add.at(bound.T, np.clip(idx, 0, t - 1).ravel(), np.abs(g.reshape(c, -1)).T)
    _assert_sum_close(got, np.asarray(want), bound)


def test_autograd_functions_use_the_plain_backward():
    rs = np.random.default_rng(11)
    table = torch.from_numpy(rs.normal(size=(5, 40)).astype(np.float32)).requires_grad_(True)
    idx = torch.from_numpy(rs.integers(-2, 42, 300)).to(torch.int64)
    g = torch.from_numpy(rs.normal(size=(5, 300)).astype(np.float32))
    planes = torch.from_numpy(rs.normal(size=(3, 50)).astype(np.float32)).requires_grad_(True)
    tidx = torch.from_numpy(rs.integers(-2, 52, (4, 200)).astype(np.int32))
    tg_out = torch.from_numpy(rs.normal(size=(3, 4, 200)).astype(np.float32))
    before = dict(native.launches)
    out = gk.gather_cols(table, idx)
    (out * g).sum().backward()
    tex = tg.gather_texels(planes, tidx, parts=1)
    (tex * tg_out).sum().backward()
    assert native.launches == before
    assert torch.equal(out.detach(), gk.gather_cols_plain(table.detach(), idx))
    assert torch.equal(table.grad, gk.gather_cols_bwd_plain(g, idx, 40))
    assert torch.equal(tex.detach(), tg.gather_texels_plain(planes.detach(), tidx))
    assert torch.equal(planes.grad, tg.gather_texels_bwd_plain(tg_out, tidx, 50))
    # without a gradient to track, gather_cols skips the autograd Function
    assert gk.gather_cols(table.detach(), idx).grad_fn is None
    with pytest.raises(ValueError):
        tg.gather_texels(planes, tidx, parts=4)
