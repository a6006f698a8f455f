"""K6, the bilinear fetch: the texel-interleaved copy its wrapper keeps, on
the CPU.

- `gather_kernel.table_rows` makes the wrapper's texel-interleaved [T, 4C]
  copy of corner planes [4C, T] (row i holds planes[:, i]); a plain reader
  of the copy gives `gather_bilinear_plain`'s output bit for bit (indices
  -1 and T, invalid queries with NaN weights, K*N not a multiple of 4), for
  the atlas (C = 4) and the sky (C = 3).
- The copy is made once per planes tensor and again after the planes change
  in place, and carries no gradient.
- On the CPU the wrapper is the plain version and launches nothing.
"""

import numpy as np
import pytest
import torch

from pim_tpu_torch import native
from pim_tpu_torch.geom.material import TexturePool
from pim_tpu_torch.render import gather_kernel as gk
from pim_tpu_torch.render import table_gather as tg
from pim_tpu_torch.render.scene import build_atlas_corner_planes
from pim_tpu_torch.render.sky import bake_sky_cubemap, earth_atmosphere, sky_corner_planes

torch.set_num_threads(2)


def rows_plain(rows: torch.Tensor, idx, tx, ty, valid, c: int) -> torch.Tensor:
    """Plain K6 read from the texel-interleaved copy: the same weights and
    sum as gather_bilinear_plain, the four corners from one row."""
    t = rows.shape[0]
    q = rows[torch.clamp(idx, 0, t - 1).to(torch.int64)]  # [K, N, 4C]
    q = q.permute(2, 0, 1)
    txv = torch.where(valid, tx, 0.0)
    tyv = torch.where(valid, ty, 0.0)
    w00 = torch.where(valid, (1.0 - txv) * (1.0 - tyv), 0.0)
    w10 = txv * (1.0 - tyv)
    w01 = (1.0 - txv) * tyv
    w11 = txv * tyv
    out = w00 * q[0:c] + w10 * q[c : 2 * c] + w01 * q[2 * c : 3 * c] + w11 * q[3 * c : 4 * c]
    return torch.where(valid, out, 0.0)


def _atlas_planes(seed: int = 3) -> torch.Tensor:
    rs = np.random.default_rng(seed)
    pool = TexturePool()
    for size in ((8, 8), (4, 16), (1, 1), (16, 4)):
        pool.add(rs.random(size + (4,), dtype=np.float32) * 3.0 - 0.5)
    atlas, rec = pool.pack()
    return torch.from_numpy(build_atlas_corner_planes(atlas, rec))


def _sky_planes() -> torch.Tensor:
    cube = bake_sky_cubemap(earth_atmosphere(), (0.35, 0.82, 0.45), 120.0, 4, 2)
    return sky_corner_planes(cube)


def _queries(rs, t: int, k: int, n: int):
    idx = torch.from_numpy(rs.integers(-1, t + 1, (k, n)).astype(np.int32))
    idx[0, :2] = torch.tensor([-1, t], dtype=torch.int32)
    tx = torch.from_numpy(rs.random((k, n), dtype=np.float32))
    ty = torch.from_numpy(rs.random((k, n), dtype=np.float32))
    valid = torch.from_numpy(rs.random((k, n)) < 0.8)
    tx[~valid] = float("nan")
    return idx, tx, ty, valid


@pytest.mark.parametrize("which,c,k,n", [("atlas", 4, 3, 1001), ("atlas", 4, 2, 512),
                                         ("sky", 3, 1, 777)])
def test_texel_rows_layout_and_plain_gather(which, c, k, n):
    planes = _atlas_planes() if which == "atlas" else _sky_planes()
    t = planes.shape[1]
    rows = gk.table_rows(planes)
    assert rows.shape == (t, 4 * c) and rows.is_contiguous()
    assert torch.equal(rows, planes.T)
    args = _queries(np.random.default_rng(n), t, k, n)
    got = rows_plain(rows, *args, c)
    want = tg.gather_bilinear_plain(planes, *args, c)
    np.testing.assert_array_equal(got.numpy().view(np.int32), want.numpy().view(np.int32))


@pytest.mark.parametrize("change", ["none", "in place", "new planes"])
def test_texel_rows_follow_their_planes(change):
    planes = _atlas_planes(5)
    first = gk.table_rows(planes)
    if change == "in place":
        planes.mul_(0.5)
    elif change == "new planes":
        planes = planes * 0.5
    rows = gk.table_rows(planes)
    assert (rows is first) == (change == "none")
    assert torch.equal(rows, planes.T)


def test_texel_rows_carry_no_gradient():
    planes = _atlas_planes(6).requires_grad_(True)
    assert not gk.table_rows(planes).requires_grad


def test_cpu_wrapper_is_the_plain_version_and_counts_nothing():
    planes = _atlas_planes(8)
    args = _queries(np.random.default_rng(8), planes.shape[1], 2, 301)
    before = dict(native.launches)
    got = tg.gather_bilinear(planes, *args, c=4)
    assert native.launches == before
    assert torch.equal(got, tg.gather_bilinear_plain(planes, *args, c=4))
