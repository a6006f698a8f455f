"""The plain versions of K1/K2/K3 (what the kernel wrappers run for CPU
tensors) against the Pallas kernels in interpret mode.

K1 tri ids and K2 flags must be equal (dead lanes included); K1 t is
bitwise equal to a numpy op-by-op float32 evaluation, and within rtol 1e-6
of the interpret-mode kernel on all but at most 8 hit lanes, which stay
inside the FMA-contraction bound stated in
test_dense_isect_plain_matches_pallas; K3 must be bitwise equal on tables
inside the Pallas kernel's domain (|x| <= 3.38e38, no magnitude below
2^-100)."""

import contextlib
import ctypes

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from pim_tpu.geom.cornell import build_cornell_box
from pim_tpu.geom.entities import flatten
from pim_tpu.render import cluster as jcluster
from pim_tpu.render import pallas_kernels as pk
from pim_tpu.render.gather_kernel import gather_cols_pallas
from pim_tpu_torch import native
from pim_tpu_torch.math.vec3 import V3
from pim_tpu_torch.render import dense_kernels as dk
from pim_tpu_torch.render import gather_kernel as gk
from pim_tpu_torch.tools import dense_check as dc
from pim_tpu_torch.tools import prof_frame
from pim_tpu_torch.tools.cluster_check import aimed_rays, tie_soup

torch.set_num_threads(2)

N = 4096


def _finished(fn):
    """`fn`, but its eager result is complete when it returns."""
    def call(*args):
        out = fn(*args)
        if not any(isinstance(x, jax.core.Tracer) for x in jax.tree.leaves(out)):
            jax.block_until_ready(out)
        return out
    return call


@contextlib.contextmanager
def pallas_interpret():
    """The dense and cluster Pallas kernels in TPU interpret mode, each call
    finished before the caller dispatches anything else.

    In interpret mode a kernel's io_callbacks dispatch JAX ops of their own.
    When the caller has already queued more work behind the kernel (eager
    code such as `build_scene` runs on at once once its executables are
    cached), the CPU client can deadlock between the two."""
    mods = (pk, jcluster)
    saved = [(m._isect_call, m._anyhit_call) for m in mods]
    for m, (isect, anyhit) in zip(mods, saved):
        m._isect_call, m._anyhit_call = _finished(isect), _finished(anyhit)
    try:
        with pltpu.force_tpu_interpret_mode():
            yield
    finally:
        for m, (isect, anyhit) in zip(mods, saved):
            m._isect_call, m._anyhit_call = isect, anyhit


@pytest.fixture(scope="module")
def positions():
    ents, _ = build_cornell_box("boxes")
    return flatten(ents).positions


def _rays(seed, t_far_max):
    """N seeded rays inside the box; ~10% dead lanes (t_far = 0) plus the
    fully dead 2048-ray block [2048, 4096)."""
    rs = np.random.default_rng(seed)
    ro = rs.uniform(-4.9, 4.9, (3, N)).astype(np.float32)
    d = rs.normal(size=(3, N))
    rd = (d / np.linalg.norm(d, axis=0)).astype(np.float32)
    t_far = np.where(rs.random(N) < 0.1, 0.0, t_far_max).astype(np.float32)
    t_far[2048:] = 0.0
    t_near = np.zeros(N, np.float32)
    return ro, rd, t_near, t_far


def _torch_rays(ro, rd, t_far):
    return (V3(*(torch.from_numpy(c.copy()) for c in ro)),
            V3(*(torch.from_numpy(c.copy()) for c in rd)),
            torch.from_numpy(t_far))


def _bw_t_numpy(tris, ro, rd, tri):
    """t of each ray against its tri row, one float32 op at a time in the
    kernels' order; also (|d| + |n.o|) / |den|, the scale of the
    cancellation in num = d - n.o."""
    r = tris[np.maximum(tri, 0)].T  # [12, N]
    den = r[0] * rd[0] + r[1] * rd[1] + r[2] * rd[2]
    no = r[0] * ro[0] + r[1] * ro[1] + r[2] * ro[2]
    with np.errstate(divide="ignore", invalid="ignore"):
        t = (r[3] - no) / den
        cancel = (np.abs(r[3]) + np.abs(no)) / np.abs(den)
    return t, cancel


def test_pack_tris_bitwise(positions):
    np.testing.assert_array_equal(dk.pack_tris(positions), np.asarray(pk.pack_tris(positions)))
    np.testing.assert_array_equal(dk.bw_rows(positions), pk.bw_rows(positions))


@pytest.mark.parametrize("seed", [1, 2])
def test_dense_isect_plain_matches_pallas(positions, seed):
    ro, rd, t_near, t_far = _rays(seed, 1e6)
    tris = pk.pack_tris(positions)
    with pallas_interpret():
        jt, jtri = pk.intersect_pallas_raw(tris, jnp.asarray(ro.T), jnp.asarray(rd.T),
                                           jnp.asarray(t_near), jnp.asarray(t_far))
    tro, trd, tf = _torch_rays(ro, rd, t_far)
    t, tri = dk.dense_isect(torch.from_numpy(np.array(tris)), tro, trd, 0.0, tf)
    assert tri.dtype == torch.int32
    tri, t, jt = tri.numpy(), t.numpy(), np.asarray(jt)
    np.testing.assert_array_equal(tri, np.asarray(jtri))
    dead = t_far <= 0
    assert (tri[dead] == -1).all() and (t[dead] == -1.0).all()
    hit = tri >= 0
    assert hit[~dead].mean() > 0.5
    np.testing.assert_array_equal(t[~hit], -1.0)
    # the port computes each product and sum as its own float32 op, in the
    # kernel's order: t equals a numpy op-by-op evaluation bit for bit
    t_ref, cancel = _bw_t_numpy(np.asarray(tris), ro, rd, tri)
    np.testing.assert_array_equal(t[hit], t_ref[hit])
    # interpret mode runs the Pallas kernel through XLA:CPU, which contracts
    # n.o into FMAs; where num = d - n.o cancels, its t moves by a few ulp
    # of the cancelled terms (|d| + |n.o|) / |den|.  Seeds 1, 2, 7, 8, 9 put
    # 1-4 of ~1,850 hit lanes outside rtol 1e-6 (at most 9.5e-6 relative)
    # with a cancellation scale of at most 831 on any hit lane
    off = hit & (np.abs(t - jt) > 1e-6 * np.abs(jt))
    assert off.sum() <= 8
    assert cancel[hit].max() < 1e3
    bound = 1e-6 * np.abs(jt) + 4 * np.finfo(np.float32).eps * cancel
    assert (np.abs(t - jt)[off] <= bound[off]).all()


@pytest.mark.parametrize("seed,t_far_max", [(3, 3.0), (4, 1e6)])
def test_dense_anyhit_plain_matches_pallas(positions, seed, t_far_max):
    ro, rd, t_near, t_far = _rays(seed, t_far_max)
    tris = pk.pack_tris(positions)
    with pallas_interpret():
        jhit = pk.occluded_pallas(tris, jnp.asarray(ro.T), jnp.asarray(rd.T),
                                  jnp.asarray(t_near), jnp.asarray(t_far))
    tro, trd, tf = _torch_rays(ro, rd, t_far)
    flag = dk.dense_anyhit(torch.from_numpy(np.array(tris)), tro, trd, 0.0, tf)
    assert flag.dtype == torch.int32
    np.testing.assert_array_equal(flag.numpy() > 0, np.asarray(jhit))
    # dead lanes report 1 (blocked), as the reference kernel seeds them
    assert (flag.numpy()[t_far <= 0] == 1).all()
    occ = dk.occluded_dense(torch.from_numpy(np.array(tris)), tro, trd, 0.0, tf)
    np.testing.assert_array_equal(occ.numpy(), np.asarray(jhit))


def _late_blocker_rows(n, seed):
    """(rows [512, 12], ro, rd, t_far) as numpy: tie_soup's 400 triangles
    with the first chunk's 256 moved 1000 away on every axis, so that rays
    aimed at the base triangles meet blockers only in the second chunk."""
    soup, base = tie_soup(40, 10, seed=seed)
    tris = soup.reshape(-1, 3, 3).copy()
    tris[:256] += np.float32(1000.0)
    ro, rd, t_far = aimed_rays(base, n, seed=seed + 1)
    return dk.pack_tris(tris.reshape(-1, 3)), ro, rd, t_far


def _fma_flippable(rows, ro, rd, t_far):
    """[n] bool: rays with a row whose u, v, u + v or t lies within an
    FMA-contraction bound of its limit, where interpret mode (F5) may
    decide a compare the other way: 4 eps times the magnitudes of the
    terms summed, plus t's error (4 eps times its cancellation scale
    (|d| + |n.o|) / |den|, as in test_dense_isect_plain_matches_pallas)
    carried into u and v through U.dir and V.dir.  Float64 numpy."""
    r = rows.astype(np.float64)[:, :, None]  # [T, 12, 1]
    o = ro.astype(np.float64)[None]  # [1, 3, n]
    d = rd.astype(np.float64)[None]
    eps = 4 * np.finfo(np.float32).eps
    nrm = r[:, 0:3]
    with np.errstate(all="ignore"):
        t = (r[:, 3] - (nrm * o).sum(1)) / (nrm * d).sum(1)
        dt = (eps * (np.abs(r[:, 3]) + np.abs(nrm * o).sum(1)) / np.abs((nrm * d).sum(1))
              + eps * np.abs(t))
        p = o + t[:, None] * d

        def bary(k):  # (u, its bound) for k = 4, (v, its bound) for k = 8
            w, c = r[:, k : k + 3], r[:, k + 3]
            return ((w * p).sum(1) + c,
                    eps * (np.abs(w * p).sum(1) + np.abs(c)) + np.abs(w * d).sum(1) * dt)

        (u, eu), (v, ev) = bary(4), bary(8)
        near = ((np.abs(u) <= eu) | (np.abs(v) <= ev) | (np.abs(1.0 - u - v) <= eu + ev)
                | (np.abs(t) <= dt) | (np.abs(np.float64(t_far)[None] - t) <= dt))
    return near.any(axis=0)


@pytest.mark.parametrize("scene", ["tie", "late blocker"])
@pytest.mark.parametrize("scalar_t_far", [False, True])
def test_dense_anyhit_plain_matches_pallas_over_two_chunks(scene, scalar_t_far):
    """Two chunks of 256 rows: the Pallas kernel's early-exit while loop and
    the plain version's chunk loop give the same flags, but on rays that
    pass within the FMA-contraction bound of an edge or a limit
    (`_fma_flippable`: the tie scene aims rays at uniform points of its
    triangles, and a grazing one there has a cancellation scale of 1.4e5);
    those are at most 2 of the 1,024."""
    n = 1024
    if scene == "tie":
        rows, ro, rd, t_far = dc.tie_scene(40, 10, n, seed=21)
    else:
        rows, ro, rd, t_far = _late_blocker_rows(n, seed=41)
    assert rows.shape == (512, 12)
    if scalar_t_far:
        t_far = np.full(n, 1e6, np.float32)
    with pallas_interpret():
        jhit = pk.occluded_pallas(jnp.asarray(rows), jnp.asarray(ro.T), jnp.asarray(rd.T),
                                  jnp.zeros(n, jnp.float32), jnp.asarray(t_far))
    tro, trd, tf = _torch_rays(ro, rd, t_far)
    flag = dk.dense_anyhit(torch.from_numpy(rows), tro, trd, 0.0, 1e6 if scalar_t_far else tf)
    assert flag.dtype == torch.int32 and flag.shape == (n,)
    flippable = _fma_flippable(rows, ro, rd, t_far) & (t_far > 0)
    assert flippable.sum() <= 2
    np.testing.assert_array_equal((flag.numpy() > 0)[~flippable], np.asarray(jhit)[~flippable])
    assert (flag.numpy()[t_far <= 0] == 1).all()
    live = t_far > 0
    assert flag.numpy()[live].mean() > 0.5
    if scene == "late blocker":
        t, ok = dk._bw_test_plain(torch.from_numpy(rows), tro, trd, 0.0)
        blocks = (ok & (t < torch.from_numpy(t_far))).numpy()
        assert not blocks[:256].any() and blocks[256:].any(axis=0)[live].all()


class _FakeLib:
    """Stands in for the kernel library: each entry point records the
    arguments of its last call and returns 0."""

    def __init__(self):
        self.calls = {}

    def __getattr__(self, name):
        calls = self.calls

        class Fn:
            def __call__(self, *args):
                calls[name] = args
                return 0

        fn = Fn()
        setattr(self, name, fn)
        return fn


def test_anyhit_warp_below_goes_through_the_argtypes(positions, monkeypatch):
    """The wrapper hands pim_dense_anyhit ANYHIT_WARP_BELOW as the C int
    after n, every argument matches native.bind's argtypes, and the launch
    counts once (meta tensors stand in for CUDA ones)."""
    lib = _FakeLib()
    native.bind(lib)
    monkeypatch.setattr(native, "load", lambda: lib)
    monkeypatch.setattr(native, "stream_ptr", lambda dev: 0)
    monkeypatch.setitem(native.launches, "dense_anyhit", 0)
    ro, rd, _, t_far = _rays(7, 3.0)
    meta = torch.device("meta")
    tro, trd, tf = (x.to(meta) if torch.is_tensor(x) else V3(*(c.to(meta) for c in x))
                    for x in _torch_rays(ro, rd, t_far))
    tris = torch.from_numpy(dk.pack_tris(positions)).to(meta)
    for t_far_arg in (tf, 3.0):
        hit = dk.dense_anyhit(tris, tro, trd, 0.0, t_far_arg)
        assert hit.shape == (N,) and hit.dtype == torch.int32
        args, types = lib.calls["pim_dense_anyhit"], lib.pim_dense_anyhit.argtypes
        assert len(args) == len(types) == 15
        for argtype, arg in zip(types, args):
            argtype.from_param(arg)
        assert types[11:14] == [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        assert args[11:13] == (N, dk.ANYHIT_WARP_BELOW)
    assert native.launches["dense_anyhit"] == 2
    # a tile holds 512 rays: 0 and 513 force the two forms
    assert dc.K2_FORMS == {"ray a thread": 0, "ray a warp": 513}
    assert 0 < dk.ANYHIT_WARP_BELOW <= 512


@pytest.mark.parametrize("fn", [dk.dense_isect, dk.dense_anyhit])
def test_scalar_t_far_equals_per_ray_t_far(positions, fn):
    ro, rd, _, _ = _rays(6, 3.0)
    tro, trd, _ = _torch_rays(ro, rd, np.zeros(N, np.float32))
    tris = torch.from_numpy(dk.pack_tris(positions))
    out_s = fn(tris, tro, trd, 0.0, 3.0)
    out_t = fn(tris, tro, trd, 0.0, torch.full((N,), 3.0))
    for a, b in zip(out_s if isinstance(out_s, tuple) else (out_s,),
                    out_t if isinstance(out_t, tuple) else (out_t,)):
        assert a.shape == (N,)
        np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_ray_args_pass_t_far_as_pointer_or_value(positions):
    ro, rd, _, t_far = _rays(7, 3.0)
    tro, trd, tf = _torch_rays(ro, rd, t_far)
    tris = torch.from_numpy(dk.pack_tris(positions))
    n, args = dk._ray_args(tris, tro, trd, 0.0, 3.0, "k")
    assert n == N and args[6:] == [0.0, None, 3.0]
    _, args = dk._ray_args(tris, tro, trd, 0.0, tf, "k")
    assert args[6:] == [0.0, tf.data_ptr(), 0.0]
    with pytest.raises(TypeError):
        dk._ray_args(tris, tro, trd, torch.zeros(N), tf, "k")
    with pytest.raises(ValueError):
        dk._ray_args(tris, tro, trd, 0.0, tf[:-1], "k")


def _gated_table(rs, f, t):
    """Adversarial float32 inside the Pallas gather's exact domain."""
    mant = rs.integers(0, 1 << 24, (f, t)).astype(np.float32)
    expo = np.exp2(rs.integers(-40, 40, (f, t)).astype(np.float32))
    sign = np.where(rs.random((f, t)) < 0.5, -1.0, 1.0).astype(np.float32)
    vals = (sign * mant * expo).astype(np.float32).reshape(-1)
    vals[rs.integers(0, vals.size, vals.size // 16)] = 0.0
    vals[rs.integers(0, vals.size, vals.size // 32)] = 3.0e38
    vals[rs.integers(0, vals.size, vals.size // 32)] = 2.0**-99
    return vals.reshape(f, t)


@pytest.mark.parametrize("f,t,n", [(48, 108, N), (38, 343, N), (24, 12, 3000), (48, 900, 3000)])
def test_gather_cols_plain_matches_pallas_bitwise(f, t, n):
    rs = np.random.default_rng(f * 1000 + t)
    table = _gated_table(rs, f, t)
    idx = rs.integers(-3, t + 3, n).astype(np.int32)
    idx[:2] = [-1, t]
    ref = np.asarray(gather_cols_pallas(jnp.asarray(table), jnp.asarray(idx), interpret=True))
    for dtype in (torch.int32, torch.int64):
        out = gk.gather_cols(torch.from_numpy(table), torch.from_numpy(idx).to(dtype))
        np.testing.assert_array_equal(out.numpy().view(np.int32), ref.view(np.int32))


def test_cpu_wrappers_take_the_plain_path_and_count_nothing(positions):
    ro, rd, t_near, t_far = _rays(5, 1e6)
    tro, trd, tf = _torch_rays(ro, rd, t_far)
    tris = torch.from_numpy(dk.pack_tris(positions))
    before = dict(native.launches)
    dk.dense_isect(tris, tro, trd, 0.0, tf)
    dk.dense_anyhit(tris, tro, trd, 0.0, tf)
    gk.gather_cols(torch.ones(3, 4), torch.zeros(5, dtype=torch.int64))
    assert native.launches == before


@pytest.mark.parametrize("bad", ["dtype", "shape", "contiguity", "device"])
def test_require_cuda_rejects_bad_inputs(bad):
    good = torch.zeros(8, 12)
    t = {"dtype": good.double(), "shape": good[:4], "contiguity": good.T.contiguous().T,
         "device": good.to("meta")}[bad]
    with pytest.raises((TypeError, ValueError)):
        native.require_cuda("x", t, torch.float32, (8, 12), torch.device("cpu"))
    native.require_cuda("x", good, torch.float32, (8, 12), torch.device("cpu"))


def test_build_flags_keep_ieee_float32():
    flags = " ".join(native.NVCC_FLAGS)
    assert "--fmad=false" in flags and "fast_math" not in flags and "sm_90a" in flags
    assert len(native.source_hash()) == 16
    for src in native.SOURCES:
        with open(f"{native.CSRC}/{src}") as fh:
            head = fh.read(2000)
        assert "Replaces:" in head and "What bounds it" in head and "What the design" in head


@pytest.mark.parametrize("name,group", [
    ("void (anonymous namespace)::dense_isect_kernel(float const*, int, ...)", "K1 dense_isect"),
    ("void (anonymous namespace)::dense_anyhit_kernel(float const*, int, ...)", "K2 dense_anyhit"),
    ("void (anonymous namespace)::gather_cols_kernel<int>(float const*, ...)", "K3 gather_cols"),
    ("void at::native::index_elementwise_kernel<128, 4, ...>", "torch index/gather/scatter"),
    ("void at::native::vectorized_elementwise_kernel<4, at::native::AddFunctor>", "torch elementwise"),
    ("void at::native::reduce_kernel<512, 1, ...>", "torch reduce"),
    ("Memcpy DtoD (Device -> Device)", "other"),
])
def test_prof_frame_sorts_kernels_into_groups(name, group):
    assert prof_frame.kernel_group(name) == group
