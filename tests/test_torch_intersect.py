"""The Moller-Trumbore backends (`brute`, `bvh`) against `pim_tpu.render.intersect`.

Soups: a random one (300 triangles), the Cornell "boxes" and "spheres"
soups, and a tie soup (40 distinct triangles, 20 coincident copies of
each, shuffled, so equal t in different chunks and leaves).  Rays: 1,024
seeded lanes, about 10% dead (t_far = 0), the others to 1e6; the any-hit
forms to t_far = 3.  Both packages build the tree with their numpy builder
(the native ones are held bit for bit in test_torch_bvh.py).

Tolerances (XLA:CPU contracts FMAs, ROADMAP F5): tri and the any-hit flag
equal on every lane but at most 2 of the 1,024, and those only where a
compare is FMA-flippable (`tools/mt_check.py::flippable`: a triangle's
u, v or u + v within 1e-4 of its limit, its t within rtol 1e-5 of t_far,
or two valid triangles' t within rtol 1e-5, in float64); where tri agrees, t within
rtol 1e-5 (2.3e-6 seen) and u and v within atol 1e-4, or each within 4 eps
of its cancellation scale on a grazing ray (`_check_mt`; the tie soup's
rays, aimed at its triangles, reach 2.3e-5 in t and 3e-4 in u), and the
normal within atol 1e-5.  The port's bvh equals its own brute in tri off the tie soup, and
its dead lanes miss.  The scenes: `from_jax_scene` of a JAX `brute` and
`bvh` scene, and a 32^2, 3-bounce frame of each (Cornell `brute`,
"spheres" `bvh`) against the JAX frame by test_torch_frame.py's rule."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pim_tpu.core import rng as jrng
from pim_tpu.geom import bvh as jbvh
from pim_tpu.geom.cornell import build_cornell_box as jax_cornell
from pim_tpu.geom.entities import flatten
from pim_tpu.render import camera as jcam
from pim_tpu.render import integrator as jint
from pim_tpu.render import intersect as jisect
from pim_tpu.render.scene import build_scene as jax_build_scene
from pim_tpu_torch import native
from pim_tpu_torch.core import rng
from pim_tpu_torch.geom import bvh
from pim_tpu_torch.geom.cornell import build_cornell_box
from pim_tpu_torch.math.vec3 import V3
from pim_tpu_torch.render import camera, integrator
from pim_tpu_torch.render import intersect as isect
from pim_tpu_torch.render.scene import build_scene, from_jax_scene, scene_intersect
from pim_tpu_torch.tools import mt_check

torch.set_num_threads(2)

N = 1024
MAX_FLIPS = 2


def _soup(n_tris: int, seed: int = 7) -> np.ndarray:
    rs = np.random.default_rng(seed)
    base = rs.uniform(-4, 4, (n_tris, 1, 3)).astype(np.float32)
    offs = rs.uniform(-0.4, 0.4, (n_tris, 3, 3)).astype(np.float32)
    return (base + offs).reshape(-1, 3)


def _tie_soup() -> np.ndarray:
    tris = _soup(40, seed=5).reshape(40, 3, 3)
    copies = np.repeat(tris, 20, axis=0)
    return np.ascontiguousarray(copies[np.random.default_rng(9).permutation(800)].reshape(-1, 3))


@functools.lru_cache(maxsize=None)
def _positions(name: str) -> np.ndarray:
    if name == "random":
        return _soup(300, seed=3)
    if name == "tie":
        return _tie_soup()
    return flatten(jax_cornell(name)[0]).positions


@functools.lru_cache(maxsize=None)
def _rays(name: str):
    """Seeded rays from inside the soup's box: (ro [N, 3], rd [N, 3], t_far [N])."""
    pos = _positions(name)
    rs = np.random.default_rng(11)
    lo, hi = pos.min(0), pos.max(0)
    ro = (lo + (hi - lo) * rs.random((N, 3))).astype(np.float32)
    if name == "tie":  # aim at the triangles, so most rays meet a tie
        tris = pos.reshape(-1, 3, 3)
        w = rs.dirichlet(np.ones(3), N).astype(np.float32)
        target = np.einsum("nk,nkd->nd", w, tris[rs.integers(0, len(tris), N)])
        rd = target - ro
    else:
        rd = rs.normal(size=(N, 3)).astype(np.float32)
    rd = (rd / np.linalg.norm(rd, axis=-1, keepdims=True)).astype(np.float32)
    t_far = np.where(rs.random(N) < 0.1, 0.0, 1e6).astype(np.float32)
    return ro, rd, t_far


def _torch_rays(ro, rd):
    return (V3(*(torch.from_numpy(np.ascontiguousarray(c)) for c in ro.T)),
            V3(*(torch.from_numpy(np.ascontiguousarray(c)) for c in rd.T)))


@functools.lru_cache(maxsize=None)
def _trees(name: str):
    pos = _positions(name)
    jt = jbvh.build_bvh_numpy(pos)
    pt = bvh.build_bvh_numpy(pos)
    return jt, bvh.BvhArrays(*(torch.from_numpy(x) for x in pt))


def _check_flips(got, want, pos, ro, rd, t_far):
    """Lanes where `got` != `want`: at most MAX_FLIPS, each flippable."""
    bad = np.nonzero(got != want)[0]
    assert len(bad) <= MAX_FLIPS, (len(bad), bad[:10])
    if len(bad):
        assert mt_check.flippable(*(torch.from_numpy(np.ascontiguousarray(x)) for x in (
            pos, ro[bad], rd[bad], t_far[bad]))).all(), bad
    return got == want


def _mag_cross(a, b):
    """Componentwise |a_y b_z| + |a_z b_y|, ...: the magnitudes summed in
    cross(a, b)."""
    return np.stack(
        [np.abs(a[..., 1] * b[..., 2]) + np.abs(a[..., 2] * b[..., 1]),
         np.abs(a[..., 2] * b[..., 0]) + np.abs(a[..., 0] * b[..., 2]),
         np.abs(a[..., 0] * b[..., 1]) + np.abs(a[..., 1] * b[..., 0])], -1)


def _check_mt(field, got, want, tri, pos, ro, rd, **tol):
    """`field` ('t', 'u' or 'v') within `tol`, or within 4 eps of its
    cancellation scale where the ray grazes its triangle: the magnitudes
    summed in its dot product (crosses included) and in det, over |det|
    (float64), as F5 bounds K4's t."""
    off = ~np.isclose(got, want, **tol)
    if not off.any():
        return
    tris = pos.astype(np.float64).reshape(-1, 3, 3)[tri[off]]
    a, e1, e2 = tris[:, 0], tris[:, 1] - tris[:, 0], tris[:, 2] - tris[:, 0]
    d = rd[off].astype(np.float64)
    tv = ro[off].astype(np.float64) - a
    p, q = np.cross(d, e2), np.cross(tv, e1)
    mp, mq = _mag_cross(d, e2), _mag_cross(tv, e1)
    x, mx = {"t": (e2, mq), "u": (tv, mp), "v": (d, mq)}[field]
    y = p if field == "u" else q
    det = np.abs(np.sum(e1 * p, -1))
    val = np.abs(np.sum(x * y, -1)) / det
    scale = (np.sum(np.abs(x) * (mx + np.abs(y)), -1)
             + val * np.sum(np.abs(e1) * (mp + np.abs(p)), -1)) / det
    bound = 4 * np.finfo(np.float32).eps * scale
    assert (np.abs(got[off] - want[off]) <= bound).all(), (field, got[off], want[off], bound)


def _jax_hit(backend, name, ro, rd, t_far):
    pos = jnp.asarray(_positions(name))
    args = (jnp.asarray(ro), jnp.asarray(rd), 0.0, jnp.asarray(t_far))
    if backend == "brute":
        return jisect.intersect_brute(pos, *args)
    return jisect.intersect_bvh(_trees(name)[0], pos, *args)


def _port_hit(backend, name, ro, rd, t_far):
    pos = torch.from_numpy(_positions(name))
    tro, trd = _torch_rays(ro, rd)
    if backend == "brute":
        return isect.intersect_brute(pos, tro, trd, 0.0, torch.from_numpy(t_far))
    return isect.intersect_bvh(_trees(name)[1], pos, tro, trd, 0.0, torch.from_numpy(t_far))


SOUPS = ("random", "boxes", "spheres", "tie")


@pytest.mark.parametrize("backend", ["brute", "bvh"])
@pytest.mark.parametrize("name", SOUPS)
def test_closest_hit_matches_reference(backend, name):
    ro, rd, t_far = _rays(name)
    jh = _jax_hit(backend, name, ro, rd, t_far)
    ph = _port_hit(backend, name, ro, rd, t_far)
    assert ph.tri.dtype == torch.int32 and ph.t.shape == (N,)
    same = _check_flips(ph.tri.numpy(), np.asarray(jh.tri), _positions(name), ro, rd, t_far)
    assert (ph.tri.numpy() >= 0).sum() > 0.05 * N
    args = (ph.tri.numpy()[same], _positions(name), ro[same], rd[same])
    _check_mt("t", ph.t.numpy()[same], np.asarray(jh.t)[same], *args, rtol=1e-5, atol=0.0)
    for f in ("u", "v"):
        _check_mt(f, getattr(ph, f).numpy()[same], np.asarray(getattr(jh, f))[same], *args,
                  rtol=0.0, atol=1e-4)
    np.testing.assert_array_equal(ph.backface.numpy()[same], np.asarray(jh.backface)[same])
    for got, want in zip(ph.ng, jh.ng):
        np.testing.assert_allclose(got.numpy()[same], np.asarray(want)[same], atol=1e-5)
    dead = t_far <= 0.0
    assert (ph.tri.numpy()[dead] == -1).all() and (ph.t.numpy()[dead] == -1.0).all()


@pytest.mark.parametrize("backend", ["brute", "bvh"])
@pytest.mark.parametrize("name", SOUPS)
def test_any_hit_matches_reference(backend, name):
    ro, rd, t_far = _rays(name)
    t_far = np.where(t_far > 0.0, 3.0, 0.0).astype(np.float32)
    pos = _positions(name)
    args = (jnp.asarray(ro), jnp.asarray(rd), 0.0, jnp.asarray(t_far))
    tro, trd = _torch_rays(ro, rd)
    tp = torch.from_numpy(pos)
    if backend == "brute":
        want = np.asarray(jisect.occluded_brute(jnp.asarray(pos), *args))
        flag = isect.brute_anyhit(tp, tro, trd, 0.0, torch.from_numpy(t_far))
    else:
        want = np.asarray(jisect.occluded_bvh(_trees(name)[0], jnp.asarray(pos), *args))
        flag = isect.bvh_anyhit(_trees(name)[1], tp, tro, trd, 0.0, torch.from_numpy(t_far))
    assert flag.dtype == torch.int32 and flag.shape == (N,)
    _check_flips(flag.numpy() > 0, want, pos, ro, rd, t_far)
    assert 0.02 * N < int(flag.sum()) < 0.98 * N
    assert (flag.numpy()[t_far <= 0.0] == 0).all()  # a dead ray is never blocked


@pytest.mark.parametrize("name", ["random", "boxes", "spheres"])
def test_bvh_equals_brute_in_tri(name):
    """Off ties the walk finds the triangle the scan finds, bit for bit in
    t; one t_far for all rays takes the same path as a tensor of it."""
    ro, rd, _ = _rays(name)
    pos = torch.from_numpy(_positions(name))
    tro, trd = _torch_rays(ro, rd)
    b = isect.brute_isect(pos, tro, trd, 0.0, 1e6)
    v = isect.bvh_isect(_trees(name)[1], pos, tro, trd, 0.0, 1e6)
    for x, y in zip(b, v):
        assert torch.equal(x, y)
    vt = isect.bvh_isect(_trees(name)[1], pos, tro, trd, 0.0, torch.full((N,), 1e6))
    for x, y in zip(v, vt):
        assert torch.equal(x, y)


def test_tie_soup_keeps_the_reference_tie_rules():
    """Equal t (20 coincident copies of each triangle): the scan keeps the
    lowest index, the walk the first slot it reaches; each equals its
    reference on every lane."""
    ro, rd, t_far = _rays("tie")
    for b in ("brute", "bvh"):
        ph, jh = _port_hit(b, "tie", ro, rd, t_far), _jax_hit(b, "tie", ro, rd, t_far)
        np.testing.assert_array_equal(ph.tri.numpy(), np.asarray(jh.tri), err_msg=b)
        assert (ph.tri.numpy() >= 0).sum() > 0.5 * N


def test_walk_counts_its_work():
    ro, rd, t_far = _rays("spheres")
    counts = {}
    tro, trd = _torch_rays(ro, rd)
    isect.bvh_walk_plain(_trees("spheres")[1], torch.from_numpy(_positions("spheres")), tro, trd,
                         0.0, torch.from_numpy(t_far), 4, False, counts)
    live = int((t_far > 0).sum())
    assert counts["nodes"] >= live and counts["tris"] >= int((_port_hit(
        "bvh", "spheres", ro, rd, t_far).tri >= 0).sum())
    assert counts["entries"] % 2 == 0 and counts["distinct_tris"] <= counts["tris"]
    assert counts["distinct_nodes"] <= len(_trees("spheres")[1].node_a)


def test_empty_scene_misses():
    pos = torch.zeros((0, 3))
    ro, rd, _ = _rays("random")
    tro, trd = _torch_rays(ro[:8], rd[:8])
    tree = bvh.BvhArrays(*(torch.from_numpy(x) for x in bvh.build_bvh_numpy(pos.numpy())))
    for h in (isect.intersect_brute(pos, tro, trd, 0.0, 5.0),
              isect.intersect_bvh(tree, pos, tro, trd, 0.0, 5.0)):
        assert (h.tri == -1).all() and (h.t == -1.0).all()
    assert not isect.occluded_bvh(tree, pos, tro, trd, 0.0, 5.0).any()


def test_wrappers_run_the_plain_versions_on_the_cpu():
    ro, rd, t_far = _rays("boxes")
    pos = torch.from_numpy(_positions("boxes"))
    tro, trd = _torch_rays(ro, rd)
    before = dict(native.launches)
    for w, p in ((isect.brute_isect, isect.brute_isect_plain),
                 (isect.brute_anyhit, isect.brute_anyhit_plain)):
        for x, y in zip(*(f(pos, tro, trd, 0.0, torch.from_numpy(t_far)) for f in (w, p))):
            assert torch.equal(x, y)
    assert native.launches == before


# ---------------------------------------------------------------------------
# scenes and frames
# ---------------------------------------------------------------------------

W = H = 32
BOUNCES = 3
SAMPLE = 5
SCENES = {"cornell_brute": ("boxes", "brute"), "spheres_bvh": ("spheres", "bvh")}


@functools.lru_cache(maxsize=None)
def _scenes(key):
    variant, backend = SCENES[key]
    jm, ja, jl = jax_build_scene(*jax_cornell(variant), backend=backend)
    port = from_jax_scene(dataclasses.asdict(jm),
                          {k: np.asarray(v) for k, v in ja._asdict().items()},
                          {k: np.asarray(v) for k, v in jl._asdict().items()}, "cpu")
    return (jm, ja, jl), port


@pytest.mark.parametrize("key", list(SCENES))
def test_from_jax_scene_carries_the_mt_backends(key):
    (jm, ja, _), (m, a, _) = _scenes(key)
    assert m.backend == jm.backend == SCENES[key][1] and m.max_leaf == jm.max_leaf == 4
    for ours, theirs in (("bvh_lo", "bvh_lo"), ("bvh_hi", "bvh_hi"), ("bvh_a", "bvh_a"),
                         ("bvh_b", "bvh_b"), ("tri_order", "tri_order"),
                         ("positions", "positions")):
        np.testing.assert_array_equal(getattr(a, ours).numpy(), np.asarray(getattr(ja, theirs)))
    ro, rd, t_far = _rays(SCENES[key][0])
    tro, trd = _torch_rays(ro, rd)
    hit = scene_intersect(m, a, tro, trd, 0.0, torch.from_numpy(t_far))
    want = _jax_hit(m.backend, SCENES[key][0], ro, rd, t_far) if m.backend == "brute" else \
        jisect.intersect_bvh(jbvh.BvhArrays(ja.bvh_lo, ja.bvh_hi, ja.bvh_a, ja.bvh_b,
                                            ja.tri_order), ja.positions, jnp.asarray(ro),
                             jnp.asarray(rd), 0.0, jnp.asarray(t_far))
    _check_flips(hit.tri.numpy(), np.asarray(want.tri), _positions(SCENES[key][0]), ro, rd,
                 t_far)


def test_build_scene_takes_the_mt_backends():
    ents, pool = build_cornell_box("boxes")
    m, a, _ = build_scene(ents, pool, "cpu", backend="bvh")
    assert m.backend == "bvh" and a.bvh_a.shape[0] == 65 and a.tri_order.shape == (108,)
    m, a, _ = build_scene(ents, pool, "cpu", backend="brute")
    assert m.backend == "brute" and a.bvh_a.shape == (1,) and a.tri_order.shape == (0,)
    with pytest.raises(ValueError, match="'brute' and 'bvh'"):
        build_scene(ents, pool, "cpu", backend="pallas")


@functools.lru_cache(maxsize=None)
def _frames(key):
    (jm, ja, jl), (m, a, l) = _scenes(key)
    jc = jcam.Camera(position=np.array([-4, 0, 4], np.float32))
    jc.look_at([0, -1, 0])
    jca = jcam.camera_arrays(jc, jcam.DofInfo(autofocus=False), W, H)
    tc = camera.Camera(position=np.array([-4, 0, 4], np.float32))
    tc.look_at([0, -1, 0])
    tca = camera.camera_arrays(tc, camera.DofInfo(autofocus=False), W, H)
    js = jrng.make_state(jnp.arange(W * H, dtype=jnp.uint32), SAMPLE)
    js, jro, jrd = jcam.generate_primary_rays(jca, W, H, js)
    jres = jax.jit(lambda a_, l_, ro, rd, s: jint.trace_rays(jm, a_, l_, ro, rd, s, BOUNCES))(
        ja, jl, jro, jrd, js)
    ts = rng.make_state(torch.arange(W * H), SAMPLE)
    ts, tro, trd = camera.generate_primary_rays(tca, W, H, ts)
    return jax.block_until_ready(jres), integrator.trace_rays(m, a, l, tro, trd, ts, BOUNCES)


@pytest.mark.parametrize("key", list(SCENES))
def test_frame_matches_the_reference_backend(key):
    jres, tres = _frames(key)
    jc, tc = np.asarray(jres.color), tres.color.numpy()
    assert tc.shape == jc.shape == (W * H, 3) and np.isfinite(tc).all()
    close = np.all(np.isclose(tc, jc, rtol=1e-4, atol=1e-5), axis=-1)
    assert close.mean() >= 0.97, close.mean()
    jmean, tmean = float(jc.mean()), float(tc.mean())
    assert jmean > 0 and abs(tmean - jmean) <= 0.02 * jmean
    jr, tr = float(jres.rays_traced), float(tres.rays_traced)
    assert abs(tr - jr) <= 0.01 * jr
