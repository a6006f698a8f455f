"""The differentiable path: `pim_tpu_torch.render.diff` against
`pim_tpu.render.diff` on the same scenes, parameters and seed.

The JAX side is its `brute` backend, as tests/test_grad.py builds it; the
port builds the same entities itself (dense backend, the kernels' plain
versions on the CPU; Cornell also with the port's own `brute` backend,
`cornell_brute`, like for like) and takes the JAX light state, so both
select the same lights.  Criteria:
  - `apply_params`' grafts (tri table, emissive table, camera) bit for bit;
  - the 16^2, 3-bounce, seed-7 colour: 99% of the values within rtol 1e-4 /
    atol 1e-6 and all within rtol 1e-2 / atol 1e-5 (BW against
    Moller-Trumbore t at ulp level moves a few paths slightly);
  - per-group directional derivatives of the port's autograd against
    `jax.grad`, within rtol 1e-3 of each other (float sums in another
    order through one-hot matmuls against index_add_): albedo, rome,
    emission and camera on Cornell; sun direction and luminance on the open
    sky scene of test_grad.py; the atlas on the small textured map of
    test_torch_map_frame.py, along its albedo-texture texels (the JAX brute
    backend's gradient in the directions of rays is NaN on that map: it
    differentiates Moller-Trumbore against every triangle, and parallel
    ones give 0 * inf; the port differentiates the hit triangle's only);
  - one Adam step against `optax.adam` on the same gradients (the updates
    within rtol 2e-5: optax forms its bias correction 1 - 0.999 in float32,
    1.3e-5 away from torch's float64 one);
  - the port's own AD against central finite differences on the eps ladder
    of test_grad.py (`slow` where the JAX tests are).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pim_tpu.geom.cornell import build_cornell_box as jax_cornell
from pim_tpu.render import diff as jdiff
from pim_tpu.render.camera import Camera as JCamera
from pim_tpu.render.camera import DofInfo as JDofInfo
from pim_tpu.render.camera import camera_arrays as jcamera_arrays
from pim_tpu.render.scene import build_scene as jax_build_scene
from pim_tpu.render.sky import bake_sky_cubemap, earth_atmosphere
from pim_tpu_torch.geom import entities as pents
from pim_tpu_torch.geom import material as pmat
from pim_tpu_torch.geom import mesh as pmesh
from pim_tpu_torch.geom.cornell import build_cornell_box
from pim_tpu_torch.render import camera, diff
from pim_tpu_torch.render.scene import LightState, build_scene

torch.set_num_threads(2)

W = H = 16
BOUNCES = 3
SEED = 7
GROUPS = diff.DiffParams._fields


def to_port_scene(ents, pool):
    """A JAX package (Entities, TexturePool) as the port's own objects."""
    out = pents.Entities()
    tex = pmat.TexturePool()
    for i in range(len(pool)):
        tex.add(pool.get(i))
    for i in range(ents.count):
        k = out.add(ents.names[i])
        m = ents.meshes[i]
        out.meshes[k] = None if m is None else pmesh.MeshData(m.positions, m.normals, m.uvs)
        mt = ents.materials[i]
        out.materials[k] = pmat.Material(
            albedo_tex=mt.albedo_tex, rome_tex=mt.rome_tex, normal_tex=mt.normal_tex,
            flags=int(mt.flags), ior=mt.ior, mean_free_path=tuple(mt.mean_free_path),
            bumpiness=mt.bumpiness)
        out.translations[k] = np.asarray(ents.translations[i], np.float32)
        out.rotations[k] = np.asarray(ents.rotations[i], np.float32)
        out.scales[k] = np.asarray(ents.scales[i], np.float32)
    return out, tex


class Case:
    """One scene on both sides: the JAX (meta, arrays, lights, camera,
    params, loss) and the port's, the JAX gradient, and the port's."""

    def __init__(self, jents, jpool, pents_pool, eye, at, sky=None, sky_steps=16,
                 sun_dir=(0.0, 1.0, 0.0), sun_lum=(1.0, 1.0, 1.0), port_backend="dense",
                 jax_case=None):
        if jax_case is not None:  # the same JAX scene, loss and gradient
            for name in ("jm", "ja", "jl", "jcam", "jparams", "jloss", "jargs"):
                setattr(self, name, getattr(jax_case, name))
            self.jgrad = jax_case.jgrad
        else:
            self.jm, self.ja, self.jl = jax_build_scene(jents, jpool, backend="brute", sky=sky)
            jc = JCamera(position=np.array(eye, np.float32))
            jc.look_at(list(at))
            self.jcam = jcamera_arrays(jc, JDofInfo(autofocus=False), W, H)
            self.jparams = jdiff.extract_params(self.jm, self.ja, self.jcam, sun_dir=sun_dir,
                                                sun_lum=sun_lum)
            self.jloss = jax.jit(jdiff.make_loss_fn(self.jm, W, H, max_bounces=BOUNCES,
                                                    sky_steps=sky_steps))
            self.jargs = (self.ja, self.jl, self.jcam, jnp.zeros((W * H, 3), jnp.float32),
                          jnp.uint32(SEED))

        m, a, _ = build_scene(*pents_pool, "cpu", backend=port_backend,
                              sky=None if sky is None else torch.from_numpy(sky))
        jl = self.jl
        self.lights = LightState(
            pdf=torch.from_numpy(np.asarray(jl.pdf)), cdf=torch.from_numpy(np.asarray(jl.cdf)),
            integral=torch.from_numpy(np.asarray(jl.integral)),
            sum=torch.from_numpy(np.asarray(jl.sum).astype(np.int64)),
            live=torch.from_numpy(np.asarray(jl.live).astype(np.int64)))
        self.meta = m
        self.arrays = dataclasses.replace(
            a, cell_active=torch.from_numpy(np.asarray(self.ja.cell_active)),
            cell_active_f=torch.from_numpy(np.asarray(self.ja.cell_active_f)))
        tc = camera.Camera(position=np.array(eye, np.float32))
        tc.look_at(list(at))
        self.cam = camera.camera_arrays(tc, camera.DofInfo(autofocus=False), W, H)
        self.sky_steps = sky_steps
        self.loss = diff.make_loss_fn(m, W, H, max_bounces=BOUNCES, sky_steps=sky_steps)
        self.args = (self.arrays, self.lights, self.cam, torch.zeros(W * H, 3), SEED)
        self._jgrad = self._pgrad = None

    def params(self, requires_grad=False) -> diff.DiffParams:
        p = diff.from_jax_params(self.jparams, "cpu")
        for x in p:
            x.requires_grad_(requires_grad)
        return p

    def jgrad(self):
        if self._jgrad is None:
            g = jax.grad(lambda p: self.jloss(p, *self.jargs)[0])(self.jparams)
            self._jgrad = [np.asarray(x, np.float64) for x in g]
        return self._jgrad

    def pgrad(self):
        if self._pgrad is None:
            p = self.params(True)
            self.loss(p, *self.args)[0].backward()
            self._pgrad = [np.zeros(x.shape) if x.grad is None else x.grad.numpy().astype(np.float64)
                           for x in p]
        return self._pgrad


def _cornell_eye():
    return (-4.0, 0.0, 4.0), (0.0, -1.0, 0.0)


@pytest.fixture(scope="module")
def cornell():
    eye, at = _cornell_eye()
    return Case(*jax_cornell("boxes"), build_cornell_box("boxes"), eye, at)


@pytest.fixture(scope="module")
def cornell_brute(cornell):
    """The port's `brute` Cornell scene against the JAX `brute` scene, loss
    and gradient of `cornell`: both differentiate Moller-Trumbore."""
    eye, at = _cornell_eye()
    return Case(None, None, build_cornell_box("boxes"), eye, at, port_backend="brute",
                jax_case=cornell)


def _sky_scene():
    """tests/test_grad.py's open scene: floor, one block and an emissive
    slab under the sun."""
    from pim_tpu.geom.cornell import _gen_material
    from pim_tpu.geom.entities import Entities
    from pim_tpu.geom.material import TexturePool
    from pim_tpu.geom.mesh import gen_box_mesh

    ents = Entities()
    pool = TexturePool()
    box = gen_box_mesh()

    def add(name, t, s, albedo, rome):
        i = ents.add(name)
        ents.meshes[i] = box
        ents.materials[i] = _gen_material(pool, albedo, rome)
        ents.translations[i] = np.asarray(t, np.float32)
        ents.scales[i] = np.asarray(s, np.float32)

    add("floor", [0, -1, 0], [20, 0.1, 20], (0.8, 0.8, 0.8, 1), (0.7, 1, 0, 0))
    add("block", [0, 0.5, 0], [1, 1.5, 1], (0.7, 0.3, 0.2, 1), (0.4, 1, 0, 0))
    add("lamp", [2, 1, 2], [0.5, 0.5, 0.5], (1, 1, 1, 1), (0.9, 1, 0, 0.8))
    return ents, pool


@pytest.fixture(scope="module")
def sky_case():
    ents, pool = _sky_scene()
    sun_dir = np.array([0.3, 0.9, 0.1], np.float32)
    sun_dir /= np.linalg.norm(sun_dir)
    sun_lum = np.array([1.2, 1.1, 1.0], np.float32)
    sky = np.asarray(bake_sky_cubemap(earth_atmosphere(), sun_dir, sun_lum, 8, 16))
    return Case(ents, pool, to_port_scene(ents, pool), (-5.0, 1.5, -5.0), (0.0, 0.0, 0.0),
                sky=sky, sky_steps=16, sun_dir=sun_dir, sun_lum=sun_lum)


@pytest.fixture(scope="module")
def map_case():
    from pim_tpu.geom.maps import build_map_scene

    ents, pool = build_map_scene(rooms=(1, 1), spheres_per_room=2, sphere_steps=8, tex_size=8,
                                 seed=2)
    sun_dir = np.asarray([0.35, 0.82, 0.45], np.float32)
    sun_dir /= np.linalg.norm(sun_dir)
    sun_lum = np.full(3, 120.0, np.float32)
    sky = np.asarray(bake_sky_cubemap(earth_atmosphere(), sun_dir, 120.0, 16, 4), np.float32)
    return Case(ents, pool, to_port_scene(ents, pool), (-2.2, 1.7, -2.2), (1.5, 1.0, 1.5),
                sky=sky, sky_steps=4, sun_dir=sun_dir, sun_lum=sun_lum)


def _albedo_texels(case) -> np.ndarray:
    """[4, H*W] direction: 1 on the rgb of every texel of a texture that
    some material uses as its albedo texture (and as nothing else)."""
    atlas_w = int(np.asarray(case.ja.tex_rec_t)[4, 0])
    rec = np.asarray(case.ja.tex_rec_t)[:4].T.astype(np.int64)
    tt = np.asarray(case.ja.tri_table)
    albedo = set(tt[38][tt[38] >= 0].astype(int))
    other = set(tt[39][tt[39] >= 0].astype(int)) | set(tt[40][tt[40] >= 0].astype(int))
    v = np.zeros(np.asarray(case.jparams.atlas_planes).shape)
    for tex in sorted(albedo - other):
        x0, y0, w, h = rec[tex]
        for y in range(y0, y0 + h):
            v[:3, y * atlas_w + x0 : y * atlas_w + x0 + w] = 1.0
    assert v.sum() > 0
    return v


def _direction(case, group):
    """(group index, direction) of a named test direction."""
    p = case.jparams
    if group == "albedo":
        d = np.zeros(p.mat_albedo.shape)
        d[:, :3] = 1.0
        return 0, d
    if group in ("roughness", "emission"):
        d = np.zeros(p.mat_rome.shape)
        d[:, 0 if group == "roughness" else 3] = 1.0
        return 1, d
    if group == "atlas":
        return 2, _albedo_texels(case)
    if group == "sun_dir":
        return 3, np.array([1.0, 0.0, -0.5])
    if group == "sun_lum":
        return 4, np.ones(3)
    return 5, np.array([1.0, 0.5, -0.25])


def test_apply_params_grafts_bitwise(cornell):
    c = cornell
    ja, jcam = jdiff.apply_params(c.jm, c.ja, c.jcam, c.jparams)
    m = dataclasses.replace(c.meta, differentiable=True)
    a, cam = diff.apply_params(m, c.arrays, c.cam, c.params())
    for name in ("tri_table", "emissive_table", "atlas_planes"):
        np.testing.assert_array_equal(getattr(a, name).numpy(), np.asarray(getattr(ja, name)),
                                      err_msg=name)
    np.testing.assert_array_equal(cam.eye.numpy(), np.asarray(jcam.eye))
    # extract_params reads back what the scene holds
    p = diff.extract_params(c.meta, c.arrays, c.cam)
    for name in ("mat_albedo", "mat_rome", "atlas_planes", "cam_eye"):
        np.testing.assert_array_equal(getattr(p, name).numpy(),
                                      np.asarray(getattr(c.jparams, name)), err_msg=name)


def test_render_color_matches_reference(cornell):
    c = cornell
    jcolor, jlive = jax.jit(jdiff.make_render_fn(c.jm, W, H, max_bounces=BOUNCES))(
        c.jparams, c.ja, c.jl, c.jcam, jnp.uint32(SEED))
    color, live = diff.make_render_fn(c.meta, W, H, max_bounces=BOUNCES)(
        c.params(), c.arrays, c.lights, c.cam, SEED)
    assert color.shape == (W * H, 3) and bool(torch.isfinite(color).all())
    close = np.isclose(color.numpy(), np.asarray(jcolor), rtol=1e-4, atol=1e-6)
    assert close.mean() >= 0.99, close.mean()
    np.testing.assert_allclose(color.numpy(), np.asarray(jcolor), rtol=1e-2, atol=1e-5)
    np.testing.assert_array_equal(live.numpy(), np.asarray(jlive).astype(np.int64))


def test_render_color_brute_matches_reference(cornell_brute):
    """The port's `brute` scene: the same colour rule as the dense one."""
    c = cornell_brute
    assert c.meta.backend == "brute"
    jcolor, jlive = jax.jit(jdiff.make_render_fn(c.jm, W, H, max_bounces=BOUNCES))(
        c.jparams, c.ja, c.jl, c.jcam, jnp.uint32(SEED))
    color, live = diff.make_render_fn(c.meta, W, H, max_bounces=BOUNCES)(
        c.params(), c.arrays, c.lights, c.cam, SEED)
    assert color.shape == (W * H, 3) and bool(torch.isfinite(color).all())
    close = np.isclose(color.numpy(), np.asarray(jcolor), rtol=1e-4, atol=1e-6)
    assert close.mean() >= 0.99, close.mean()
    np.testing.assert_allclose(color.numpy(), np.asarray(jcolor), rtol=1e-2, atol=1e-5)
    np.testing.assert_array_equal(live.numpy(), np.asarray(jlive).astype(np.int64))


@pytest.mark.parametrize("scene,group", [
    ("cornell", "albedo"), ("cornell", "roughness"), ("cornell", "emission"),
    ("cornell", "camera"), ("sky", "sun_dir"), ("sky", "sun_lum"), ("map", "atlas"),
    ("cornell_brute", "albedo"), ("cornell_brute", "roughness"),
    ("cornell_brute", "emission"), ("cornell_brute", "camera"),
])
def test_directional_derivative_matches_jax(scene, group, request):
    case = request.getfixturevalue({"cornell": "cornell", "sky": "sky_case",
                                    "map": "map_case", "cornell_brute": "cornell_brute"}[scene])
    gi, v = _direction(case, group)
    on = v != 0  # NaN outside the direction (see the module note) stays out
    want = float(np.sum(case.jgrad()[gi][on] * v[on]))
    got = float(np.sum(case.pgrad()[gi][on] * v[on]))
    assert np.isfinite(got) and abs(want) > 1e-8, (got, want)
    assert abs(got - want) <= 1e-3 * abs(want), (got, want)


def test_adam_step_matches_optax(cornell):
    c = cornell
    trainable = diff.DiffParams(mat_albedo=True, mat_rome=True, atlas_planes=False,
                                sun_dir=False, sun_lum=False, cam_eye=True)
    init, step = diff.make_train_step(c.meta, W, H, max_bounces=BOUNCES, learning_rate=5e-2,
                                      trainable=trainable)
    p = c.params()
    start = [x.detach().clone() for x in p]
    opt = init(p)
    loss, p, opt = step(p, opt, *c.args)
    assert np.isfinite(float(loss))
    grads = [x.grad.numpy() for x in p]
    for g, on in zip(grads, trainable):
        assert on or not g.any()
    tx = optax.adam(5e-2)
    jp = [jnp.asarray(x.numpy()) for x in start]
    updates, _ = tx.update([jnp.asarray(g) for g in grads], tx.init(jp), jp)
    want = optax.apply_updates(jp, updates)
    for name, got, w, s0, on in zip(GROUPS, p, want, start, trainable):
        np.testing.assert_allclose((got.detach() - s0).numpy(), np.asarray(w) - s0.numpy(),
                                   rtol=2e-5, atol=1e-7, err_msg=name)
        if not on:
            assert torch.equal(got.detach(), s0), name


# --- the port's AD against central finite differences (test_grad.py's ladder)

_EPS_LADDER = (3e-3, 1e-3, 3e-4, 1e-4, 3e-5, 1e-5)


def _check_directional(case, group, eps=None, rtol=0.05, atol=1e-6):
    gi, v = _direction(case, group)
    ad = float(np.sum(case.pgrad()[gi] * v))
    base = case.params()
    sweep = []
    with torch.no_grad():
        for e in ((eps,) if eps is not None else _EPS_LADDER):
            def at(sign):
                p = list(base)
                p[gi] = p[gi] + sign * e * torch.from_numpy(v.astype(np.float32))
                return float(case.loss(diff.DiffParams(*p), *case.args)[0])

            fd = (at(1.0) - at(-1.0)) / (2.0 * e)
            sweep.append((e, fd))
            if abs(fd - ad) <= rtol * abs(ad) + atol:
                return ad
    raise AssertionError(f"AD {ad:+.6g} matched no FD rung (rtol {rtol}): "
                         + ", ".join(f"eps={e:g}: fd={fd:+.6g}" for e, fd in sweep))


def test_fd_albedo(cornell):
    assert abs(_check_directional(cornell, "albedo", rtol=2e-2)) > 1e-6


@pytest.mark.slow
def test_fd_roughness(cornell):
    assert abs(_check_directional(cornell, "roughness", rtol=8e-2)) > 1e-8


@pytest.mark.slow
def test_fd_emission(cornell):
    assert abs(_check_directional(cornell, "emission", rtol=2e-2)) > 1e-6


@pytest.mark.slow
def test_fd_camera(cornell):
    assert abs(_check_directional(cornell, "camera", rtol=5e-2)) > 1e-6


@pytest.mark.slow
def test_fd_sun_dir(sky_case):
    assert abs(_check_directional(sky_case, "sun_dir", eps=2e-3, rtol=5e-2)) > 1e-8


@pytest.mark.slow
def test_fd_sun_luminance(sky_case):
    assert abs(_check_directional(sky_case, "sun_lum", rtol=2e-2)) > 1e-8


@pytest.mark.slow
def test_inverse_rendering_converges(cornell):
    """Recover perturbed albedos by Adam against a target rendered with the
    true parameters (test_grad.py::test_inverse_rendering_converges)."""
    c = cornell
    with torch.no_grad():
        target, _ = diff.make_render_fn(c.meta, W, H, max_bounces=BOUNCES)(
            c.params(), c.arrays, c.lights, c.cam, SEED)
    p = c.params()
    p = p._replace(mat_albedo=torch.clamp(p.mat_albedo * 0.5 + 0.2, 0.0, 1.0))
    only_albedo = diff.DiffParams(mat_albedo=True, mat_rome=False, atlas_planes=False,
                                  sun_dir=False, sun_lum=False, cam_eye=False)
    init, step = diff.make_train_step(c.meta, W, H, max_bounces=BOUNCES, learning_rate=5e-2,
                                      trainable=only_albedo)
    opt = init(p)
    losses = []
    for _ in range(20):
        loss, p, opt = step(p, opt, c.arrays, c.lights, c.cam, target, SEED)
        losses.append(float(loss))
    assert losses[-1] < 0.2 * losses[0], losses
