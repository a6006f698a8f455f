"""pim_tpu_torch.parallel on a two-rank gloo world of CPU processes, against
the port's unsharded paths and pim_tpu.parallel on the 8-device CPU mesh.

One world is spawned for the module (`dryrun.spawn_world`, one torch thread
a rank).  Its ranks run every sharded path on the same Cornell scene and
write their outputs under tmp_path; the tests read those files.  The scene
is the port's own build with the JAX package's light state and cell flags
(as tests/test_torch_diff.py builds it), so both packages select the same
lights; the JAX side is its `brute` backend, as tests/test_shard.py.

- Render (16^2, 3 bounces; sample 0, as test_shard.py, and sample 5, whose
  paths reach the light so `live` is not all zeros): the gathered colour,
  albedo and normal equal the port's unsharded trace bit for bit, and the
  summed `live` equals it.  Against the JAX package's sharded step: 97% of
  pixels within rtol 1e-4 / atol 1e-5, the means within 2% (the rule of
  test_torch_frame.py), `live` equal.  Each rank traces 128 pixels, a
  multiple of 64 lanes, so the CPU's vectorised maths runs the same lanes
  through the same code as the whole batch.
- Train step (16^2, 2 bounces, lr 0.05, all six groups), overlapped and
  serialized all-reduces: a finite loss, `mat_albedo` moved, a second step
  at the same seed lowers the loss; both ranks hold the same parameters;
  the update equals the one-rank step's within rtol 1e-5 (the averaged
  rank gradients sum in another order); against the JAX sharded step, the
  loss within rtol 1e-3 and the update along each of test_torch_diff.py's
  Cornell directions within rtol 1e-3 (its gradient tolerance), `live`
  equal.
- The deployment's Adam step (`diff.make_train_step(mesh=...)`, 16^2 on the
  two-rank world and 24 x 16 on a world of three, 2 bounces, lr 0.05, all
  six groups, three steps at samples 0-2): each step's loss, gradient and
  update equal the one-rank whole-batch step's within rtol 1e-5 plus 1e-5
  of a group's largest (as the SGD step's); the first step's update equals
  the JAX package's whole-batch Adam step's (`pim_tpu.render.diff.
  make_train_step`, optax) at that tolerance, its loss within rtol 1e-4
  (not later steps: once the first has moved metalness off 0, the JAX
  package's roughness gradient is NaN, the port's finite); every rank holds the same parameter bits; the
  ranks' loss shares, each over N, add up to the whole batch's loss; while
  tracing, one step issues seven all-reduces of the six groups' and the
  loss's bytes.  A world-of-one mesh gives `mesh=None`'s bits.
- Bake: a Cornell lightmap (1 texel/m: 4,096 texels, 2,048 a rank), 3
  bounces, 2 passes, sharded over the texel axis and gathered with
  `allgather_rows`: probes and sample counts bit for bit the whole bake.
- The world's helpers: `process_local_slice`, `allgather_rows`,
  `dryrun_multichip(2)`; `init_distributed` without a world and with a
  rank that never joins; `replicate`; `entry`; the dry run's launcher on a
  world of three.
"""

import contextlib
import dataclasses
import io
import os
import subprocess
import sys
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pim_tpu.geom.cornell import build_cornell_box as jax_cornell
from pim_tpu.parallel import shard as jshard
from pim_tpu.render import camera as jcam
from pim_tpu.render import diff as jdiff
from pim_tpu.render.scene import build_scene as jax_build_scene
from pim_tpu_torch import app
from pim_tpu_torch.core import rng
from pim_tpu_torch.geom.cornell import build_cornell_box
from pim_tpu_torch.geom.entities import flatten
from pim_tpu_torch.parallel import dist as pdist
from pim_tpu_torch.parallel import dryrun, shard
from pim_tpu_torch.render import camera, diff, integrator, lightmap
from pim_tpu_torch.render.scene import LightState, build_scene
from pim_tpu_torch.tools import scaling_worker

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RANKS = 2
W = H = 16
RENDER_BOUNCES = 3
SAMPLES = (0, 5)
TRAIN_BOUNCES = 2
LR = 0.05
BAKE_BOUNCES = 3
ADAM_SAMPLES = (0, 1, 2)
W3 = 24  # a world of three: 24 x 16 pixels, 128 a rank
BAKE_FRAMES = (0, 1)
BAKE_DENSITY = 1.0
WORLD_TIMEOUT_S = 120
# test_torch_diff.py's Cornell directions: (group, column selector)
DIRECTIONS = {"albedo": (0, slice(0, 3)), "roughness": (1, slice(0, 1)),
              "emission": (1, slice(3, 4)), "camera": (5, None)}


def _jax_camera(width: int = W):
    c = jcam.Camera(position=np.array([-4, 0, 4], np.float32))
    c.look_at([0, -1, 0])
    return jcam.camera_arrays(c, jcam.DofInfo(autofocus=False), width, H)


def _port_scene(jax_scene):
    """The port's Cornell build with the JAX scene's light state and cell
    flags."""
    _, ja, jl = jax_scene
    meta, arrays, _ = build_scene(*build_cornell_box("boxes"), "cpu", backend="dense")
    lights = LightState(
        pdf=torch.from_numpy(np.array(jl.pdf)), cdf=torch.from_numpy(np.array(jl.cdf)),
        integral=torch.from_numpy(np.array(jl.integral)),
        sum=torch.from_numpy(np.asarray(jl.sum).astype(np.int64)),
        live=torch.from_numpy(np.asarray(jl.live).astype(np.int64)))
    arrays = dataclasses.replace(
        arrays, cell_active=torch.from_numpy(np.array(ja.cell_active)),
        cell_active_f=torch.from_numpy(np.array(ja.cell_active_f)))
    return meta, arrays, lights


def _lightmap_pack():
    flat = flatten(build_cornell_box("boxes")[0])
    return lightmap.pack_lightmaps(flat.positions, flat.normals, texels_per_meter=BAKE_DENSITY,
                                   device="cpu")


def _adam_runs(meta, arrays, lights, mesh, width: int) -> dict:
    """This rank's view of `diff.make_train_step(mesh=mesh)` over
    ADAM_SAMPLES: each step's loss, gradients and parameters; the loss of
    its own rows at the first step's parameters; and the counters of one
    traced step."""
    from pim_tpu_torch.core import profiler as prof

    cam = app.bench_camera("cornell", width, H)
    target = torch.zeros((width * H, 3), dtype=torch.float32)
    params = diff.extract_params(meta, arrays, cam)
    init, step = diff.make_train_step(meta, width, H, TRAIN_BOUNCES, learning_rate=LR,
                                      mesh=mesh)
    rows, ids = pdist.local_pixels(mesh, width * H)
    share = diff.make_loss_fn(meta, width, H, TRAIN_BOUNCES)(
        params, arrays, lights, cam, target[rows], ADAM_SAMPLES[0], ids)[0]
    opt = init(params)
    out = {"start": [p.detach().numpy().copy() for p in params], "share": float(share),
           "steps": []}
    for s in ADAM_SAMPLES:
        loss, params, opt = step(params, opt, arrays, lights, cam, target, s)
        out["steps"].append({"loss": float(loss),
                             "grads": [p.grad.numpy().copy() for p in params],
                             "params": [p.detach().numpy().copy() for p in params]})
    prof.reset_counters()
    prof.set_tracing(True)
    try:
        step(params, opt, arrays, lights, cam, target[rows], ADAM_SAMPLES[0])
        out["counters"] = prof.counters()
    finally:
        prof.set_tracing(False)
        prof.reset_counters()
    return out


def _adam_rank_job(out_dir: str, ranks: int, width: int) -> None:
    """One rank of a world of `ranks`: `_adam_runs`, saved to
    out_dir/adam<ranks>_rank<r>.pt."""
    torch.set_num_threads(1)
    os.environ["PIM_DIST_INIT_S"] = str(WORLD_TIMEOUT_S)
    info = pdist.init_distributed(device="cpu")
    meta, arrays, lights = torch.load(os.path.join(out_dir, "scene.pt"), weights_only=False)
    out = _adam_runs(meta, arrays, lights, shard.make_mesh(ranks, "cpu"), width)
    torch.save(out, os.path.join(out_dir, f"adam{ranks}_rank{info.process_id}.pt"))


def _rank_job(out_dir: str) -> None:
    """One rank of the module's world: every sharded path, outputs saved to
    out_dir/rank<r>.pt."""
    torch.set_num_threads(1)
    os.environ["PIM_DIST_INIT_S"] = str(WORLD_TIMEOUT_S)  # bounds the init and each collective
    info = pdist.init_distributed(device="cpu")
    mesh = shard.make_mesh(RANKS, "cpu")
    meta, arrays, lights = torch.load(os.path.join(out_dir, "scene.pt"), weights_only=False)
    cam = app.bench_camera("cornell", W, H)
    out = {"rank": info.process_id}

    step = shard.make_sharded_render_step(meta, mesh, W, H, RENDER_BOUNCES)
    for s in SAMPLES:
        color, albedo, normal, live = step(arrays, lights, cam, s)
        out[f"render{s}"] = [pdist.allgather_rows(x.numpy()) for x in (color, albedo, normal)]
        out[f"live{s}"] = live.numpy()

    params = diff.extract_params(meta, arrays, cam)
    target = torch.zeros((W * H, 3), dtype=torch.float32)
    for serialize in (False, True):
        tstep = shard.make_sharded_train_step(meta, mesh, W, H, TRAIN_BOUNCES, LR, serialize)
        loss0, p1, l1 = tstep(params, arrays, lights, cam, target, 0)
        loss1, _, _ = tstep(p1, arrays, l1, cam, target, 0)
        out[f"train{int(serialize)}"] = {"loss0": float(loss0), "loss1": float(loss1),
                                         "params": [x.numpy() for x in p1],
                                         "live": l1.live.numpy()}

    out["adam"] = _adam_runs(meta, arrays, lights, mesh, W)

    pack = _lightmap_pack()
    off, cnt, per = scaling_worker.shard_range(pack.position.shape[1], info.process_id, RANKS)
    for f in BAKE_FRAMES:
        pack = lightmap.bake_step(meta, arrays, lights, pack, f, max_bounces=BAKE_BOUNCES,
                                  texel_offset=off, texel_count=cnt)
    pack = scaling_worker.gather_shards(pack, off, cnt, per)
    out["bake"] = (pack.probes.numpy(), pack.sample_counts.numpy())

    sl = pdist.process_local_slice(8)
    out["slice"] = (sl.start, sl.stop)
    out["rows"] = pdist.allgather_rows(np.full((2, 3), info.process_id, np.float32))

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        dryrun.dryrun_multichip(RANKS, "cpu")
    out["dryrun"] = buf.getvalue()
    torch.save(out, os.path.join(out_dir, f"rank{info.process_id}.pt"))


@pytest.fixture(scope="module")
def jax_scene():
    return jax_build_scene(*jax_cornell("boxes"), backend="brute")


@pytest.fixture(scope="module")
def port_scene(jax_scene):
    return _port_scene(jax_scene)


@pytest.fixture(scope="module")
def world(tmp_path_factory, port_scene):
    """Both ranks' outputs.  The world runs in a thread of this process
    while the JAX package's sharded steps run here."""
    out_dir = str(tmp_path_factory.mktemp("world"))
    torch.save(port_scene, os.path.join(out_dir, "scene.pt"))
    err = []

    def run():
        try:
            dryrun.spawn_world(RANKS, _rank_job, (out_dir,), threads=1)
        except Exception as e:  # noqa: BLE001 (re-raised below)
            err.append(e)

    t = threading.Thread(target=run)
    t.start()
    yield lambda: _joined(t, err, out_dir)
    t.join()


def _joined(t, err, out_dir):
    t.join(timeout=5 * WORLD_TIMEOUT_S)
    assert not t.is_alive(), "the two-rank world did not finish"
    if err:
        raise err[0]
    return [torch.load(os.path.join(out_dir, f"rank{r}.pt"), weights_only=False)
            for r in range(RANKS)]


@pytest.fixture(scope="module")
def jax_runs(jax_scene, world):
    """The JAX package's sharded render (each sample) and train step, run
    while the world runs."""
    jm, ja, jl = jax_scene
    mesh = jshard.make_mesh(8)
    cam = _jax_camera()
    render = jshard.make_sharded_render_step(jm, mesh, W, H, max_bounces=RENDER_BOUNCES)
    out = {s: [np.asarray(x) for x in jax.block_until_ready(render(ja, jl, cam, jnp.uint32(s)))]
           for s in SAMPLES}
    train = jshard.make_sharded_train_step(jm, mesh, W, H, max_bounces=TRAIN_BOUNCES, lr=LR)
    params = jdiff.extract_params(jm, ja, cam)
    loss, p1, l1 = jax.block_until_ready(train(params, ja, jl, cam,
                                               jnp.zeros((W * H, 3), jnp.float32), jnp.uint32(0)))
    out["train"] = (float(loss), [np.asarray(x) for x in params], [np.asarray(x) for x in p1],
                    np.asarray(l1.live).astype(np.int64))
    return out


@pytest.fixture(scope="module")
def ranks(world, jax_runs):
    return world()


def _unsharded(port_scene, sample):
    meta, arrays, lights = port_scene
    state = rng.make_state(torch.arange(W * H), sample)
    state, ro, rd = camera.generate_primary_rays(app.bench_camera("cornell", W, H), W, H, state)
    return integrator.trace_rays(meta, arrays, lights, ro, rd, state, RENDER_BOUNCES)


@pytest.mark.parametrize("sample", SAMPLES)
def test_sharded_render_equals_the_unsharded_trace(ranks, port_scene, sample):
    want = _unsharded(port_scene, sample)
    for r in ranks:
        for got, w in zip(r[f"render{sample}"], (want.color, want.albedo, want.normal)):
            assert got.shape == (W * H, 3)
            np.testing.assert_array_equal(got, w.numpy())
        np.testing.assert_array_equal(r[f"live{sample}"], want.live.numpy() & rng.MASK32)
    if sample == 5:
        assert want.live.sum() > 0


@pytest.mark.parametrize("sample", SAMPLES)
def test_sharded_render_matches_the_jax_sharded_step(ranks, jax_runs, sample):
    jcolor, jalbedo, jnormal, jlive = jax_runs[sample]
    got = ranks[0][f"render{sample}"]
    for g, w in zip(got, (jcolor, jalbedo, jnormal)):
        close = np.all(np.isclose(g, w, rtol=1e-4, atol=1e-5), axis=-1)
        assert close.mean() >= 0.97, close.mean()
    assert jcolor.mean() > 0 and abs(got[0].mean() - jcolor.mean()) <= 0.02 * jcolor.mean()
    np.testing.assert_array_equal(ranks[0][f"live{sample}"], jlive.astype(np.int64))


@pytest.mark.parametrize("serialize", [False, True], ids=["overlapped", "serialized"])
def test_sharded_train_step_learns(ranks, port_scene, serialize):
    meta, arrays, _ = port_scene
    p0 = diff.extract_params(meta, arrays, app.bench_camera("cornell", W, H))
    runs = [r[f"train{int(serialize)}"] for r in ranks]
    for run in runs:
        assert np.isfinite(run["loss0"]) and run["loss1"] < run["loss0"], run
        assert np.abs(run["params"][0] - p0.mat_albedo.numpy()).max() > 0.0
    for a, b in zip(runs[0]["params"], runs[1]["params"]):  # every rank holds the same step
        np.testing.assert_array_equal(a, b)
    assert runs[0]["loss0"] == runs[1]["loss0"]


@pytest.mark.parametrize("serialize", [False, True], ids=["overlapped", "serialized"])
def test_sharded_train_step_equals_one_rank(ranks, port_scene, serialize):
    meta, arrays, lights = port_scene
    cam = app.bench_camera("cornell", W, H)
    p0 = diff.extract_params(meta, arrays, cam)
    step = shard.make_sharded_train_step(meta, shard.make_mesh(1, "cpu"), W, H, TRAIN_BOUNCES,
                                         LR, serialize)
    loss, p1, l1 = step(p0, arrays, lights, cam, torch.zeros((W * H, 3)), 0)
    run = ranks[0][f"train{int(serialize)}"]
    np.testing.assert_allclose(run["loss0"], float(loss), rtol=1e-6)
    for name, got, want, start in zip(diff.DiffParams._fields, run["params"], p1, p0):
        du, dw = got - start.numpy(), (want - start).numpy()
        np.testing.assert_allclose(du, dw, rtol=1e-5, atol=1e-5 * np.abs(dw).max() + 1e-12,
                                   err_msg=name)
    np.testing.assert_array_equal(run["live"], l1.live.numpy())


def test_sharded_train_step_matches_the_jax_sharded_step(ranks, jax_runs):
    jloss, jp0, jp1, jlive = jax_runs["train"]
    run = ranks[0]["train0"]
    assert abs(run["loss0"] - jloss) <= 1e-3 * abs(jloss), (run["loss0"], jloss)
    for name, (gi, cols) in DIRECTIONS.items():
        want = np.sum((jp1[gi] - jp0[gi]).astype(np.float64)[..., cols])
        got = np.sum((run["params"][gi] - jp0[gi]).astype(np.float64)[..., cols])
        assert abs(want) > 1e-10 and abs(got - want) <= 1e-3 * abs(want), (name, got, want)
    np.testing.assert_array_equal(run["live"], jlive)


@pytest.fixture(scope="module")
def adam_worlds(ranks, port_scene, tmp_path_factory):
    """{ranks: [each rank's `_adam_runs`]} of the two-rank world and of a
    world of three spawned for it."""
    out_dir = str(tmp_path_factory.mktemp("world3"))
    torch.save(port_scene, os.path.join(out_dir, "scene.pt"))
    dryrun.spawn_world(3, _adam_rank_job, (out_dir, 3, W3), threads=1)
    return {RANKS: [r["adam"] for r in ranks],
            3: [torch.load(os.path.join(out_dir, f"adam3_rank{r}.pt"), weights_only=False)
                for r in range(3)]}


def _one_rank_adam(port_scene, width: int):
    """The one-rank whole-batch Adam step over ADAM_SAMPLES: each step's
    (loss, gradients, parameters)."""
    meta, arrays, lights = port_scene
    cam = app.bench_camera("cornell", width, H)
    params = diff.extract_params(meta, arrays, cam)
    init, step = diff.make_train_step(meta, width, H, TRAIN_BOUNCES, learning_rate=LR)
    opt = init(params)
    out = []
    for s in ADAM_SAMPLES:
        loss, params, opt = step(params, opt, arrays, lights, cam,
                                 torch.zeros((width * H, 3)), s)
        out.append((float(loss), [p.grad.numpy().copy() for p in params],
                    [p.detach().numpy().copy() for p in params]))
    return out


def _close(got, want, what):
    want = np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max() + 1e-12,
                               err_msg=what)


def _width(world_size: int) -> int:
    return W if world_size == RANKS else W3


@pytest.mark.parametrize("world_size", [RANKS, 3])
def test_the_adam_step_on_a_mesh_equals_the_one_rank_step(adam_worlds, port_scene, world_size):
    want = _one_rank_adam(port_scene, _width(world_size))
    run = adam_worlds[world_size][0]
    before = run["start"]
    for k, (got, (wloss, wgrads, wparams)) in enumerate(zip(run["steps"], want)):
        np.testing.assert_allclose(got["loss"], wloss, rtol=1e-5, err_msg=f"loss {k}")
        wbefore = before if k == 0 else want[k - 1][2]
        for name, g, wg, p, wp, b, wb in zip(diff.DiffParams._fields, got["grads"], wgrads,
                                             got["params"], wparams, before, wbefore):
            _close(g, wg, f"{name} gradient, step {k}")
            _close(p - b, wp - wb, f"{name} update, step {k}")
        before = got["params"]
    moved = run["steps"][-1]["params"][0] - run["start"][0]
    assert np.abs(moved).max() > 0.0


@pytest.mark.parametrize("world_size", [RANKS, 3])
def test_the_adam_step_on_a_mesh_equals_the_jax_whole_batch_step(adam_worlds, jax_scene,
                                                                 world_size):
    width = _width(world_size)
    jm, ja, jl = jax_scene
    cam = _jax_camera(width)
    params = jdiff.extract_params(jm, ja, cam)
    init, step = jdiff.make_train_step(jm, width, H, TRAIN_BOUNCES, learning_rate=LR)
    loss, p1, _ = jax.block_until_ready(step(params, init(params), ja, jl, cam,
                                             jnp.zeros((width * H, 3), jnp.float32),
                                             jnp.uint32(ADAM_SAMPLES[0])))
    run = adam_worlds[world_size][0]
    got = run["steps"][0]
    np.testing.assert_allclose(got["loss"], float(loss), rtol=1e-4)
    for name, p, b, jp, jb in zip(diff.DiffParams._fields, got["params"], run["start"], p1,
                                  params):
        np.testing.assert_array_equal(b, np.asarray(jb), err_msg=f"{name} start")
        _close(p - b, np.asarray(jp) - np.asarray(jb), f"{name} update")
    assert np.abs(got["params"][0] - run["start"][0]).max() > 0.0


@pytest.mark.parametrize("world_size", [RANKS, 3])
def test_the_adam_step_leaves_every_rank_the_same_bits(adam_worlds, world_size):
    runs = adam_worlds[world_size]
    for other in runs[1:]:
        for a, b in zip(runs[0]["steps"], other["steps"]):
            assert a["loss"] == b["loss"]
            for x, y in zip(a["params"] + a["grads"], b["params"] + b["grads"]):
                np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("world_size", [RANKS, 3])
def test_the_ranks_loss_shares_add_up_to_the_whole_loss(adam_worlds, port_scene, world_size):
    runs = adam_worlds[world_size]
    whole = _one_rank_adam(port_scene, _width(world_size))[0][0]
    shares = [r["share"] for r in runs]
    assert len(set(shares)) == world_size  # each rank its own rows
    np.testing.assert_allclose(sum(x / world_size for x in shares), whole, rtol=1e-6)
    np.testing.assert_allclose(runs[0]["steps"][0]["loss"], whole, rtol=1e-6)


@pytest.mark.parametrize("world_size", [RANKS, 3])
def test_a_traced_adam_step_counts_its_all_reduces(adam_worlds, port_scene, world_size):
    meta, arrays, _ = port_scene
    params = diff.extract_params(meta, arrays, app.bench_camera("cornell", W, H))
    nbytes = sum(p.numel() * p.element_size() for p in params) + 4  # and the loss
    for r in adam_worlds[world_size]:
        reduce = {k: v for k, v in r["counters"].items() if k.startswith("reduce.")}
        assert reduce == {"reduce.calls": 7, "reduce.bytes": nbytes}


def test_a_world_of_one_mesh_is_the_one_device_step(port_scene):
    meta, arrays, lights = port_scene
    cam = app.bench_camera("cornell", W, H)
    runs = []
    for mesh in (None, shard.make_mesh(1, "cpu")):
        params = diff.extract_params(meta, arrays, cam)
        init, step = diff.make_train_step(meta, W, H, TRAIN_BOUNCES, learning_rate=LR,
                                          mesh=mesh)
        opt = init(params)
        out = []
        for s in ADAM_SAMPLES[:2]:
            loss, params, opt = step(params, opt, arrays, lights, cam, torch.zeros((W * H, 3)), s)
            out.append([loss.numpy()] + [p.detach().numpy().copy() for p in params]
                       + [p.grad.numpy().copy() for p in params])
        runs.append(out)
    for a, b in zip(*runs):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)


def test_sharded_bake_equals_the_whole_bake(ranks, port_scene):
    meta, arrays, lights = port_scene
    whole = _lightmap_pack()
    assert whole.position.shape[1] == 4096 and (whole.position.shape[1] // RANKS) % 64 == 0
    for f in BAKE_FRAMES:
        whole = lightmap.bake_step(meta, arrays, lights, whole, f, max_bounces=BAKE_BOUNCES)
    for r in ranks:
        probes, counts = r["bake"]
        np.testing.assert_array_equal(probes, whole.probes.numpy())
        np.testing.assert_array_equal(counts, whole.sample_counts.numpy())
    assert (whole.sample_counts.numpy() == 1 + len(BAKE_FRAMES)).sum() > 0


def test_local_slices_and_gathered_rows_are_rank_major(ranks):
    want = np.repeat(np.arange(RANKS, dtype=np.float32), 2)[:, None] * np.ones(3, np.float32)
    for r in ranks:
        assert r["slice"] == (4 * r["rank"], 4 * r["rank"] + 4)
        np.testing.assert_array_equal(r["rows"], want)


def test_dryrun_multichip_runs_on_every_rank(ranks):
    for r in ranks:
        line = r["dryrun"].strip().splitlines()[-1]
        assert line.startswith(f"dryrun_multichip({RANKS}): loss=") and line.endswith(" ok")
        assert np.isfinite(float(line.split("loss=")[1].split()[0]))


def test_init_distributed_without_a_world_is_a_no_op(monkeypatch):
    for name in ("PIM_COORDINATOR", "PIM_NUM_PROCS", "PIM_PROC_ID"):
        monkeypatch.delenv(name, raising=False)
    info = pdist.init_distributed()
    assert info == pdist.DistInfo(0, 1, "127.0.0.1:7621") and info.is_main
    assert not torch.distributed.is_initialized()
    mesh = shard.make_mesh(1, "cpu")
    assert (mesh.group, mesh.rank, mesh.size) == (None, 0, 1)
    assert pdist.process_local_slice(6) == slice(0, 6)
    rows = np.arange(6.0).reshape(3, 2)
    assert pdist.allgather_rows(rows) is rows
    with pytest.raises(ValueError, match="world of 2 ranks"):
        shard.make_mesh(2, "cpu")


def test_a_world_whose_rank_never_joins_raises():
    script = ("from pim_tpu_torch.parallel.dist import init_distributed\n"
              f"init_distributed('127.0.0.1:{dryrun.free_port()}', 2, 0, device='cpu')\n"
              "print('JOINED')\n")
    env = dict(os.environ, PYTHONPATH=ROOT, PIM_DIST_INIT_S="2")
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                         cwd=ROOT, env=env, timeout=120)
    assert res.returncode != 0 and "JOINED" not in res.stdout
    assert "clients joined" in res.stderr or "imed out" in res.stderr, res.stderr[-2000:]
    assert time.perf_counter() - t0 < 60


def test_the_dryrun_launcher_runs_a_world_of_three():
    """`python -m pim_tpu_torch.parallel.dryrun` spawns its ranks; a world of
    three (an odd factor: the 16^2 frame widens to 48 x 16) runs on all."""
    res = subprocess.run([sys.executable, "-m", "pim_tpu_torch.parallel.dryrun", "--ranks", "3",
                          "--device", "cpu"], capture_output=True, text=True, cwd=ROOT,
                         env=dict(os.environ, PYTHONPATH=ROOT), timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stdout.count("dryrun_multichip(3): loss=") == 3, res.stdout


def test_entry_renders_a_cornell_frame():
    fn, args = dryrun.entry("cpu")
    color = fn(*args)
    assert color.shape == (64 * 64, 3) and bool(torch.isfinite(color).all())
    assert float(color.mean()) > 0


def test_replicate_moves_every_tensor_of_a_scene(port_scene):
    mesh = pdist.Mesh(None, 0, 1, torch.device("meta"))
    meta, arrays, lights = pdist.replicate(port_scene, mesh)
    assert meta == port_scene[0]
    for got, want in ((arrays, port_scene[1]), (lights, port_scene[2])):
        for f in dataclasses.fields(want):
            g, w = getattr(got, f.name), getattr(want, f.name)
            assert g.device.type == "meta" and g.shape == w.shape and g.dtype == w.dtype, f.name
