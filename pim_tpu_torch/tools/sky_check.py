"""What the sky kernels (csrc/sky.cu) are checked on and held against,
shared by chip_smoke.py and the tests.

- Cases (`cases`): e1m1's cube as the serving bake takes it (32^2, 8 steps,
  the sun's direction and luminance as floats), as the training step takes
  it (the same cube; the sun's direction and luminance [3] tensors that
  require grad), an `earth_sky` fan (seeded directions over the whole
  sphere, from above the crust, 4 steps, a sun low in the sky) and a 4^2
  cube (96 directions: torch.sum's other order); `ordered_sum` is that
  order in plain ops, to hold `sky.torch_sum_split` to torch.sum.
- `kernel_out` and `plain_out`: `atmosphere` (the kernels on the card) and
  `atmosphere_plain` of a case as [3, D]; `forward_gap` counts the values
  whose bits differ and gives the largest relative gap.
- `kernel_grads` and `plain_grads`: d <g, out> / d (light_dir, luminance)
  by the kernels' backward and by autograd of the plain form.
- `work`: the density evaluations a case's march needs (every view sample,
  and each live view step's sun march up to the step where it ends), from
  which the kernels' operation bounds are counted (`*_FLOPS`).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from pim_tpu_torch.math.vec3 import V3
from pim_tpu_torch.render import sky

E1M1_SUN = (0.35, 0.82, 0.45)  # app.SUN_DIR, SUN_LUM, SKY_SIZE, SKY_STEPS
E1M1_LUM = 3800.0
E1M1_SIZE = 32
E1M1_STEPS = 8
FAN_DIRECTIONS = 4096
FAN_SEED = 1_618_033_988
# float operations of one density evaluation: the sample's position (3
# products, 3 sums), the squared norm (a float32 product, two float64
# products and sums), the root, h, two densities (negation-product, clamp,
# exp each), the liveness sum, two optical-depth products and sums
EVAL_FLOPS = 24
# the backward's, with the tangents: dh (a quotient), two density
# derivatives (product, mask, two products each), six tangent sums (a
# product and a sum each)
EVAL_FLOPS_BWD = 24 + 1 + 8 + 12


class Case(NamedTuple):
    label: str
    ro: tuple          # 3 floats, the planet's centre at the origin
    rd: V3             # [D] unit directions
    light_dir: object  # 3 floats or a [3] tensor
    luminance: object  # a float or a [3] tensor
    steps: int


def _unit(v: np.ndarray) -> np.ndarray:
    return (v / np.sqrt(np.sum(v * v, axis=-1, keepdims=True))).astype(np.float32)


def cases(device) -> list:
    """The three cases on `device`."""
    med = sky.earth_atmosphere()
    dirs = sky.cube_dirs(E1M1_SIZE, device)
    cube = V3(dirs[0], dirs[1], dirs[2])
    ro = (0.0, float(med.r_crust), 0.0)
    sun = _unit(np.asarray(E1M1_SUN, np.float32))
    ld = torch.tensor(sun, device=device).requires_grad_()
    lum = torch.full((3,), E1M1_LUM, dtype=torch.float32, device=device).requires_grad_()
    rs = np.random.default_rng(FAN_SEED)
    fan = _unit(rs.normal(size=(FAN_DIRECTIONS, 3)))
    fan_rd = V3(*(torch.from_numpy(np.ascontiguousarray(fan[:, c])).to(device) for c in range(3)))
    fan_ro = tuple(float(c) for c in np.float32([3.0, 150.0, -7.0]) + np.float32(
        [0.0, med.r_crust, 0.0]))
    small = sky.cube_dirs(4, device)
    return [
        Case("e1m1 cube, serving", ro, cube, tuple(float(c) for c in sun), E1M1_LUM, E1M1_STEPS),
        Case("e1m1 cube, training", ro, cube, ld, lum, E1M1_STEPS),
        Case("earth_sky fan", fan_ro, fan_rd, (0.9, 0.12, 0.42), (1.0, 0.9, 0.8), 4),
        Case("4^2 cube, serving", ro, V3(small[0], small[1], small[2]),
             tuple(float(c) for c in sun), E1M1_LUM, 2),
    ]


def ordered_sum(x: torch.Tensor, split: int) -> torch.Tensor:
    """x [96, D] summed over dim 0 in the order the kernels take for
    `sky.torch_sum_split` = split: partial sums over k mod 4 (split 1) or
    over (k mod 4, k // 4 mod 4) (split 4), combined as torch.sum does."""
    parts = [torch.zeros_like(x[0]) for _ in range(4 * split)]
    for k in range(x.shape[0]):
        q = k % 4 if split == 1 else (k % 4) * 4 + (k // 4) % 4
        parts[q] = parts[q] + x[k]
    if split == 1:
        return ((parts[0] + parts[1]) + parts[2]) + parts[3]
    t = [((parts[4 * y] + parts[4 * y + 1]) + parts[4 * y + 2]) + parts[4 * y + 3]
         for y in range(4)]
    return (t[0] + t[2]) + (t[1] + t[3])


def kernel_out(case: Case) -> torch.Tensor:
    return torch.stack(list(sky.atmosphere(sky.earth_atmosphere(), case.ro, case.rd,
                                           case.light_dir, case.luminance, case.steps)))


def plain_out(case: Case) -> torch.Tensor:
    return torch.stack(list(sky.atmosphere_plain(sky.earth_atmosphere(), case.ro, case.rd,
                                                 case.light_dir, case.luminance, case.steps)))


def forward_gap(got: torch.Tensor, want: torch.Tensor):
    """(values whose bits differ, the largest |got - want| / |want|)."""
    got, want = got.detach(), want.detach()
    differ = int((got.view(torch.int32) != want.view(torch.int32)).sum())
    rel = (got.double() - want.double()).abs() / want.double().abs().clamp_min(1e-300)
    return differ, float(rel.max()) if differ else 0.0


def cube_grad(case: Case, seed: int) -> torch.Tensor:
    """A seeded incoming gradient [3, D] for the case."""
    rs = np.random.default_rng(seed)
    g = rs.normal(size=(3, case.rd.x.shape[0])).astype(np.float32)
    return torch.from_numpy(g).to(case.rd.x.device)


def kernel_grads(case: Case, g: torch.Tensor):
    out = kernel_out(case)
    return torch.autograd.grad((out * g).sum(), [case.light_dir, case.luminance])


def plain_grads(case: Case, g: torch.Tensor):
    out = plain_out(case)
    return torch.autograd.grad((out * g).sum(), [case.light_dir, case.luminance])


@torch.no_grad()
def work(case: Case) -> dict:
    """{"view": view samples, "sun": sun-march density evaluations}: each
    live view step's sun march up to and including the step that ends it."""
    med = sky.earth_atmosphere()
    ld = [float(v) for v in (case.light_dir.tolist() if torch.is_tensor(case.light_dir)
                             else case.light_dir)]
    mfp = sky._march_step(med, case.steps)
    rd = case.rd
    dev = rd.x.device
    t_sun = torch.from_numpy(sky._march_positions(mfp, sky.SUN_STEPS)).to(dev)[:, None]
    live = torch.ones_like(rd.x, dtype=torch.bool)
    sun = torch.zeros((), dtype=torch.int64, device=dev)
    trips = sky.steps_to_trips(case.steps)
    ox, oy, oz = case.ro
    for t_v in sky._march_positions(mfp, trips).tolist():
        px, py, pz = ox + rd.x * t_v, oy + rd.y * t_v, oz + rd.z * t_v
        _, h, dr, dm = sky._density(med, px, py, pz)
        live = live & (h >= 0.0) & ((dr + dm) >= sky._MIN_DENSITY)
        _, hs, drs, dms = sky._density(med, px[None] + t_sun * ld[0], py[None] + t_sun * ld[1],
                                       pz[None] + t_sun * ld[2])
        ok = ~(hs < 0.0) & ((drs + dms) >= sky._MIN_DENSITY)
        alive = torch.cumprod(ok.to(torch.int32), dim=0).sum(dim=0)  # steps before the end
        sun += torch.where(live, torch.clamp_max(alive + 1, sky.SUN_STEPS), 0).sum()
    return {"view": trips * rd.x.shape[0], "sun": int(sun)}
