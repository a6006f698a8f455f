"""The reference of the bake traffic (see `pimbench.drivers.bake`).

It builds the scene again through the frozen copy (its whole light grid
baked by the reference itself, as in `reference.render.build`) and packs
the lightmap itself.  A texel's pass depends on
its own RNG stream (keyed by texel and frame), its own probes and count,
so the sampled texels are baked alone: the first pass from the
reference's own pack, the last from the program's state before it (the
passes between are the same computation on the program's state).

Control (`control=True`): the reference in the program's place one
precision lower (its geometry in bfloat16, its probes rounded to
bfloat16, its light grid baked on that geometry, its pack's positions
and normals rounded to bfloat16).
"""

from __future__ import annotations

import torch

from pimbench import scenes
from pimbench.reference.compare import max_rel_gap, share_off, to_bf16
from pimbench.reference.render import build, control_scene, grid_gap, grid_state


def bake_texels(scene, pack, texels, frame: int, bounces: int, probes, counts):
    """`lightmap.bake_step` on the texels `texels` alone, from their
    `probes` [P, K, 4] and `counts` [P]: (new probes, new counts)."""
    from pimbench.reference.frozen.render import lightmap as lm

    meta, arrays, lights = scene
    sub = pack._replace(position=pack.position[:, texels], normal=pack.normal[:, texels],
                        probes=probes, sample_counts=counts)
    new = lm.bake_step(meta, arrays, lights, sub, frame, max_bounces=bounces,
                       texel_ids=texels.to(torch.int64))
    return new.probes, new.sample_counts


def _rows(probes, counts):
    return torch.cat([probes.reshape(probes.shape[0], -1), counts[:, None]], dim=1)


def check(cfg, tr, texels, prog: dict, dev, control: bool = False):
    """[(name, value, limit)] of the bake check (module docstring)."""
    from pimbench.reference.frozen.geom.entities import flatten
    from pimbench.reference.frozen.render import lightmap as lm

    limits = tr["limits"]
    ents = scenes.entities(cfg, "reference")
    scene = build(cfg, dev, ents=ents)
    ref_grid = grid_state(*scene[1:])
    flat = flatten(ents[0])
    pack = lm.pack_lightmaps(flat.positions, flat.normals,
                             texels_per_meter=float(tr["texels_per_meter"]), device=dev)
    p0 = prog["pack0"]
    pack_gap = max(float(pack.size != p0["size"]),
                   max_rel_gap(p0["position"], pack.position[:, texels]),
                   max_rel_gap(p0["normal"], pack.normal[:, texels]),
                   max_rel_gap(p0["counts"], pack.sample_counts[texels]))
    grid = grid_gap(prog["grid"], ref_grid)
    if control:
        low = control_scene(scene)
        grid = grid_gap(grid_state(*low[1:]), ref_grid)
        pack_gap = max(max_rel_gap(to_bf16(pack.position[:, texels]), pack.position[:, texels]),
                       max_rel_gap(to_bf16(pack.normal[:, texels]), pack.normal[:, texels]))
    bounces = int(cfg["bounces"])
    pairs = []
    for k in sorted(prog["after"]):
        if k == 0:
            probes, counts = pack.probes[texels], pack.sample_counts[texels]
        else:
            probes, counts = prog["before"][k]["probes"], prog["before"][k]["counts"]
        frame = prog["first_frame"] + k
        ref = _rows(*bake_texels(scene, pack, texels, frame, bounces, probes, counts))
        if control:
            got = to_bf16(_rows(*bake_texels(low, pack, texels, frame, bounces, probes, counts)))
        else:
            got = _rows(prog["after"][k]["probes"], prog["after"][k]["counts"])
        pairs.append((got, ref))
    return [("probes_off", share_off(pairs), limits["probes_off"]),
            ("pack_gap", pack_gap, limits["pack_gap"]),
            ("grid_gap", grid, limits["grid_gap"])]
