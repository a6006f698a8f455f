"""A configuration's scene, built from its file, for the program and for
the reference.

The configuration names the scene (`scene.kind`: "cornell" with a
variant, or "gltf" with a path under the checkout and an optional sky),
the camera (position, look-at target), the resolution and the bounces.
`build_program` builds it through the port (`pim_tpu_torch`), on the
device, as the port's app builds its bench scenes; `build_reference`
builds the same scene through the frozen plain copy under `reference/`.
Both read the same raw inputs (the Cornell generator's entities, the glTF
file) and derive everything else themselves.
"""

from __future__ import annotations

import os

import numpy as np

CHECKOUT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _modules(side: str):
    """(entities loaders, scene, sky, camera) modules of `side`: "program"
    (the port) or "reference" (the frozen copy)."""
    if side == "program":
        from pim_tpu_torch.geom import cornell, gltf
        from pim_tpu_torch.render import camera, scene, sky
    else:
        from pimbench.reference.frozen.geom import cornell, gltf
        from pimbench.reference.frozen.render import camera, scene, sky
    return cornell, gltf, scene, sky, camera


def entities(cfg: dict, side: str):
    """(entities, texture pool) of the configuration's scene."""
    cornell, gltf, _, _, _ = _modules(side)
    spec = cfg["scene"]
    if spec["kind"] == "cornell":
        return cornell.build_cornell_box(spec["variant"])
    if spec["kind"] == "gltf":
        path = os.path.join(CHECKOUT, spec["path"])
        if not os.path.exists(path):
            raise FileNotFoundError(f"{path}: the scene's asset is missing from the checkout")
        return gltf.load_gltf_scene(path)
    raise ValueError(f"unknown scene kind {spec['kind']!r}")


def build(cfg: dict, device, side: str, ents=None, **build_kw):
    """(meta, arrays, lights) of the configuration's scene on `device`,
    built through `side`'s modules (see `_modules`), from `ents` (an
    (entities, pool) pair) where given."""
    _, _, scene, sky_mod, _ = _modules(side)
    ents, pool = entities(cfg, side) if ents is None else ents
    sky = None
    spec = cfg["scene"].get("sky")
    if spec is not None:
        sky = sky_mod.bake_sky_cubemap(sky_mod.earth_atmosphere(), tuple(spec["sun_dir"]),
                                       float(spec["sun_lum"]), int(spec["size"]),
                                       int(spec["steps"]), device=device)
    return scene.build_scene(ents, pool, device, sky=sky, backend=cfg.get("backend", "auto"),
                             **build_kw)


def camera(cfg: dict, side: str):
    """The configuration's camera arrays (depth of field off), as the
    port's bench camera: a camera at `position` looking at `target`."""
    cam_mod = _modules(side)[4]
    c = cfg["camera"]
    cam = cam_mod.Camera(position=np.array(c["position"], np.float32))
    cam.look_at(list(c["target"]))
    return cam_mod.camera_arrays(cam, cam_mod.DofInfo(autofocus=False),
                                 cfg["width"], cfg["height"])
