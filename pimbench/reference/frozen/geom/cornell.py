"""Cornell-box test scene, as `pim_tpu.geom.cornell`.

Six thin-slab walls (10x10x0.1 boxes on the +-5 planes), an emissive
1x1x0.1 ceiling light and either a 3x5 grid of spheres ('spheres') or two
boxes (any other variant).  Flat material colors go through the
reference's sRGB8 fit round trip so sampled values match.  The quaternion
helpers are the host-side numpy code of `pim_tpu.render.camera`.
"""

from __future__ import annotations

import numpy as np

from pimbench.reference.frozen.geom.entities import Entities
from pimbench.reference.frozen.geom.material import MatFlag, Material
from pimbench.reference.frozen.geom.mesh import gen_box_mesh, gen_sphere_mesh
from pimbench.reference.frozen.geom.material import TexturePool

K_DECI = 0.1

# cubemap face conventions
_FWD = {
    "XP": np.array([1.0, 0, 0]), "XM": np.array([-1.0, 0, 0]),
    "YP": np.array([0, 1.0, 0]), "YM": np.array([0, -1.0, 0]),
    "ZP": np.array([0, 0, 1.0]), "ZM": np.array([0, 0, -1.0]),
}
_UP = {
    "XP": np.array([0, 1.0, 0]), "XM": np.array([0, 1.0, 0]),
    "YP": np.array([0, 0, -1.0]), "YM": np.array([0, 0, -1.0]),
    "ZP": np.array([0, 1.0, 0]), "ZM": np.array([0, 1.0, 0]),
}


def mat3_to_quat(c0, c1, c2) -> np.ndarray:
    """Columns (right, up, forward-ish) -> quaternion (x, y, z, w)."""
    m = np.stack([c0, c1, c2], axis=1).astype(np.float64)
    tr = m[0, 0] + m[1, 1] + m[2, 2]
    if tr > 0:
        s = np.sqrt(tr + 1.0) * 2
        w = 0.25 * s
        x = (m[2, 1] - m[1, 2]) / s
        y = (m[0, 2] - m[2, 0]) / s
        z = (m[1, 0] - m[0, 1]) / s
    elif m[0, 0] > m[1, 1] and m[0, 0] > m[2, 2]:
        s = np.sqrt(1.0 + m[0, 0] - m[1, 1] - m[2, 2]) * 2
        w = (m[2, 1] - m[1, 2]) / s
        x = 0.25 * s
        y = (m[0, 1] + m[1, 0]) / s
        z = (m[0, 2] + m[2, 0]) / s
    elif m[1, 1] > m[2, 2]:
        s = np.sqrt(1.0 + m[1, 1] - m[0, 0] - m[2, 2]) * 2
        w = (m[0, 2] - m[2, 0]) / s
        x = (m[0, 1] + m[1, 0]) / s
        y = 0.25 * s
        z = (m[1, 2] + m[2, 1]) / s
    else:
        s = np.sqrt(1.0 + m[2, 2] - m[0, 0] - m[1, 1]) * 2
        w = (m[1, 0] - m[0, 1]) / s
        x = (m[0, 2] + m[2, 0]) / s
        y = (m[1, 2] + m[2, 1]) / s
        z = 0.25 * s
    q = np.array([x, y, z, w], np.float64)
    return (q / np.linalg.norm(q)).astype(np.float32)


def quat_lookat(forward: np.ndarray, up: np.ndarray) -> np.ndarray:
    """Quaternion looking along `forward` (cameras look down -Z, so the
    forward axis is negated internally)."""
    f = -np.asarray(forward, np.float64)[:3]
    u = np.asarray(up, np.float64)[:3]
    r = np.cross(u, f)
    r = r / np.linalg.norm(r)
    u = np.cross(f, r)
    u = u / np.linalg.norm(u)
    return mat3_to_quat(r, u, f)


def _srgb_inverse_eotf_fit(l: np.ndarray) -> np.ndarray:
    """Cubic-root sRGB encode fit."""
    l1 = np.sqrt(np.maximum(l, 0.0))
    l2 = np.sqrt(l1)
    l3 = np.sqrt(l2)
    return 0.658444 * l1 + 0.643378 * l2 - 0.298148 * l3


def _srgb_eotf_fit(v: np.ndarray) -> np.ndarray:
    """Cubic sRGB decode fit."""
    return 0.020883 * v + 0.656075 * v * v + 0.324285 * v * v * v


def flat_texel_roundtrip(rgba) -> np.ndarray:
    """Value -> sRGB8 texel -> decoded float, as the reference sees it."""
    v = np.clip(np.asarray(rgba, np.float64), 0.0, 1.0)
    enc = np.clip(_srgb_inverse_eotf_fit(v), 0.0, 1.0)
    q = np.floor(enc * 255.0 + 0.5) / 255.0
    return _srgb_eotf_fit(q).astype(np.float32)


def _gen_material(pool: TexturePool, albedo, rome, flags: int = 0, ior: float = 1.0) -> Material:
    """Emissive flag from rome.w."""
    mat = Material(ior=ior)
    mat.albedo_tex = pool.add_flat(flat_texel_roundtrip(albedo))
    mat.rome_tex = pool.add_flat(flat_texel_roundtrip(rome))
    f = MatFlag(flags)
    if rome[3] > 0.0:
        f |= MatFlag.EMISSIVE
    mat.flags = f
    return mat


def build_cornell_box(prim_type: str = "boxes"):
    """Returns (Entities, TexturePool).  'spheres' builds 15 spheres in three
    rows (metallic, plain, refractive with ior 1.5), roughness swept over
    the columns; any other variant builds the two boxes."""
    ents = Entities()
    pool = TexturePool()

    wall_extents = 5.0
    wall_scale = np.array([2 * wall_extents, 2 * wall_extents, K_DECI], np.float32)
    light_scale = 1.0

    c_hi, c_lo = 0.9, 1.0 - 0.9
    red = (c_hi, c_lo, c_lo, 1.0)
    green = (c_lo, c_hi, c_lo, 1.0)
    blue = (c_lo, c_lo, c_hi, 1.0)
    white = (c_hi, c_hi, c_hi, 1.0)
    plastic = (0.9, 1.0, 0.0, 0.0)
    metal = (0.1, 1.0, 1.0, 0.0)
    light = (0.9, 1.0, 0.0, 1.0)

    box = gen_box_mesh()

    def create_box(name, t, rot, s, albedo, rome, flags=0, ior=1.0):
        i = ents.add(name)
        ents.meshes[i] = box
        ents.materials[i] = _gen_material(pool, albedo, rome, flags, ior)
        ents.translations[i] = np.asarray(t, np.float32)
        ents.rotations[i] = np.asarray(rot, np.float32)
        ents.scales[i] = np.asarray(s, np.float32)
        return i

    def face(name):  # quat facing into the room from wall `name`
        return quat_lookat(_FWD[name], _UP[name])

    create_box("Cornell_Floor", _FWD["YM"] * wall_extents, face("YP"), wall_scale, white, plastic)
    create_box("Cornell_Ceil", _FWD["YP"] * wall_extents, face("YM"), wall_scale, white, plastic)
    create_box(
        "Cornell_Light",
        _FWD["YP"] * (wall_extents - K_DECI * 2.0),
        face("YM"),
        np.array([light_scale, light_scale, K_DECI], np.float32),
        (1.0, 1.0, 1.0, 1.0),
        light,
    )
    create_box("Cornell_Left", _FWD["XM"] * wall_extents, face("XP"), wall_scale, green, plastic)
    create_box("Cornell_Right", _FWD["XP"] * wall_extents, face("XM"), wall_scale, red, plastic)
    create_box("Cornell_Near", _FWD["ZP"] * wall_extents, face("ZP"), wall_scale, white, plastic)
    create_box("Cornell_Far", _FWD["ZM"] * wall_extents, face("ZM"), wall_scale, blue, plastic)

    if prim_type == "spheres":
        sphere = gen_sphere_mesh()
        sphere_scale = 0.75
        margin = sphere_scale * 1.5
        lo = -wall_extents + margin
        hi = wall_extents - margin
        rows, cols = 3, 5
        row_flags = [0, 0, int(MatFlag.REFRACTIVE)]
        row_metallic = [1.0, 0.0, 0.0]
        row_ior = [1.0, 1.0, 1.5]
        for ir in range(rows):
            z = lo + (hi - lo) * ((ir + 0.5) / rows)
            y = lo
            for ic in range(cols):
                t_col = (ic + 0.5) / cols
                x = lo + (hi - lo) * t_col
                i = ents.add(f"Cornell_Sphere_{ir}_{ic}")
                ents.meshes[i] = sphere
                ents.materials[i] = _gen_material(
                    pool, white, (t_col, 1.0, row_metallic[ir], 0.0),
                    row_flags[ir], row_ior[ir],
                )
                ents.translations[i] = np.array([x, y, z], np.float32)
                ents.scales[i] = np.full(3, sphere_scale, np.float32)
    else:
        box_scale = 2.0
        margin = box_scale * 0.5
        lo = -wall_extents + margin
        hi = wall_extents - margin
        up = np.array([0.0, 1.0, 0.0])
        x = lo + (hi - lo) * 0.2
        z = lo + (hi - lo) * 0.2
        d = np.array([0.2, 0.0, 1.0])
        create_box(
            "Cornell_MetalBox",
            np.array([x, -wall_extents + box_scale, z], np.float32),
            quat_lookat(d / np.linalg.norm(d), up),
            np.array([box_scale, box_scale * 2.0, box_scale], np.float32),
            white, metal,
        )
        x = lo + (hi - lo) * 0.8
        z = lo + (hi - lo) * 0.8
        d = np.array([-0.2, 0.0, 1.0])
        create_box(
            "Cornell_PlasticBox",
            np.array([x, -wall_extents + box_scale * 0.5, z], np.float32),
            quat_lookat(d / np.linalg.norm(d), up),
            np.full(3, box_scale, np.float32),
            white, plastic,
        )

    return ents, pool
