"""Procedural multi-room map generator (the e1m1-class test asset).

The port's copy of `pim_tpu.geom.maps` (numpy only).

The reference ships Quake-derived maps loaded via glTF
(src/rendering/render_system.c:1417-1464, gltf_model.c:105-660); those
assets are not redistributable, so the framework generates a deterministic
multi-room interior of the same shape and scale instead: a grid of rooms
joined by doorways, textured walls/floors, emissive ceiling panels, and
pedestal-mounted spheres sweeping roughness/metallic/refraction — ~80k
triangles at the default size, squarely in the reference map class.

`export_map` writes the scene to data/<name>/glTF/<name>.gltf so `mapload`
exercises the real on-disk import pipeline end to end.
"""

from __future__ import annotations

import os
from typing import Tuple

import numpy as np

from pim_tpu_torch.geom.entities import Entities
from pim_tpu_torch.geom.material import MatFlag, Material, TexturePool
from pim_tpu_torch.geom.mesh import gen_box_mesh, gen_sphere_mesh

ROOM = 8.0        # room pitch, meters
HEIGHT = 4.0      # ceiling height
THICK = 0.2       # wall thickness
DOOR_W = 2.0
DOOR_H = 2.8


def _value_noise(rng: np.random.Generator, n: int, octaves: int = 4) -> np.ndarray:
    """Tileable [n, n] value noise in [0, 1] (host-side texture synthesis)."""
    acc = np.zeros((n, n), np.float64)
    amp, total = 1.0, 0.0
    for o in range(octaves):
        cells = 2 ** (o + 2)
        if cells > n:
            break
        g = rng.random((cells, cells))
        g = np.concatenate([g, g[:1]], axis=0)
        g = np.concatenate([g, g[:, :1]], axis=1)
        ys = np.linspace(0, cells, n, endpoint=False)
        xs = np.linspace(0, cells, n, endpoint=False)
        y0 = ys.astype(int)
        x0 = xs.astype(int)
        fy = (ys - y0)[:, None]
        fx = (xs - x0)[None, :]
        fy = fy * fy * (3 - 2 * fy)
        fx = fx * fx * (3 - 2 * fx)
        v = (
            g[np.ix_(y0, x0)] * (1 - fy) * (1 - fx)
            + g[np.ix_(y0 + 1, x0)] * fy * (1 - fx)
            + g[np.ix_(y0, x0 + 1)] * (1 - fy) * fx
            + g[np.ix_(y0 + 1, x0 + 1)] * fy * fx
        )
        acc += amp * v
        total += amp
        amp *= 0.5
    return (acc / total).astype(np.float32)


def _checker_albedo(rng, n: int, c0, c1, tiles: int = 4) -> np.ndarray:
    yy, xx = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
    mask = (((yy * tiles // n) + (xx * tiles // n)) % 2).astype(np.float32)
    noise = 0.85 + 0.3 * _value_noise(rng, n)
    rgb = (
        np.asarray(c0, np.float32)[None, None] * (1 - mask[..., None])
        + np.asarray(c1, np.float32)[None, None] * mask[..., None]
    ) * noise[..., None]
    return np.concatenate(
        [np.clip(rgb, 0, 1), np.ones((n, n, 1), np.float32)], axis=-1
    )


def _brick_albedo(rng, n: int, tint) -> np.ndarray:
    rows = 8
    yy, xx = np.meshgrid(
        np.linspace(0, rows, n, endpoint=False),
        np.linspace(0, rows, n, endpoint=False),
        indexing="ij",
    )
    row = np.floor(yy)
    x_off = xx + 0.5 * (row % 2)
    mortar_y = np.abs(yy - np.round(yy)) < 0.06
    mortar_x = np.abs(x_off * 2 - np.round(x_off * 2)) < 0.04
    mortar = (mortar_y | mortar_x).astype(np.float32)
    noise = 0.75 + 0.5 * _value_noise(rng, n)
    brick = np.asarray(tint, np.float32)[None, None] * noise[..., None]
    mortar_c = np.full((n, n, 3), 0.55, np.float32) * (
        0.9 + 0.2 * _value_noise(rng, n)[..., None]
    )
    rgb = brick * (1 - mortar[..., None]) + mortar_c * mortar[..., None]
    return np.concatenate(
        [np.clip(rgb, 0, 1), np.ones((n, n, 1), np.float32)], axis=-1
    )


def _rome_texture(rng, n: int, rough_lo: float, rough_hi: float) -> np.ndarray:
    rough = rough_lo + (rough_hi - rough_lo) * _value_noise(rng, n)
    rome = np.zeros((n, n, 4), np.float32)
    rome[..., 0] = rough
    rome[..., 1] = 1.0
    return rome


def _bump_normal(rng, n: int, strength: float = 0.6) -> np.ndarray:
    h = _value_noise(rng, n, octaves=5)
    gy = np.roll(h, -1, axis=0) - np.roll(h, 1, axis=0)
    gx = np.roll(h, -1, axis=1) - np.roll(h, 1, axis=1)
    nx = np.clip(-gx * n * strength * 0.02, -1, 1)
    ny = np.clip(-gy * n * strength * 0.02, -1, 1)
    nz = np.sqrt(np.maximum(1.0 - nx * nx - ny * ny, 0.0))
    return np.stack([nx, ny, nz, np.ones_like(nz)], axis=-1).astype(np.float32)


def build_map_scene(
    rooms: Tuple[int, int] = (3, 3),
    spheres_per_room: int = 4,
    sphere_steps: int = 24,
    tex_size: int = 64,
    seed: int = 1,
) -> Tuple[Entities, TexturePool]:
    """Deterministic multi-room interior. Returns (Entities, TexturePool)."""
    rng = np.random.default_rng(seed)
    ents = Entities()
    pool = TexturePool()
    box = gen_box_mesh()
    sphere = gen_sphere_mesh(sphere_steps)
    rx, rz = rooms

    # --- shared materials ---------------------------------------------------
    floor_mat = Material(
        albedo_tex=pool.add(_checker_albedo(rng, tex_size, (0.45, 0.42, 0.38), (0.2, 0.2, 0.22))),
        rome_tex=pool.add(_rome_texture(rng, tex_size, 0.35, 0.75)),
    )
    wall_mat = Material(
        albedo_tex=pool.add(_brick_albedo(rng, tex_size, (0.55, 0.34, 0.24))),
        rome_tex=pool.add(_rome_texture(rng, tex_size, 0.6, 0.95)),
        normal_tex=pool.add(_bump_normal(rng, tex_size)),
    )
    ceil_mat = Material(
        albedo_tex=pool.add_flat((0.7, 0.7, 0.72, 1.0)),
        rome_tex=pool.add_flat((0.9, 1.0, 0.0, 0.0)),
    )
    pillar_mat = Material(
        albedo_tex=pool.add_flat((0.8, 0.8, 0.82, 1.0)),
        rome_tex=pool.add_flat((0.25, 1.0, 1.0, 0.0)),
    )
    pedestal_mat = Material(
        albedo_tex=pool.add_flat((0.35, 0.35, 0.38, 1.0)),
        rome_tex=pool.add_flat((0.8, 1.0, 0.0, 0.0)),
    )
    light_mat = Material(
        albedo_tex=pool.add_flat((1.0, 0.95, 0.85, 1.0)),
        rome_tex=pool.add_flat((0.9, 1.0, 0.0, 0.8)),
        flags=MatFlag.EMISSIVE,
    )
    glass_mat = Material(
        albedo_tex=pool.add_flat((0.98, 0.98, 0.98, 1.0)),
        rome_tex=pool.add_flat((0.05, 1.0, 0.0, 0.0)),
        flags=MatFlag.REFRACTIVE,
        ior=1.5,
    )

    def add_box(name, center, size, mat):
        i = ents.add(name)
        ents.meshes[i] = box
        ents.materials[i] = mat
        ents.translations[i] = np.asarray(center, np.float32)
        ents.scales[i] = np.asarray(size, np.float32)
        return i

    # --- shell: floor + ceiling slabs spanning the whole grid ---------------
    wx = rx * ROOM + THICK
    wz = rz * ROOM + THICK
    cx = (rx - 1) * ROOM * 0.5
    cz = (rz - 1) * ROOM * 0.5
    add_box("Map_Floor", (cx, -THICK * 0.5, cz), (wx, THICK, wz), floor_mat)
    add_box("Map_Ceil", (cx, HEIGHT + THICK * 0.5, cz), (wx, THICK, wz), ceil_mat)

    # --- walls on grid edges; interior edges get a doorway ------------------
    def wall_segments(name, axis, line, lo, hi, with_door):
        """axis 0: wall plane x=line spanning z in [lo, hi]; axis 2: plane
        z=line spanning x. Emits solid segments (and a lintel over a door)."""
        mid = (lo + hi) * 0.5
        segs = []
        if with_door:
            segs.append((lo, mid - DOOR_W / 2, 0.0, HEIGHT))
            segs.append((mid + DOOR_W / 2, hi, 0.0, HEIGHT))
            segs.append((mid - DOOR_W / 2, mid + DOOR_W / 2, DOOR_H, HEIGHT))
        else:
            segs.append((lo, hi, 0.0, HEIGHT))
        for k, (s0, s1, y0, y1) in enumerate(segs):
            if s1 - s0 <= 1e-6 or y1 - y0 <= 1e-6:
                continue
            length = s1 - s0
            yc = (y0 + y1) * 0.5
            sc = (s0 + s1) * 0.5
            if axis == 0:
                center = (line, yc, sc)
                size = (THICK, y1 - y0, length)
            else:
                center = (sc, yc, line)
                size = (length, y1 - y0, THICK)
            add_box(f"{name}_{k}", center, size, wall_mat)

    for i in range(rx + 1):
        x = (i - 0.5) * ROOM
        for j in range(rz):
            z0, z1 = (j - 0.5) * ROOM, (j + 0.5) * ROOM
            interior = 0 < i < rx
            wall_segments(f"Map_WallX_{i}_{j}", 0, x, z0, z1, interior)
    for j in range(rz + 1):
        z = (j - 0.5) * ROOM
        for i in range(rx):
            x0, x1 = (i - 0.5) * ROOM, (i + 0.5) * ROOM
            interior = 0 < j < rz
            wall_segments(f"Map_WallZ_{i}_{j}", 2, z, x0, x1, interior)

    # --- per room: light panel, pillars, pedestals + spheres ----------------
    sphere_palette = [
        ("metal", lambda r: Material(
            albedo_tex=pool.add_flat((0.95, 0.93, 0.88, 1.0)),
            rome_tex=pool.add_flat((r, 1.0, 1.0, 0.0)))),
        ("plastic", lambda r: Material(
            albedo_tex=pool.add_flat(tuple(rng.uniform(0.2, 0.9, 3)) + (1.0,)),
            rome_tex=pool.add_flat((r, 1.0, 0.0, 0.0)))),
        ("glass", lambda r: glass_mat),
    ]
    # emissive geometry stays low-poly (boxes, not spheres): every emissive
    # TRIANGLE is a light-grid entry and a NEE candidate, so E must stay in
    # the hundreds at map scale (same discipline as Quake-style fixtures)
    sconce_mat = Material(
        albedo_tex=pool.add_flat((1.0, 0.75, 0.45, 1.0)),
        rome_tex=pool.add_flat((0.9, 1.0, 0.0, 0.45)),
        flags=MatFlag.EMISSIVE,
    )
    # Quake-style sky brush (ref MatFlag_Sky, material.h:12-20 + the `sky`
    # name token in gltf import): a SKY-flagged panel terminates paths
    # with sky-cubemap radiance, acting as a skylight window — BASELINE
    # config #4 (e1m1 + sky + autoexposure) lights half the rooms this way
    sky_mat = Material(
        albedo_tex=pool.add_flat((1.0, 1.0, 1.0, 1.0)),
        rome_tex=pool.add_flat((1.0, 1.0, 0.0, 0.0)),
        flags=MatFlag.SKY,
    )

    for i in range(rx):
        for j in range(rz):
            ox, oz = i * ROOM, j * ROOM
            add_box(
                f"Map_Light_{i}_{j}",
                (ox, HEIGHT - 0.05, oz),
                (1.6, 0.1, 1.6),
                light_mat,
            )
            if (i + j) % 2 == 0:
                add_box(
                    f"Map_sky_light_{i}_{j}",
                    (ox, HEIGHT - 0.02, oz + ROOM * 0.28),
                    (2.4, 0.04, 2.4),
                    sky_mat,
                )
            for px, pz in ((-1, -1), (-1, 1), (1, -1), (1, 1)):
                add_box(
                    f"Map_Pillar_{i}_{j}_{px}_{pz}",
                    (ox + px * (ROOM / 2 - 1.0), HEIGHT / 2, oz + pz * (ROOM / 2 - 1.0)),
                    (0.5, HEIGHT, 0.5),
                    pillar_mat,
                )
                add_box(
                    f"Map_Sconce_{i}_{j}_{px}_{pz}",
                    (ox + px * (ROOM / 2 - 1.0), HEIGHT * 0.7,
                     oz + pz * (ROOM / 2 - 1.0)),
                    (0.6, 0.25, 0.6),
                    sconce_mat,
                )
            for k in range(spheres_per_room):
                ang = rng.uniform(0, 2 * np.pi)
                rad = rng.uniform(1.0, ROOM / 2 - 1.8)
                sx = ox + rad * np.cos(ang)
                sz = oz + rad * np.sin(ang)
                r_sph = rng.uniform(0.35, 0.6)
                ped_h = rng.uniform(0.5, 1.0)
                add_box(
                    f"Map_Pedestal_{i}_{j}_{k}",
                    (sx, ped_h / 2, sz),
                    (0.7, ped_h, 0.7),
                    pedestal_mat,
                )
                kind, mk = sphere_palette[int(rng.integers(len(sphere_palette)))]
                rough = float(rng.uniform(0.05, 0.9))
                e = ents.add(f"Map_Sphere_{kind}_{i}_{j}_{k}")
                ents.meshes[e] = sphere
                ents.materials[e] = mk(rough)
                ents.translations[e] = np.array(
                    [sx, ped_h + r_sph, sz], np.float32
                )
                ents.scales[e] = np.full(3, r_sph, np.float32)

    return ents, pool


def export_map(name: str, base_dir: str = "data", binary: bool = False,
               **kwargs) -> str:
    """Generate and write data/<name>/glTF/<name>.gltf (reference map layout,
    render_system.c:1456-1458). Returns the written path."""
    from pim_tpu_torch.geom.gltf import save_gltf_scene

    ents, pool = build_map_scene(**kwargs)
    ext = "glb" if binary else "gltf"
    path = os.path.join(base_dir, name, "glTF", f"{name}.{ext}")
    save_gltf_scene(ents, pool, path, binary=binary)
    return path
