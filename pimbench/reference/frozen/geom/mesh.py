"""Procedural mesh generators: box, quad, UV sphere (flat triangle soup).

Geometry matches the reference's generators (src/rendering/render_system.c:
GenBoxMesh :926, GenQuadMesh :877, GenSphereMesh :745) so cornell_box /
pt_test renders are comparable pixel-for-pixel.  Meshes are de-indexed
soups: positions/normals/uvs arrays of length 3*tri_count.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np


class MeshData(NamedTuple):
    positions: np.ndarray  # [V, 3] f32
    normals: np.ndarray    # [V, 3] f32
    uvs: np.ndarray        # [V, 2] f32

    @property
    def length(self) -> int:
        return self.positions.shape[0]


_BOX_V = np.array(
    [
        [1, 1, -1], [1, -1, -1], [1, 1, 1], [1, -1, 1],
        [-1, 1, -1], [-1, -1, -1], [-1, 1, 1], [-1, -1, 1],
    ],
    np.float32,
)
_BOX_VT = np.array(
    [
        [0.875, 0.500], [0.625, 0.750], [0.625, 0.500], [0.375, 1.000],
        [0.375, 0.750], [0.625, 0.000], [0.375, 0.250], [0.375, 0.000],
        [0.375, 0.500], [0.125, 0.750], [0.125, 0.500], [0.625, 0.250],
        [0.875, 0.750], [0.625, 1.000],
    ],
    np.float32,
)
_BOX_VN = np.array(
    [
        [0, 1, 0], [0, 0, 1], [-1, 0, 0], [0, -1, 0], [1, 0, 0], [0, 0, -1],
    ],
    np.float32,
)
# (position, uv, normal) 1-based index triplets, 12 triangles
_BOX_F = np.array(
    [
        [5, 1, 1], [3, 2, 1], [1, 3, 1],
        [3, 2, 2], [8, 4, 2], [4, 5, 2],
        [7, 6, 3], [6, 7, 3], [8, 8, 3],
        [2, 9, 4], [8, 10, 4], [6, 11, 4],
        [1, 3, 5], [4, 5, 5], [2, 9, 5],
        [5, 12, 6], [2, 9, 6], [6, 7, 6],
        [5, 1, 1], [7, 13, 1], [3, 2, 1],
        [3, 2, 2], [7, 14, 2], [8, 4, 2],
        [7, 6, 3], [5, 12, 3], [6, 7, 3],
        [2, 9, 4], [4, 5, 4], [8, 10, 4],
        [1, 3, 5], [3, 2, 5], [4, 5, 5],
        [5, 12, 6], [1, 3, 6], [2, 9, 6],
    ],
    np.int32,
)


def gen_box_mesh() -> MeshData:
    """Unit box centered at origin, extents [-0.5, 0.5]."""
    f = _BOX_F - 1
    positions = _BOX_V[f[:, 0]] * 0.5
    uvs = _BOX_VT[f[:, 1]]
    normals = _BOX_VN[f[:, 2]]
    return MeshData(positions.astype(np.float32), normals.astype(np.float32), uvs.astype(np.float32))


def gen_sphere_mesh(vsteps: int = 24) -> MeshData:
    """UV sphere of radius 1 (same tessellation scheme as the reference:
    pole caps are single triangle fans, body is quad strips)."""
    hsteps = vsteps * 2
    dv = np.pi / vsteps
    dh = 2.0 * np.pi / hsteps

    pos, nrm, uv = [], [], []

    def vert(theta, phi):
        st, ct = np.sin(theta), np.cos(theta)
        sp, cp = np.sin(phi), np.cos(phi)
        n = np.array([st * cp, ct, st * sp], np.float32)
        u = np.array([phi / (2 * np.pi), 1.0 - theta / np.pi], np.float32)
        return n, u

    for v in range(vsteps):
        t1, t2 = v * dv, (v + 1) * dv
        for h in range(hsteps):
            p1, p2 = h * dh, (h + 1) * dh
            n1, u1 = vert(t1, p1)
            n2, u2 = vert(t1, p2)
            n3, u3 = vert(t2, p2)
            n4, u4 = vert(t2, p1)
            if v == 0:
                tri = [(n1, u1), (n3, u3), (n4, u4)]
            elif v + 1 == vsteps:
                tri = [(n3, u3), (n1, u1), (n2, u2)]
            else:
                tri = [(n1, u1), (n2, u2), (n4, u4), (n2, u2), (n3, u3), (n4, u4)]
            for n, u in tri:
                pos.append(n)
                nrm.append(n)
                uv.append(u)

    return MeshData(
        np.asarray(pos, np.float32), np.asarray(nrm, np.float32), np.asarray(uv, np.float32)
    )
