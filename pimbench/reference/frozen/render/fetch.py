"""Attribute fetch: the fused per-triangle table and its column fetch.

Counterpart of `pim_tpu.render.fetch`.  Every per-hit attribute lives in
ONE transposed [48, T] float32 table; a fetch returns an [F, N] block whose
rows are [N] tensors.  On the card every fetch is one K3 launch
(render/gather_kernel.py), whatever the table or batch size.
"""

from __future__ import annotations

import numpy as np
import torch

from pimbench.reference.frozen.math.vec3 import V3
from pimbench.reference.frozen.render.gather_kernel import gather_cols


def fetch_cols(table_t: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """table_t [F, T], idx int [N] -> [F, N] (columns of the table; 0 for
    an index outside [0, T))."""
    return gather_cols(table_t, idx)


# ---------------------------------------------------------------------------
# The fused per-triangle attribute table, stored TRANSPOSED [48, T].
# Row indices (ints are exact in f32 below 2^24):
# ---------------------------------------------------------------------------
PA = slice(0, 3)        # vertex A position
PB = slice(3, 6)
PC = slice(6, 9)
NA = slice(9, 12)       # vertex normals
NB = slice(12, 15)
NC = slice(15, 18)
UVA = slice(18, 20)     # vertex uvs
UVB = slice(20, 22)
UVC = slice(22, 24)
ALBEDO = slice(24, 28)  # flat material albedo (rgba)
ROME = slice(28, 32)    # flat material rome
IOR = 32
FLAGS = 33
MFP = slice(34, 38)
ALBEDO_TEX = 38
ROME_TEX = 39
NORMAL_TEX = 40
MAT_ID = 41
AREA = 42
EMIT_IDX = 43           # -1 when not emissive
TRI_TABLE_ROWS = 48     # padded to a multiple of 8


def v3_rows(block: torch.Tensor, sl: slice) -> V3:
    """[F, N] block + 3-row slice -> V3 of [N]."""
    return V3(block[sl.start], block[sl.start + 1], block[sl.start + 2])


def build_tri_table(flat, mats, tri_to_emit, atlas, tex_rec) -> np.ndarray:
    """Host-side build of the fused attribute table, TRANSPOSED [48, T].

    Flat (1x1) textures are inlined as constants; textured materials store
    their atlas ids, sampled through K6 (render/surface.py)."""
    tri_count = flat.mat_ids.shape[0]
    t = np.zeros((max(tri_count, 1), TRI_TABLE_ROWS), np.float32)
    if tri_count == 0:
        return np.ascontiguousarray(t.T)
    pos = flat.positions.reshape(tri_count, 3, 3)
    nrm = flat.normals.reshape(tri_count, 3, 3)
    uv = flat.uvs.reshape(tri_count, 3, 2)
    t[:, PA] = pos[:, 0]
    t[:, PB] = pos[:, 1]
    t[:, PC] = pos[:, 2]
    t[:, NA] = nrm[:, 0]
    t[:, NB] = nrm[:, 1]
    t[:, NC] = nrm[:, 2]
    t[:, UVA] = uv[:, 0]
    t[:, UVB] = uv[:, 1]
    t[:, UVC] = uv[:, 2]

    def flat_texel(tex_id, default):
        if tex_id < 0:
            return np.asarray(default, np.float32)
        x0, y0, w, h = tex_rec[tex_id]
        if w == 1 and h == 1:
            return atlas[y0, x0]
        return None  # textured

    for m_idx, mat in enumerate(mats):
        sel = flat.mat_ids == m_idx
        alb = flat_texel(mat.albedo_tex, [1, 1, 1, 1])
        rom = flat_texel(mat.rome_tex, [0.5, 1, 0, 0])
        t[sel, ALBEDO] = alb if alb is not None else 0.0
        t[sel, ROME] = rom if rom is not None else 0.0
        t[sel, IOR] = mat.ior
        t[sel, FLAGS] = float(int(mat.flags))
        t[sel, MFP] = np.asarray(mat.mean_free_path, np.float32)
        t[sel, ALBEDO_TEX] = float(mat.albedo_tex if alb is None else -1)
        t[sel, ROME_TEX] = float(mat.rome_tex if rom is None else -1)
        t[sel, NORMAL_TEX] = float(mat.normal_tex)
        t[sel, MAT_ID] = float(m_idx)

    e1 = pos[:, 1] - pos[:, 0]
    e2 = pos[:, 2] - pos[:, 0]
    t[:, AREA] = 0.5 * np.linalg.norm(np.cross(e1, e2), axis=-1)
    t[:, EMIT_IDX] = tri_to_emit.astype(np.float32)
    return np.ascontiguousarray(t.T)  # [48, T]
