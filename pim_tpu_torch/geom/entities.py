"""Entity table (ECS-lite) and world-space scene flattening.

The port's copy of `pim_tpu.geom.entities`.  Counterpart of src/rendering/drawable.{c,h} (single SoA table keyed by guid,
with a modtime that invalidates the traced scene) and FlattenDrawables
(src/rendering/path_tracer.c:692-782): every entity's mesh is transformed to
world space and concatenated into one flat triangle soup with per-entity
material ids.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, NamedTuple, Optional

import numpy as np

from pim_tpu_torch.core.guid import guid_from_str
from pim_tpu_torch.geom.material import Material
from pim_tpu_torch.geom.mesh import MeshData


def _quat_to_mat3(q: np.ndarray) -> np.ndarray:
    x, y, z, w = np.asarray(q, np.float64)
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
            [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
            [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
        ]
    )


@dataclass
class Entities:
    """SoA entity table (ref drawable.h:14-27)."""

    names: List[str] = field(default_factory=list)
    guids: List[int] = field(default_factory=list)
    meshes: List[Optional[MeshData]] = field(default_factory=list)
    materials: List[Material] = field(default_factory=list)
    translations: List[np.ndarray] = field(default_factory=list)
    rotations: List[np.ndarray] = field(default_factory=list)  # quat xyzw
    scales: List[np.ndarray] = field(default_factory=list)
    modtime: int = 0

    @property
    def count(self) -> int:
        return len(self.names)

    def add(self, name: str) -> int:
        self.names.append(name)
        self.guids.append(guid_from_str(name))
        self.meshes.append(None)
        self.materials.append(Material())
        self.translations.append(np.zeros(3, np.float32))
        self.rotations.append(np.array([0, 0, 0, 1], np.float32))
        self.scales.append(np.ones(3, np.float32))
        self.modtime += 1
        return self.count - 1

    def find(self, name: str) -> int:
        g = guid_from_str(name)
        try:
            return self.guids.index(g)
        except ValueError:
            return -1

    def remove(self, index: int) -> None:
        for lst in (
            self.names, self.guids, self.meshes, self.materials,
            self.translations, self.rotations, self.scales,
        ):
            lst.pop(index)
        self.modtime += 1

    def clear(self) -> None:
        self.__init__(modtime=self.modtime + 1)

    def touch(self) -> None:
        self.modtime += 1

    # --- persistence hooks (crate) -----------------------------------------

    def to_crate_entry(self) -> dict:
        return {
            "names": list(self.names),
            "meshes": [
                None if m is None else {"positions": m.positions, "normals": m.normals, "uvs": m.uvs}
                for m in self.meshes
            ],
            "materials": [
                {
                    "albedo_tex": mat.albedo_tex, "rome_tex": mat.rome_tex,
                    "normal_tex": mat.normal_tex, "flags": int(mat.flags),
                    "ior": mat.ior, "mean_free_path": tuple(mat.mean_free_path),
                }
                for mat in self.materials
            ],
            "translations": np.asarray(self.translations, np.float32),
            "rotations": np.asarray(self.rotations, np.float32),
            "scales": np.asarray(self.scales, np.float32),
        }

    @classmethod
    def from_crate_entry(cls, entry: dict) -> "Entities":
        ents = cls()
        for i, name in enumerate(entry["names"]):
            idx = ents.add(name)
            m = entry["meshes"][i]
            if m is not None:
                ents.meshes[idx] = MeshData(m["positions"], m["normals"], m["uvs"])
            md = entry["materials"][i]
            ents.materials[idx] = Material(
                albedo_tex=int(md["albedo_tex"]), rome_tex=int(md["rome_tex"]),
                normal_tex=int(md["normal_tex"]), flags=int(md["flags"]),
                ior=float(md["ior"]), mean_free_path=tuple(md["mean_free_path"]),
            )
            ents.translations[idx] = np.asarray(entry["translations"][i], np.float32)
            ents.rotations[idx] = np.asarray(entry["rotations"][i], np.float32)
            ents.scales[idx] = np.asarray(entry["scales"][i], np.float32)
        return ents


class FlatScene(NamedTuple):
    """World-space triangle soup + per-entity material list (host, numpy)."""

    positions: np.ndarray  # [V, 3]
    normals: np.ndarray    # [V, 3]
    uvs: np.ndarray        # [V, 2]
    mat_ids: np.ndarray    # [V//3] int32, per-triangle
    materials: List[Material]


def flatten(entities: Entities) -> FlatScene:
    """World-space bake of all entities (ref FlattenDrawables :692-782).

    Normals transform by the inverse-transpose of the model matrix.
    """
    positions, normals, uvs, mat_ids = [], [], [], []
    materials: List[Material] = []
    for i in range(entities.count):
        mesh = entities.meshes[i]
        if mesh is None or mesh.length == 0:
            continue
        r = _quat_to_mat3(entities.rotations[i])
        s = np.asarray(entities.scales[i], np.float64)
        t = np.asarray(entities.translations[i], np.float64)
        m = r @ np.diag(s)                      # model matrix (3x3 part)
        im_t = np.linalg.inv(m).T               # inverse-transpose for normals
        p = mesh.positions.astype(np.float64) @ m.T + t
        n = mesh.normals.astype(np.float64) @ im_t.T
        n /= np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-12)
        positions.append(p.astype(np.float32))
        normals.append(n.astype(np.float32))
        uvs.append(mesh.uvs)
        mat_ids.append(np.full(mesh.length // 3, len(materials), np.int32))
        materials.append(entities.materials[i])
    if not positions:
        return FlatScene(
            np.zeros((0, 3), np.float32), np.zeros((0, 3), np.float32),
            np.zeros((0, 2), np.float32), np.zeros((0,), np.int32), [],
        )
    return FlatScene(
        np.concatenate(positions), np.concatenate(normals),
        np.concatenate(uvs), np.concatenate(mat_ids), materials,
    )
