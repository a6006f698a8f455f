"""Materials and the texture atlas pool.

The port's copy of `pim_tpu.geom.material`, as far as the port needs it:
material flags and records, the atlas pool and the sRGB decode.  ALL
textures live in one [H, W, 4] float32 atlas; a material references
sub-rects by index into a per-texture record table.

Texture conventions:
  albedo: rgba, linear (sRGB decoded at import)
  rome:   roughness / occlusion / metallic / emission  (linear)
  normal: tangent-space xy in [-1, 1] (z reconstructed)

`TexturePool.add` snaps every texel to a bfloat16-representable float32,
as the reference does through `ml_dtypes`; torch's bfloat16 cast rounds
the same way (to nearest, ties to even), so the atlas is bitwise the
reference's.
"""

from __future__ import annotations

from dataclasses import dataclass
from enum import IntFlag
from typing import List, Tuple

import numpy as np
import torch


class MatFlag(IntFlag):
    NONE = 0
    EMISSIVE = 1 << 0
    SKY = 1 << 1
    WATER = 1 << 2
    SLIME = 1 << 3
    LAVA = 1 << 4
    REFRACTIVE = 1 << 5
    WARPED = 1 << 6
    ANIMATED = 1 << 7
    UNDERWATER = 1 << 8


@dataclass
class Material:
    """Host-side material record."""

    albedo_tex: int = -1          # texture id, -1 = constant white
    rome_tex: int = -1            # -1 = constant (0.5, 1, 0, 0)
    normal_tex: int = -1          # -1 = no normal map
    flags: int = MatFlag.NONE
    ior: float = 1.0
    mean_free_path: Tuple[float, float, float, float] = (0.0, 0.0, 0.0, 0.0)
    bumpiness: float = 1.0


class TexturePool:
    """Host-side registry of float32 rgba images packed into one atlas."""

    def __init__(self) -> None:
        self._images: List[np.ndarray] = []

    def add(self, image: np.ndarray) -> int:
        """image: [h, w, 4] float32 (linear). Returns the texture id.  Texels
        are snapped to bf16-representable float32 at registration, so every
        consumer (host tables, the atlas planes, the kernels) sees the same
        values."""
        img = np.asarray(image, np.float32)
        if img.ndim == 2:
            img = img[..., None]
        if img.shape[-1] < 4:
            pad = np.zeros(img.shape[:-1] + (4 - img.shape[-1],), np.float32)
            img = np.concatenate([img, pad], axis=-1)
        snapped = torch.from_numpy(np.ascontiguousarray(img)).to(torch.bfloat16)
        self._images.append(snapped.to(torch.float32).numpy())
        return len(self._images) - 1

    def add_flat(self, rgba) -> int:
        return self.add(np.asarray(rgba, np.float32).reshape(1, 1, 4))

    def get(self, tex_id: int) -> np.ndarray:
        """The [h, w, 4] float32 image registered under tex_id."""
        return self._images[tex_id]

    def __len__(self) -> int:
        return len(self._images)

    # --- persistence hooks (crate) ----------------------------------------
    # Textures ride with a saved map: material records hold atlas ids, which
    # dangle without the pool.

    def to_crate_entry(self) -> dict:
        return {"images": list(self._images)}

    @classmethod
    def from_crate_entry(cls, entry: dict) -> "TexturePool":
        pool = cls()
        for img in entry["images"]:
            pool.add(np.asarray(img, np.float32))
        return pool

    def pack(self) -> Tuple[np.ndarray, np.ndarray]:
        """Shelf-pack all images. Returns (atlas [H, W, 4], records [T, 4]
        int32 rows of (x0, y0, w, h))."""
        if not self._images:
            return np.zeros((1, 1, 4), np.float32), np.zeros((0, 4), np.int32)
        order = sorted(range(len(self._images)), key=lambda i: -self._images[i].shape[0])
        total_area = sum(im.shape[0] * im.shape[1] for im in self._images)
        atlas_w = 1
        while atlas_w * atlas_w < total_area * 1.3:
            atlas_w *= 2
        atlas_w = max(atlas_w, max(im.shape[1] for im in self._images))

        records = np.zeros((len(self._images), 4), np.int32)
        shelf_x, shelf_y, shelf_h = 0, 0, 0
        max_y = 0
        placements = []
        for idx in order:
            h, w = self._images[idx].shape[:2]
            if shelf_x + w > atlas_w:
                shelf_y += shelf_h
                shelf_x, shelf_h = 0, 0
            placements.append((idx, shelf_x, shelf_y))
            records[idx] = (shelf_x, shelf_y, w, h)
            shelf_x += w
            shelf_h = max(shelf_h, h)
            max_y = max(max_y, shelf_y + h)
        atlas_h = 1
        while atlas_h < max_y:
            atlas_h *= 2
        atlas = np.zeros((atlas_h, atlas_w, 4), np.float32)
        for idx, x, y in placements:
            im = self._images[idx]
            atlas[y : y + im.shape[0], x : x + im.shape[1]] = im
        return atlas, records


def srgb_to_linear(c: np.ndarray) -> np.ndarray:
    c = np.clip(np.asarray(c, np.float32), 0.0, 1.0)
    return np.where(c <= 0.04045, c / 12.92, ((c + 0.055) / 1.055) ** 2.4).astype(np.float32)


def linear_to_srgb(c: np.ndarray) -> np.ndarray:
    c = np.clip(np.asarray(c, np.float32), 0.0, 1.0)
    return np.where(
        c <= 0.0031308, c * 12.92, 1.055 * np.power(c, 1.0 / 2.4) - 0.055
    ).astype(np.float32)
