"""The texture atlas pool of `pim_tpu.geom.material`, with its bfloat16
snap done by torch.

`pim_tpu.geom.material.TexturePool.add` snaps every texel to a
bfloat16-representable float32 through `ml_dtypes`, a JAX dependency the
port does not have.  torch's bfloat16 cast rounds the same way (to
nearest, ties to even), so the atlas is bitwise the reference's.
"""

from __future__ import annotations

import numpy as np
import torch

from pim_tpu.geom import material


class TexturePool(material.TexturePool):
    """Host-side registry of float32 rgba images packed into one atlas."""

    def add(self, image: np.ndarray) -> int:
        """image: [h, w, 4] float32 (linear). Returns the texture id."""
        img = np.asarray(image, np.float32)
        if img.ndim == 2:
            img = img[..., None]
        if img.shape[-1] < 4:
            pad = np.zeros(img.shape[:-1] + (4 - img.shape[-1],), np.float32)
            img = np.concatenate([img, pad], axis=-1)
        snapped = torch.from_numpy(np.ascontiguousarray(img)).to(torch.bfloat16)
        self._images.append(snapped.to(torch.float32).numpy())
        return len(self._images) - 1
