"""Crate: guid-keyed checkpoint archive (save format / resume substrate).

Equivalent of the reference's Crate (src/assets/crate.h:9-35): a directory of
{guid -> blob} used to persist entities and the resumable progressive
lightmap bake (sample counts + accumulators).  Here a crate is a .npz of
arrays keyed by `g<guid-hex>_<field>` plus a JSON manifest, which round-trips
pytrees of numpy arrays and scalars.  The port's copy of `pim_tpu.core.crate`:
the format is the same, so a crate written by either package loads in the
other.
"""

from __future__ import annotations

import io
import json
import os
import zipfile
from typing import Any, Dict

import numpy as np

from pim_tpu_torch.core.guid import guid_from_str

_MANIFEST = "crate_manifest.json"


def _flatten(prefix: str, obj: Any, arrays: Dict[str, np.ndarray], meta: Dict[str, Any]):
    if isinstance(obj, dict):
        meta[prefix] = {"kind": "dict", "keys": sorted(obj.keys())}
        for k in obj:
            _flatten(f"{prefix}/{k}", obj[k], arrays, meta)
    elif isinstance(obj, (list, tuple)):
        meta[prefix] = {"kind": "list", "len": len(obj), "tuple": isinstance(obj, tuple)}
        for i, v in enumerate(obj):
            _flatten(f"{prefix}/{i}", v, arrays, meta)
    elif obj is None:
        meta[prefix] = {"kind": "none"}
    elif isinstance(obj, (int, float, str, bool)):
        meta[prefix] = {"kind": "scalar", "value": obj}
    else:
        arr = np.asarray(obj)
        arrays[prefix] = arr
        meta[prefix] = {"kind": "array"}


def _unflatten(prefix: str, arrays, meta: Dict[str, Any]):
    rec = meta[prefix]
    kind = rec["kind"]
    if kind == "dict":
        return {k: _unflatten(f"{prefix}/{k}", arrays, meta) for k in rec["keys"]}
    if kind == "list":
        items = [_unflatten(f"{prefix}/{i}", arrays, meta) for i in range(rec["len"])]
        return tuple(items) if rec.get("tuple") else items
    if kind == "none":
        return None
    if kind == "scalar":
        return rec["value"]
    return arrays[prefix]


class Crate:
    """A guid-keyed archive. Entries are arbitrary pytrees of arrays/scalars."""

    def __init__(self) -> None:
        self._entries: Dict[int, Any] = {}

    def set(self, name_or_guid, value: Any) -> None:
        self._entries[self._key(name_or_guid)] = value

    def get(self, name_or_guid, default=None) -> Any:
        return self._entries.get(self._key(name_or_guid), default)

    def has(self, name_or_guid) -> bool:
        return self._key(name_or_guid) in self._entries

    def guids(self):
        return sorted(self._entries)

    @staticmethod
    def _key(name_or_guid) -> int:
        if isinstance(name_or_guid, str):
            return guid_from_str(name_or_guid)
        return int(name_or_guid)

    # --- io ---------------------------------------------------------------

    def save(self, path: str) -> None:
        arrays: Dict[str, np.ndarray] = {}
        meta: Dict[str, Any] = {"__guids__": [f"{g:016x}" for g in self.guids()]}
        for g, val in self._entries.items():
            _flatten(f"g{g:016x}", val, arrays, meta)
        tmp = path + ".tmp"
        with zipfile.ZipFile(tmp, "w", zipfile.ZIP_DEFLATED) as zf:
            zf.writestr(_MANIFEST, json.dumps(meta))
            for key, arr in arrays.items():
                buf = io.BytesIO()
                np.save(buf, arr, allow_pickle=False)
                zf.writestr(key + ".npy", buf.getvalue())
        os.replace(tmp, path)

    @classmethod
    def load(cls, path: str) -> "Crate":
        crate = cls()
        with zipfile.ZipFile(path, "r") as zf:
            meta = json.loads(zf.read(_MANIFEST))
            arrays: Dict[str, np.ndarray] = {}
            for info in zf.infolist():
                if info.filename.endswith(".npy"):
                    arrays[info.filename[:-4]] = np.load(
                        io.BytesIO(zf.read(info)), allow_pickle=False
                    )
        for ghex in meta["__guids__"]:
            g = int(ghex, 16)
            crate._entries[g] = _unflatten(f"g{ghex}", arrays, meta)
        return crate
