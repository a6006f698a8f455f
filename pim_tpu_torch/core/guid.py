"""64-bit FNV-1a name/content hashing — the engine's asset identity scheme.

Equivalent of the reference's Guid (src/common/guid.h:25, fnv1a.c): every
asset, entity, and checkpoint blob is keyed by the FNV-1a hash of its name.
"""

from __future__ import annotations

_FNV_OFFSET = 0xCBF29CE484222325
_FNV_PRIME = 0x00000100000001B3
_MASK = 0xFFFFFFFFFFFFFFFF


def fnv1a_bytes(data: bytes, hash_: int = _FNV_OFFSET) -> int:
    h = hash_
    for b in data:
        h = ((h ^ b) * _FNV_PRIME) & _MASK
    return h


def guid_from_str(name: str) -> int:
    """Name -> 64-bit guid. Empty string hashes to 0 (null guid)."""
    if not name:
        return 0
    return fnv1a_bytes(name.encode("utf-8")) or 1


def guid_str(guid: int) -> str:
    return f"{guid:016x}"
