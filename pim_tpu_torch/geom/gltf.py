"""glTF 2.0 scene import into the port's texture pool.

Counterpart of `pim_tpu.geom.gltf.load_gltf_scene`, with the port's own
copies of its buffer, accessor and node-matrix helpers and of the stdlib PNG
reader (the reference decodes through `pim_tpu.render.screenshot.read_png`;
8-bit, no interlace).  The atlas and the texture records come out bitwise
the reference's.
"""

from __future__ import annotations

import base64
import json
import os
import struct
import zlib
from typing import Dict, List, Optional, Tuple

import numpy as np

from pim_tpu_torch.geom.cornell import mat3_to_quat
from pim_tpu_torch.geom.entities import Entities
from pim_tpu_torch.geom.material import MatFlag, Material, TexturePool, srgb_to_linear
from pim_tpu_torch.geom.mesh import MeshData

_COMP_DTYPE = {
    5120: np.int8, 5121: np.uint8, 5122: np.int16,
    5123: np.uint16, 5125: np.uint32, 5126: np.float32,
}
_TYPE_COUNT = {"SCALAR": 1, "VEC2": 2, "VEC3": 3, "VEC4": 4, "MAT4": 16}


def _load_buffers(doc: dict, base_dir: str, glb_bin: Optional[bytes]) -> List[bytes]:
    out = []
    for buf in doc.get("buffers", []):
        uri = buf.get("uri")
        if uri is None:
            out.append(glb_bin or b"")
        elif uri.startswith("data:"):
            out.append(base64.b64decode(uri.split(",", 1)[1]))
        else:
            with open(os.path.join(base_dir, uri), "rb") as f:
                out.append(f.read())
    return out


def _read_accessor(doc: dict, buffers: List[bytes], idx: int) -> np.ndarray:
    acc = doc["accessors"][idx]
    view = doc["bufferViews"][acc["bufferView"]]
    dtype = _COMP_DTYPE[acc["componentType"]]
    ncomp = _TYPE_COUNT[acc["type"]]
    count = acc["count"]
    itemsize = np.dtype(dtype).itemsize * ncomp
    stride = view.get("byteStride", itemsize)
    offset = view.get("byteOffset", 0) + acc.get("byteOffset", 0)
    buf = buffers[view["buffer"]]
    if stride == itemsize:
        arr = np.frombuffer(buf, dtype, count * ncomp, offset).reshape(count, ncomp)
    else:
        arr = np.zeros((count, ncomp), dtype)
        for i in range(count):
            arr[i] = np.frombuffer(buf, dtype, ncomp, offset + i * stride)
    if acc.get("normalized"):
        info = np.iinfo(dtype)
        arr = arr.astype(np.float32) / info.max
    return arr


def _node_matrix(node: dict) -> np.ndarray:
    if "matrix" in node:
        return np.asarray(node["matrix"], np.float64).reshape(4, 4).T
    m = np.eye(4)
    t = node.get("translation", [0, 0, 0])
    r = node.get("rotation", [0, 0, 0, 1])
    s = node.get("scale", [1, 1, 1])
    x, y, z, w = r
    rot = np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
            [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
            [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
        ]
    )
    m[:3, :3] = rot @ np.diag(s)
    m[:3, 3] = t
    return m


def _paeth(a: int, b: int, c: int) -> int:
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    return a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)


def decode_png(data: bytes) -> np.ndarray:
    """8-bit, non-interlaced PNG bytes -> [h, w, channels] uint8."""
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError("not a PNG")
    pos = 8
    idat = b""
    w = h = channels = 0
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos : pos + 4])
        tag = data[pos + 4 : pos + 8]
        body = data[pos + 8 : pos + 8 + length]
        pos += 12 + length
        if tag == b"IHDR":
            w, h, depth, ctype, *_ = struct.unpack(">IIBBBBB", body)
            channels = {0: 1, 2: 3, 6: 4}[ctype]
        elif tag == b"IDAT":
            idat += body
        elif tag == b"IEND":
            break
    raw = zlib.decompress(idat)
    stride = w * channels
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(h):
        ft = raw[y * (stride + 1)]
        line = np.frombuffer(raw[y * (stride + 1) + 1 : (y + 1) * (stride + 1)], np.uint8).copy()
        if ft == 1:  # sub
            for x in range(channels, stride):
                line[x] = (int(line[x]) + int(line[x - channels])) & 0xFF
        elif ft == 2:  # up
            line = (line.astype(np.int32) + prev).astype(np.uint8)
        elif ft == 3:  # average
            for x in range(stride):
                left = int(line[x - channels]) if x >= channels else 0
                line[x] = (int(line[x]) + ((left + int(prev[x])) >> 1)) & 0xFF
        elif ft == 4:  # paeth
            for x in range(stride):
                a = int(line[x - channels]) if x >= channels else 0
                c = int(prev[x - channels]) if x >= channels else 0
                line[x] = (int(line[x]) + _paeth(a, int(prev[x]), c)) & 0xFF
        out[y] = line
        prev = line
    return out.reshape(h, w, channels)


def _decode_image(doc, buffers, base_dir, img_idx) -> Optional[np.ndarray]:
    """Decode a PNG image to float rgba (JPEG unsupported, as the reference)."""
    img = doc["images"][img_idx]
    data = None
    if "uri" in img:
        uri = img["uri"]
        if uri.startswith("data:"):
            data = base64.b64decode(uri.split(",", 1)[1])
        else:
            p = os.path.join(base_dir, uri)
            if os.path.exists(p):
                with open(p, "rb") as f:
                    data = f.read()
    elif "bufferView" in img:
        view = doc["bufferViews"][img["bufferView"]]
        buf = buffers[view["buffer"]]
        off = view.get("byteOffset", 0)
        data = buf[off : off + view["byteLength"]]
    if data is None or data[:8] != b"\x89PNG\r\n\x1a\n":
        return None
    f = decode_png(data).astype(np.float32) / 255.0
    if f.shape[-1] == 3:
        f = np.concatenate([f, np.ones_like(f[..., :1])], axis=-1)
    elif f.shape[-1] == 1:
        f = np.concatenate([f] * 3 + [np.ones_like(f[..., :1])], axis=-1)
    return f


def _read_doc(path: str):
    """(glTF JSON document, GLB binary chunk or None)."""
    glb_bin = None
    with open(path, "rb") as f:
        head = f.read(4)
        f.seek(0)
        if head != b"glTF":
            return json.load(f), None
        _, _, length = struct.unpack("<III", f.read(12))
        doc = None
        while f.tell() < length:
            clen, ctype = struct.unpack("<II", f.read(8))
            body = f.read(clen)
            if ctype == 0x4E4F534A:  # JSON
                doc = json.loads(body)
            elif ctype == 0x004E4942:  # BIN
                glb_bin = body
    return doc, glb_bin


def load_gltf_scene(path: str) -> Tuple[Entities, TexturePool]:
    """Load a .gltf/.glb file into (Entities, TexturePool)."""
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    base_dir = os.path.dirname(path)
    doc, glb_bin = _read_doc(path)
    buffers = _load_buffers(doc, base_dir, glb_bin)
    ents = Entities()
    pool = TexturePool()

    # textures are imported once per (source image, kind)
    tex_cache: Dict[Tuple[int, str], int] = {}

    def import_texture(tex_idx: Optional[int], kind: str) -> int:
        """kind: 'albedo' (sRGB decode) | 'linear' | 'normal'."""
        if tex_idx is None:
            return -1
        src = doc["textures"][tex_idx].get("source")
        if src is None:
            return -1
        key = (src, kind)
        if key in tex_cache:
            return tex_cache[key]
        img = _decode_image(doc, buffers, base_dir, src)
        if img is None:
            tex_cache[key] = -1
            return -1
        if kind == "albedo":
            img = np.concatenate([srgb_to_linear(img[..., :3]), img[..., 3:4]], axis=-1)
        elif kind == "normal":
            img = np.concatenate([img[..., :2] * 2.0 - 1.0, img[..., 2:]], axis=-1)
        tid = pool.add(img)
        tex_cache[key] = tid
        return tid

    def build_rome(mat: dict) -> Tuple[int, float]:
        """The ROME texture from pbrMetallicRoughness (+ emissive).
        Returns (tex_id, emissive_max)."""
        pbr = mat.get("pbrMetallicRoughness", {})
        rough = float(pbr.get("roughnessFactor", 1.0))
        metal = float(pbr.get("metallicFactor", 1.0))
        emissive = np.asarray(mat.get("emissiveFactor", [0, 0, 0]), np.float32)
        e = float(np.sqrt(np.clip(emissive.max() / 100.0, 0.0, 1.0)))  # PackEmission
        mr_idx = pbr.get("metallicRoughnessTexture", {}).get("index")
        occ_idx = mat.get("occlusionTexture", {}).get("index")
        if mr_idx is None and occ_idx is None:
            return pool.add_flat([rough, 1.0, metal, e]), float(emissive.max())
        mr_img = None
        if mr_idx is not None:
            src = doc["textures"][mr_idx].get("source")
            mr_img = _decode_image(doc, buffers, base_dir, src) if src is not None else None
        if mr_img is None:
            return pool.add_flat([rough, 1.0, metal, e]), float(emissive.max())
        # glTF: G = roughness, B = metallic
        h, w = mr_img.shape[:2]
        rome = np.zeros((h, w, 4), np.float32)
        rome[..., 0] = mr_img[..., 1] * rough
        rome[..., 1] = 1.0
        rome[..., 2] = mr_img[..., 2] * metal
        rome[..., 3] = e
        return pool.add(rome), float(emissive.max())

    mat_records: List[Material] = []
    for mat in doc.get("materials", []):
        pbr = mat.get("pbrMetallicRoughness", {})
        base = np.asarray(pbr.get("baseColorFactor", [1, 1, 1, 1]), np.float32)
        base_idx = pbr.get("baseColorTexture", {}).get("index")
        if base_idx is not None:
            albedo_tex = import_texture(base_idx, "albedo")
        else:
            albedo_tex = pool.add_flat(base)  # baseColorFactor is linear
        rome_tex, emissive_max = build_rome(mat)
        normal_tex = import_texture(mat.get("normalTexture", {}).get("index"), "normal")
        flags = MatFlag.NONE
        if emissive_max > 0:
            flags |= MatFlag.EMISSIVE
        name = mat.get("name", "").lower()
        if "sky" in name:
            flags |= MatFlag.SKY
        if "water" in name:
            flags |= MatFlag.WATER
        if "lava" in name:
            flags |= MatFlag.LAVA
        if "glass" in name or mat.get("alphaMode") == "BLEND":
            flags |= MatFlag.REFRACTIVE
        mat_records.append(Material(
            albedo_tex=albedo_tex, rome_tex=rome_tex, normal_tex=normal_tex,
            flags=flags, ior=1.5 if flags & MatFlag.REFRACTIVE else 1.0,
        ))
    if not mat_records:
        mat_records.append(Material(albedo_tex=pool.add_flat([1, 1, 1, 1]),
                                    rome_tex=pool.add_flat([0.5, 1, 0, 0])))

    def emit_node(node_idx: int, parent: np.ndarray, path: str):
        node = doc["nodes"][node_idx]
        world = parent @ _node_matrix(node)
        if "mesh" in node:
            mesh = doc["meshes"][node["mesh"]]
            for pi, prim in enumerate(mesh.get("primitives", [])):
                attrs = prim["attributes"]
                if "POSITION" not in attrs:
                    continue
                pos = _read_accessor(doc, buffers, attrs["POSITION"]).astype(np.float32)
                nrm = (_read_accessor(doc, buffers, attrs["NORMAL"]).astype(np.float32)
                       if "NORMAL" in attrs else None)
                uv = (_read_accessor(doc, buffers, attrs["TEXCOORD_0"]).astype(np.float32)
                      if "TEXCOORD_0" in attrs else np.zeros((pos.shape[0], 2), np.float32))
                if "indices" in prim:
                    idx = _read_accessor(doc, buffers, prim["indices"]).ravel().astype(np.int64)
                else:
                    idx = np.arange(pos.shape[0], dtype=np.int64)
                # de-index to a flat soup
                p = pos[idx]
                u = uv[idx]
                if nrm is not None:
                    n = nrm[idx]
                else:
                    tri = p.reshape(-1, 3, 3)
                    fn = np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
                    fn /= np.maximum(np.linalg.norm(fn, axis=-1, keepdims=True), 1e-12)
                    n = np.repeat(fn, 3, axis=0)
                ent = ents.add(f"{path}/{node.get('name', node_idx)}#{pi}")
                ents.meshes[ent] = MeshData(p, n, u[:, :2])
                mat_idx = prim.get("material", 0)
                ents.materials[ent] = mat_records[min(mat_idx, len(mat_records) - 1)]
                # world transform as TRS: scale = column norms, rotation the
                # Gram-Schmidt orthonormalized rest
                m3 = world[:3, :3]
                s = np.linalg.norm(m3, axis=0)
                s[s == 0] = 1.0
                r = m3 / s
                q0 = r[:, 0] / np.linalg.norm(r[:, 0])
                q1 = r[:, 1] - q0 * np.dot(q0, r[:, 1])
                q1 /= np.linalg.norm(q1)
                q2 = np.cross(q0, q1)
                ents.rotations[ent] = mat3_to_quat(q0, q1, q2)
                ents.translations[ent] = world[:3, 3].astype(np.float32)
                ents.scales[ent] = s.astype(np.float32)
        for child in node.get("children", []):
            emit_node(child, world, f"{path}/{node.get('name', node_idx)}")

    scene = doc.get("scenes", [{}])[doc.get("scene", 0)]
    for root in scene.get("nodes", []):
        emit_node(root, np.eye(4), os.path.basename(path))
    return ents, pool
