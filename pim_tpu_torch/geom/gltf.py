"""glTF 2.0 scene import into the port's texture pool.

Counterpart of `pim_tpu.geom.gltf.load_gltf_scene`, with the port's own
copies of its buffer, accessor and node-matrix helpers and of the stdlib PNG
reader (the reference decodes through `pim_tpu.render.screenshot.read_png`;
8-bit, no interlace).  The atlas and the texture records come out bitwise
the reference's.  The exporter `save_gltf_scene` (behind `mapgen`) is a copy
of the reference's.
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


# ---------------------------------------------------------------------------
# Exporter
# ---------------------------------------------------------------------------
#
# Inverse of the importer above, used to materialize procedural maps as real
# on-disk glTF assets under data/<name>/glTF/<name>.gltf — the reference's
# map directory convention (render_system.c:1456-1458) — so `mapload` runs
# the full parse -> de-index -> texture-import pipeline on genuine files.

def _encode_png_bytes(rgba8: np.ndarray) -> bytes:
    import io
    import tempfile

    from pim_tpu_torch.render.screenshot import write_png

    with tempfile.NamedTemporaryFile(suffix=".png", delete=False) as tf:
        tmp = tf.name
    try:
        write_png(tmp, rgba8, flip_vertical=False)
        with open(tmp, "rb") as f:
            return f.read()
    finally:
        os.unlink(tmp)


def save_gltf_scene(
    entities, pool, path: str, binary: bool = False
) -> None:
    """Write (Entities, TexturePool) as glTF 2.0.

    ``path`` ending in .glb (or binary=True) produces a single binary file;
    otherwise a .gltf JSON + sibling .bin + .png textures are written.

    Material encoding mirrors what load_gltf_scene reads back:
      * 1x1 albedo -> baseColorFactor (linear); images -> sRGB-encoded PNG
      * ROME -> roughness/metallicFactor or a G=rough/B=metal MR texture
      * flat emission e -> emissiveFactor e^2*100 (PackEmission inverse)
      * flags -> material-name tokens (glass/water/lava/sky)
    """
    from pim_tpu_torch.geom.material import MatFlag, linear_to_srgb

    binary = binary or path.endswith(".glb")
    base_dir = os.path.dirname(path) or "."
    os.makedirs(base_dir, exist_ok=True)
    stem = os.path.splitext(os.path.basename(path))[0]

    blob = bytearray()
    buffer_views: List[dict] = []
    accessors: List[dict] = []
    images: List[dict] = []
    textures: List[dict] = []
    samplers = [{"wrapS": 10497, "wrapT": 10497}]  # REPEAT

    def push_view(data: bytes, target: Optional[int] = None) -> int:
        while len(blob) % 4:
            blob.append(0)
        view = {"buffer": 0, "byteOffset": len(blob), "byteLength": len(data)}
        if target is not None:
            view["target"] = target
        blob.extend(data)
        buffer_views.append(view)
        return len(buffer_views) - 1

    def push_accessor(arr: np.ndarray, gltf_type: str, with_minmax: bool) -> int:
        a = np.ascontiguousarray(arr, np.float32)
        view = push_view(a.tobytes(), target=34962)
        acc = {
            "bufferView": view,
            "componentType": 5126,
            "count": int(a.shape[0]),
            "type": gltf_type,
        }
        if with_minmax:
            acc["min"] = [float(v) for v in a.min(axis=0)]
            acc["max"] = [float(v) for v in a.max(axis=0)]
        accessors.append(acc)
        return len(accessors) - 1

    def push_image(rgba8: np.ndarray, name: str) -> int:
        data = _encode_png_bytes(rgba8)
        if binary:
            view = push_view(data)
            images.append({"bufferView": view, "mimeType": "image/png", "name": name})
        else:
            fname = f"{stem}_{name}.png"
            with open(os.path.join(base_dir, fname), "wb") as f:
                f.write(data)
            images.append({"uri": fname, "name": name})
        textures.append({"sampler": 0, "source": len(images) - 1})
        return len(textures) - 1

    # --- materials (deduped by content) ------------------------------------
    mat_json: List[dict] = []
    mat_index: Dict[tuple, int] = {}
    tex_exported: Dict[Tuple[int, str], int] = {}

    def export_albedo(tex_id: int) -> int:
        key = (tex_id, "albedo")
        if key not in tex_exported:
            img = pool.get(tex_id)
            rgb8 = np.clip(
                linear_to_srgb(img[..., :3]) * 255.0 + 0.5, 0, 255
            ).astype(np.uint8)
            a8 = np.clip(img[..., 3:4] * 255.0 + 0.5, 0, 255).astype(np.uint8)
            tex_exported[key] = push_image(
                np.concatenate([rgb8, a8], axis=-1), f"albedo{tex_id}"
            )
        return tex_exported[key]

    def export_mr(tex_id: int) -> int:
        key = (tex_id, "mr")
        if key not in tex_exported:
            rome = pool.get(tex_id)  # (rough, occ, metal, emission)
            h, w = rome.shape[:2]
            mr = np.zeros((h, w, 3), np.float32)
            mr[..., 1] = rome[..., 0]  # G = roughness
            mr[..., 2] = rome[..., 2]  # B = metallic
            mr8 = np.clip(mr * 255.0 + 0.5, 0, 255).astype(np.uint8)
            tex_exported[key] = push_image(mr8, f"mr{tex_id}")
        return tex_exported[key]

    def export_normal(tex_id: int) -> int:
        key = (tex_id, "normal")
        if key not in tex_exported:
            img = pool.get(tex_id)  # xy in [-1,1], z in [0,1]
            enc = np.concatenate(
                [img[..., :2] * 0.5 + 0.5, img[..., 2:3]], axis=-1
            )
            n8 = np.clip(enc * 255.0 + 0.5, 0, 255).astype(np.uint8)
            tex_exported[key] = push_image(n8, f"normal{tex_id}")
        return tex_exported[key]

    def material_id(mat) -> int:
        key = (mat.albedo_tex, mat.rome_tex, mat.normal_tex, int(mat.flags), mat.ior)
        if key in mat_index:
            return mat_index[key]
        flags = MatFlag(mat.flags)
        tokens = []
        if flags & MatFlag.REFRACTIVE:
            tokens.append("glass")
        if flags & MatFlag.WATER:
            tokens.append("water")
        if flags & MatFlag.LAVA:
            tokens.append("lava")
        if flags & MatFlag.SKY:
            tokens.append("sky")
        entry: dict = {
            "name": "_".join(["mat", str(len(mat_json))] + tokens),
            "doubleSided": True,
        }
        pbr: dict = {}
        if mat.albedo_tex >= 0:
            img = pool.get(mat.albedo_tex)
            if img.shape[0] == 1 and img.shape[1] == 1:
                pbr["baseColorFactor"] = [float(v) for v in img[0, 0]]
            else:
                pbr["baseColorTexture"] = {"index": export_albedo(mat.albedo_tex)}
        emission = 0.0
        if mat.rome_tex >= 0:
            rome = pool.get(mat.rome_tex)
            if rome.shape[0] == 1 and rome.shape[1] == 1:
                r, _occ, m, e = [float(v) for v in rome[0, 0]]
                pbr["roughnessFactor"] = r
                pbr["metallicFactor"] = m
                emission = e
            else:
                pbr["metallicRoughnessTexture"] = {"index": export_mr(mat.rome_tex)}
                pbr["roughnessFactor"] = 1.0
                pbr["metallicFactor"] = 1.0
                emission = float(rome[..., 3].max())
        if emission > 0.0:
            # inverse of import PackEmission: e = sqrt(max/100)
            entry["emissiveFactor"] = [emission * emission * 100.0] * 3
        if mat.normal_tex >= 0:
            entry["normalTexture"] = {"index": export_normal(mat.normal_tex)}
        entry["pbrMetallicRoughness"] = pbr
        mat_json.append(entry)
        mat_index[key] = len(mat_json) - 1
        return mat_index[key]

    # --- meshes (deduped by MeshData identity) ------------------------------
    mesh_json: List[dict] = []
    mesh_cache: Dict[int, Dict[int, int]] = {}  # id(MeshData) -> {mat: mesh idx}

    def mesh_id(mesh, mat_idx: int) -> int:
        per_mat = mesh_cache.setdefault(id(mesh), {})
        if mat_idx in per_mat:
            return per_mat[mat_idx]
        if id(mesh) in mesh_cache and mesh_cache[id(mesh)]:
            # attributes already uploaded for another material: reuse accessors
            first = mesh_json[next(iter(mesh_cache[id(mesh)].values()))]
            attrs = dict(first["primitives"][0]["attributes"])
        else:
            attrs = {
                "POSITION": push_accessor(mesh.positions, "VEC3", True),
                "NORMAL": push_accessor(mesh.normals, "VEC3", False),
                "TEXCOORD_0": push_accessor(mesh.uvs, "VEC2", False),
            }
        mesh_json.append(
            {"primitives": [{"attributes": attrs, "material": mat_idx, "mode": 4}]}
        )
        per_mat[mat_idx] = len(mesh_json) - 1
        return per_mat[mat_idx]

    # --- nodes --------------------------------------------------------------
    nodes: List[dict] = []
    for i in range(entities.count):
        mesh = entities.meshes[i]
        if mesh is None or mesh.length == 0:
            continue
        mat_idx = material_id(entities.materials[i])
        node = {
            "name": entities.names[i],
            "mesh": mesh_id(mesh, mat_idx),
            "translation": [float(v) for v in entities.translations[i]],
            "rotation": [float(v) for v in entities.rotations[i]],  # xyzw
            "scale": [float(v) for v in entities.scales[i]],
        }
        nodes.append(node)

    doc = {
        "asset": {"version": "2.0", "generator": "pim_tpu"},
        "scene": 0,
        "scenes": [{"nodes": list(range(len(nodes)))}],
        "nodes": nodes,
        "meshes": mesh_json,
        "materials": mat_json,
        "accessors": accessors,
        "bufferViews": buffer_views,
        "samplers": samplers,
    }
    if images:
        doc["images"] = images
        doc["textures"] = textures

    if binary:
        doc["buffers"] = [{"byteLength": len(blob)}]
        js = json.dumps(doc, separators=(",", ":")).encode()
        js += b" " * (-len(js) % 4)
        bin_chunk = bytes(blob) + b"\x00" * (-len(blob) % 4)
        total = 12 + 8 + len(js) + 8 + len(bin_chunk)
        with open(path, "wb") as f:
            f.write(struct.pack("<III", 0x46546C67, 2, total))
            f.write(struct.pack("<II", len(js), 0x4E4F534A) + js)
            f.write(struct.pack("<II", len(bin_chunk), 0x004E4942) + bin_chunk)
    else:
        bin_name = f"{stem}.bin"
        with open(os.path.join(base_dir, bin_name), "wb") as f:
            f.write(bytes(blob))
        doc["buffers"] = [{"uri": bin_name, "byteLength": len(blob)}]
        with open(path, "w") as f:
            json.dump(doc, f, separators=(",", ":"))
