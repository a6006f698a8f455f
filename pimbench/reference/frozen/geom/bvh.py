"""Host-side BVH build: binned SAH over the flat triangle soup.

Counterpart of `pim_tpu.geom.bvh`.  The build runs once per scene on the
host (numpy, or the C++ builder of csrc/bvh_builder.cpp through
`native.build_bvh_native`); its output is the flat array layout that the
`bvh` backend walks (render/intersect.py and csrc/mt_isect.cu):

  node_lo/hi [Nn, 3]  AABBs
  node_a     [Nn]     internal: left-child index;   leaf: first tri slot
  node_b     [Nn]     internal: right-child index;  leaf: ~(count)
  tri_order  [T]      triangle permutation (leaf slots are contiguous)

A node is a leaf iff node_b < 0 (count = ~node_b).  Children are emitted
depth-first so the left child is always parent+1.  The two builders give
trees of the same quality but not the same arrays (their partitions order
triangles differently), so a scene's ties depend on which one built it.
`build_bvh` takes the C++ builder and raises where it cannot be built.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

# entries of the traversal's per-ray stack (render/intersect.py STACK_DEPTH);
# a tree of depth d (nodes on its longest root-to-leaf path) needs d of them
STACK_DEPTH = 48
_NUM_BINS = 16


class BvhArrays(NamedTuple):
    node_lo: np.ndarray   # [Nn, 3] f32
    node_hi: np.ndarray   # [Nn, 3] f32
    node_a: np.ndarray    # [Nn] i32
    node_b: np.ndarray    # [Nn] i32
    tri_order: np.ndarray  # [T] i32


def build_bvh(positions: np.ndarray, max_leaf: int = 4,
              prefer_native: bool = True) -> BvhArrays:
    """The scene's BVH: the C++ builder (csrc/bvh_builder.cpp, compiled with
    g++ on first use; a failed compile raises) or, with
    `prefer_native=False`, the numpy builder.  Raises if the tree is deeper
    than the traversal's stack holds."""
    del prefer_native  # the frozen copy builds with numpy alone
    bvh = build_bvh_numpy(positions, max_leaf)
    depth = bvh_depth(bvh)
    if depth > STACK_DEPTH:
        raise ValueError(f"BVH depth {depth}: the traversal's stack holds {STACK_DEPTH} entries")
    return bvh


def build_bvh_numpy(positions: np.ndarray, max_leaf: int = 4) -> BvhArrays:
    """positions: [V, 3] float32, V = 3*T (flat soup)."""
    v = np.asarray(positions, np.float32)
    tri_count = v.shape[0] // 3
    if tri_count == 0:
        return BvhArrays(
            np.zeros((1, 3), np.float32), np.zeros((1, 3), np.float32),
            np.zeros(1, np.int32), np.full(1, ~0, np.int32), np.zeros(0, np.int32),
        )
    tris = v[: tri_count * 3].reshape(tri_count, 3, 3)
    tri_lo = tris.min(axis=1)
    tri_hi = tris.max(axis=1)
    centroids = (tri_lo + tri_hi) * 0.5

    order = np.arange(tri_count, dtype=np.int32)

    node_lo, node_hi, node_a, node_b = [], [], [], []

    def new_node():
        node_lo.append(None)
        node_hi.append(None)
        node_a.append(0)
        node_b.append(0)
        return len(node_a) - 1

    def sah_split(idx: np.ndarray):
        """Returns (axis, mask_left) or None for 'make a leaf'."""
        c = centroids[idx]
        lo = c.min(axis=0)
        hi = c.max(axis=0)
        ext = hi - lo
        axis = int(np.argmax(ext))
        if ext[axis] < 1e-12:
            return None
        # bin by centroid
        scale = _NUM_BINS * (1.0 - 1e-6) / ext[axis]
        bins = np.minimum(((c[:, axis] - lo[axis]) * scale).astype(np.int32), _NUM_BINS - 1)
        # per-bin counts and bounds
        counts = np.zeros(_NUM_BINS, np.int64)
        blo = np.full((_NUM_BINS, 3), np.inf, np.float32)
        bhi = np.full((_NUM_BINS, 3), -np.inf, np.float32)
        np.add.at(counts, bins, 1)
        for a in range(3):
            np.minimum.at(blo[:, a], bins, tri_lo[idx, a])
            np.maximum.at(bhi[:, a], bins, tri_hi[idx, a])

        def area(lo_, hi_):
            d = np.maximum(hi_ - lo_, 0.0)
            return d[..., 0] * d[..., 1] + d[..., 1] * d[..., 2] + d[..., 2] * d[..., 0]

        # prefix/suffix sweep
        lcount = np.cumsum(counts)[:-1]
        rcount = counts.sum() - lcount
        llo = np.minimum.accumulate(blo, axis=0)[:-1]
        lhi = np.maximum.accumulate(bhi, axis=0)[:-1]
        rlo = np.minimum.accumulate(blo[::-1], axis=0)[::-1][1:]
        rhi = np.maximum.accumulate(bhi[::-1], axis=0)[::-1][1:]
        cost = area(llo, lhi) * lcount + area(rlo, rhi) * rcount
        valid = (lcount > 0) & (rcount > 0)
        if not valid.any():
            return None
        cost = np.where(valid, cost, np.inf)
        best = int(np.argmin(cost))
        leaf_cost = area(tri_lo[idx].min(0), tri_hi[idx].max(0)) * len(idx)
        if len(idx) <= max_leaf and cost[best] >= leaf_cost:
            return None
        return bins <= best

    tri_slots = []  # reordered triangle ids
    # iterative DFS: (node_index, tri index array)
    root = new_node()
    stack = [(root, order)]
    while stack:
        ni, idx = stack.pop()
        node_lo[ni] = tri_lo[idx].min(axis=0)
        node_hi[ni] = tri_hi[idx].max(axis=0)
        split = None
        if len(idx) > max_leaf:
            split = sah_split(idx)
            if split is None and len(idx) > max_leaf:
                # fallback: median split on the longest axis
                c = centroids[idx]
                axis = int(np.argmax(c.max(0) - c.min(0)))
                med = np.argsort(c[:, axis], kind="stable")
                half = len(idx) // 2
                mask = np.zeros(len(idx), bool)
                mask[med[:half]] = True
                split = mask
        if split is None:
            node_a[ni] = len(tri_slots)
            node_b[ni] = ~len(idx)
            tri_slots.extend(idx.tolist())
        else:
            left_idx = idx[split]
            right_idx = idx[~split]
            li = new_node()
            ri = new_node()
            node_a[ni] = li
            node_b[ni] = ri
            # DFS: process left first so left == parent+1 in emission order
            stack.append((ri, right_idx))
            stack.append((li, left_idx))

    return BvhArrays(
        node_lo=np.asarray(node_lo, np.float32),
        node_hi=np.asarray(node_hi, np.float32),
        node_a=np.asarray(node_a, np.int32),
        node_b=np.asarray(node_b, np.int32),
        tri_order=np.asarray(tri_slots, np.int32),
    )


def bvh_depth(bvh: BvhArrays) -> int:
    """Nodes on the tree's longest root-to-leaf path (1 for a lone leaf):
    the stack entries its traversal needs."""
    node_a = np.asarray(bvh.node_a)
    node_b = np.asarray(bvh.node_b)
    depth = 0
    stack = [(0, 1)]
    while stack:
        ni, d = stack.pop()
        depth = max(depth, d)
        if node_b[ni] >= 0:
            stack.append((int(node_a[ni]), d + 1))
            stack.append((int(node_b[ni]), d + 1))
    return depth


