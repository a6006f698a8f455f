"""Geometry math: signed-distance fields, ray intersections, AABBs, frusta
and areas.

Counterpart of `pim_tpu.math.geometry`: torch ops, broadcastable over
leading batch dims (points are V3 of [...] tensors).  The light-grid bake
uses `sd_triangle`; the rest completes the module.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from pim_tpu_torch.math.vec3 import V3, cross, dot, length, normalize

PI = 3.14159265358979


def _f32(x) -> torch.Tensor:
    """A float32 tensor of x (a tensor keeps its device)."""
    return torch.as_tensor(x, dtype=torch.float32)


# ---------------------------------------------------------------------------
# Signed distance fields
# ---------------------------------------------------------------------------


def sd_sphere(center: V3, radius, pt: V3):
    return length(pt - center) - radius


class Plane3D(NamedTuple):
    """n.x*x + n.y*y + n.z*z + d = 0."""

    n: V3
    d: torch.Tensor


def plane_new(direction: V3, pt: V3) -> Plane3D:
    """The plane through `pt` with normal `direction`."""
    n = normalize(direction)
    return Plane3D(n, -dot(n, pt))


def sd_plane(plane: Plane3D, pt: V3):
    return dot(plane.n, pt) + plane.d


def sd_capsule(a: V3, b: V3, radius, pt: V3):
    pa = pt - a
    ba = b - a
    h = torch.clamp(dot(pa, ba) / torch.clamp_min(dot(ba, ba), 1e-20), 0.0, 1.0)
    return length(pa - ba * h) - radius


def sd_box(center: V3, extents: V3, pt: V3):
    """Box given by its center and half-extents."""
    d = V3(
        torch.abs(pt.x - center.x) - extents.x,
        torch.abs(pt.y - center.y) - extents.y,
        torch.abs(pt.z - center.z) - extents.z,
    )
    outside = length(V3(torch.clamp_min(d.x, 0.0), torch.clamp_min(d.y, 0.0),
                        torch.clamp_min(d.z, 0.0)))
    inside = torch.clamp_max(torch.maximum(d.x, torch.maximum(d.y, d.z)), 0.0)
    return outside + inside


def sd_plane_sphere(plane: Plane3D, center: V3, radius):
    return sd_plane(plane, center) - radius


def sd_plane_box(plane: Plane3D, center: V3, extents: V3):
    """Conservative box-plane distance."""
    d = sd_plane(plane, center)
    r = (torch.abs(plane.n.x) * extents.x + torch.abs(plane.n.y) * extents.y
         + torch.abs(plane.n.z) * extents.z)
    return d - r


def sd_triangle(a: V3, b: V3, c: V3, pt: V3):
    """Unsigned distance to a 3D triangle."""
    ba = b - a
    cb = c - b
    ac = a - c
    nor = cross(ba, ac)

    pa = pt - a
    pb = pt - b
    pc = pt - c

    s = (torch.sign(dot(cross(ba, nor), pa))
         + torch.sign(dot(cross(cb, nor), pb))
         + torch.sign(dot(cross(ac, nor), pc)))

    def edge_d(e: V3, p: V3):
        h = torch.clamp(dot(e, p) / torch.clamp_min(dot(e, e), 1e-20), 0.0, 1.0)
        q = p - e * h
        return dot(q, q)

    d_edge = torch.minimum(edge_d(ba, pa), torch.minimum(edge_d(cb, pb), edge_d(ac, pc)))
    nor_pa = dot(nor, pa)
    d_face = (nor_pa * nor_pa) / torch.clamp_min(dot(nor, nor), 1e-20)
    return torch.sqrt(torch.where(s < 2.0, d_edge, d_face))


# ---------------------------------------------------------------------------
# Ray intersections
# ---------------------------------------------------------------------------


def isect_sphere(ro: V3, rd: V3, center: V3, radius):
    """(t0, t1) of ray-sphere; t0 > t1 means a miss."""
    oc = ro - center
    b = dot(oc, rd)
    c = dot(oc, oc) - radius * radius
    disc = b * b - c
    s = torch.sqrt(torch.clamp_min(disc, 0.0))
    t0 = -b - s
    t1 = -b + s
    miss = disc < 0.0
    return torch.where(miss, 1.0, t0), torch.where(miss, -1.0, t1)


def isect_plane(ro: V3, rd: V3, plane: Plane3D):
    """t of the intersection (negative: behind or parallel)."""
    denom = dot(rd, plane.n)
    return -sd_plane(plane, ro) / torch.where(torch.abs(denom) > 1e-20, denom, 1e-20)


def isect_box(ro: V3, rd: V3, lo: V3, hi: V3):
    """Slab test: (tnear, tfar); tnear > tfar means a miss."""
    inv = V3(1.0 / rd.x, 1.0 / rd.y, 1.0 / rd.z)
    t0x = (lo.x - ro.x) * inv.x
    t1x = (hi.x - ro.x) * inv.x
    t0y = (lo.y - ro.y) * inv.y
    t1y = (hi.y - ro.y) * inv.y
    t0z = (lo.z - ro.z) * inv.z
    t1z = (hi.z - ro.z) * inv.z
    tnear = torch.maximum(torch.maximum(torch.minimum(t0x, t1x), torch.minimum(t0y, t1y)),
                          torch.minimum(t0z, t1z))
    tfar = torch.minimum(torch.minimum(torch.maximum(t0x, t1x), torch.maximum(t0y, t1y)),
                         torch.maximum(t0z, t1z))
    return tnear, tfar


# ---------------------------------------------------------------------------
# AABB ops
# ---------------------------------------------------------------------------


class Box3D(NamedTuple):
    lo: V3
    hi: V3

    @property
    def center(self) -> V3:
        return (self.lo + self.hi) * 0.5

    @property
    def extents(self) -> V3:
        return (self.hi - self.lo) * 0.5


def box_empty(device="cpu") -> Box3D:
    big = _f32(3.0e38).to(device)
    return Box3D(V3(big, big, big), V3(-big, -big, -big))


def box_from_pts(pts: V3) -> Box3D:
    """Reduce over the last batch axis."""
    return Box3D(
        V3(pts.x.amin(-1), pts.y.amin(-1), pts.z.amin(-1)),
        V3(pts.x.amax(-1), pts.y.amax(-1), pts.z.amax(-1)),
    )


def box_union(a: Box3D, b: Box3D) -> Box3D:
    return Box3D(
        V3(torch.minimum(a.lo.x, b.lo.x), torch.minimum(a.lo.y, b.lo.y),
           torch.minimum(a.lo.z, b.lo.z)),
        V3(torch.maximum(a.hi.x, b.hi.x), torch.maximum(a.hi.y, b.hi.y),
           torch.maximum(a.hi.z, b.hi.z)),
    )


def box_intersect(a: Box3D, b: Box3D) -> Box3D:
    return Box3D(
        V3(torch.maximum(a.lo.x, b.lo.x), torch.maximum(a.lo.y, b.lo.y),
           torch.maximum(a.lo.z, b.lo.z)),
        V3(torch.minimum(a.hi.x, b.hi.x), torch.minimum(a.hi.y, b.hi.y),
           torch.minimum(a.hi.z, b.hi.z)),
    )


def box_contains(box: Box3D, pt: V3):
    return ((pt.x >= box.lo.x) & (pt.x <= box.hi.x)
            & (pt.y >= box.lo.y) & (pt.y <= box.hi.y)
            & (pt.z >= box.lo.z) & (pt.z <= box.hi.z))


def box_volume(box: Box3D):
    s = box.hi - box.lo
    return s.x * s.y * s.z


def box_area(box: Box3D):
    """Surface area."""
    s = box.hi - box.lo
    return 2.0 * (s.x * s.y + s.y * s.z + s.z * s.x)


# ---------------------------------------------------------------------------
# Frustum: 6-plane SDF culling
# ---------------------------------------------------------------------------


class Frustum(NamedTuple):
    """Six outward planes, x0/x1/y0/y1/z0/z1."""

    n: V3             # [6] stacked plane normals (component tensors of [6])
    d: torch.Tensor   # [6]


def frustum_new(eye: V3, right: V3, up: V3, fwd: V3, lo, hi, fov_y, aspect, z_near,
                z_far) -> Frustum:
    """Build from the camera basis and an NDC window [lo, hi] (lo and hi
    are (x, y) pairs in [-1, 1])."""
    slope_y = torch.tan(_f32(fov_y) * 0.5)
    slope_x = slope_y * aspect

    def corner(x, y, t):
        return eye + (right * (x * slope_x) + up * (y * slope_y) + fwd) * t

    lbn = corner(lo[0], lo[1], z_near)
    rbn = corner(hi[0], lo[1], z_near)
    ltn = corner(lo[0], hi[1], z_near)
    rtn = corner(hi[0], hi[1], z_near)
    lbf = corner(lo[0], lo[1], z_far)
    rbf = corner(hi[0], lo[1], z_far)
    ltf = corner(lo[0], hi[1], z_far)
    rtf = corner(hi[0], hi[1], z_far)

    corners = [lbn, rbn, ltn, rtn, lbf, rbf, ltf, rtf]
    cx = sum(c.x for c in corners) * 0.125
    cy = sum(c.y for c in corners) * 0.125
    cz = sum(c.z for c in corners) * 0.125
    centroid = V3(cx, cy, cz)

    def tri_plane(a: V3, b: V3, c: V3) -> Plane3D:
        # outward orientation: the frustum centroid must be inside (d < 0)
        n = normalize(cross(b - a, c - a))
        d = -dot(n, a)
        flip = torch.where(dot(n, centroid) + d > 0.0, -1.0, 1.0)
        return Plane3D(n * flip, d * flip)

    planes = [
        tri_plane(lbn, lbf, ltn),  # x0 (left)
        tri_plane(rbn, rtn, rbf),  # x1 (right)
        tri_plane(lbn, rbn, lbf),  # y0 (bottom)
        tri_plane(ltn, ltf, rtn),  # y1 (top)
        tri_plane(lbn, ltn, rbn),  # z0 (near)
        tri_plane(lbf, rbf, ltf),  # z1 (far)
    ]
    n = V3(
        torch.stack([p.n.x.reshape(()) for p in planes]),
        torch.stack([p.n.y.reshape(()) for p in planes]),
        torch.stack([p.n.z.reshape(()) for p in planes]),
    )
    d = torch.stack([p.d.reshape(()) for p in planes])
    return Frustum(n, d)


def sd_frustum(frus: Frustum, pt: V3):
    """Max signed distance over the 6 planes, negative inside; pt
    components broadcast against the [6] plane axis."""
    d = (frus.n.x * pt.x[..., None] + frus.n.y * pt.y[..., None]
         + frus.n.z * pt.z[..., None] + frus.d)
    return d.amax(-1)


def sd_frustum_sphere(frus: Frustum, center: V3, radius):
    return sd_frustum(frus, center) - radius


def sd_frustum_box(frus: Frustum, box: Box3D):
    """Conservative box-frustum distance."""
    c = box.center
    e = box.extents
    d = (frus.n.x * c.x[..., None] + frus.n.y * c.y[..., None]
         + frus.n.z * c.z[..., None] + frus.d)
    r = (torch.abs(frus.n.x) * e.x[..., None] + torch.abs(frus.n.y) * e.y[..., None]
         + torch.abs(frus.n.z) * e.z[..., None])
    return (d - r).amax(-1)


# ---------------------------------------------------------------------------
# Areas
# ---------------------------------------------------------------------------


def sphere_area(radius):
    return 4.0 * PI * radius * radius


def disk_area(radius):
    return PI * radius * radius


def tube_area(radius, width):
    """Cylinder side and caps."""
    return 2.0 * PI * radius * width + 2.0 * PI * radius * radius


def rect_area(width, height):
    return width * height


def tri_area_3d(a: V3, b: V3, c: V3):
    return 0.5 * length(cross(b - a, c - a))
