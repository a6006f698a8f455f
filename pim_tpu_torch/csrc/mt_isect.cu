// Moller-Trumbore ray/triangle kernels for Hopper (sm_90a): the `brute` and
// `bvh` backends, each a closest hit and an any hit.
//
// Replaces: pim_tpu/render/intersect.py, which the JAX package runs in XLA,
// not Pallas: intersect_brute / occluded_brute (a lax.scan over chunks of
// 512 triangles, :75-168) and intersect_bvh / occluded_bvh (the lockstep
// while_loop `_traverse`, :189-326).  As torch ops the scan is ~10 launches
// a chunk and the while_loop a host sync a trip; here a call is one launch.
//
// What bounds it on this card: issue slots.  Unfused (--fmad=false), a
// triangle test is 53 operations (plus 6 for a triangle's edges, needed
// once a triangle) and a node's slab test 25 (tools/mt_check.py), so the
// bound is operations; a brute-force call tests every live ray against
// every triangle, a walk what the plain walk counts.  The walk's dependent
// loads (node, children, leaf slots) and its divergence between the rays
// of a warp keep it far from that bound.
//
// What the design does about it: nothing yet; it is the simple design, one
// thread a ray, written for exactness (packets, wide nodes and staged
// triangles are later work, PERF.md):
// - brute_isect walks every triangle in index order with a strict `<`
//   against the running best t, which keeps the lowest index among equal
//   t, as the scan's in-chunk argmin plus its strict cross-chunk `<` do;
//   brute_anyhit stops at the first valid triangle (occluded_brute is
//   `intersect_brute(...).t >= 0`, true iff some triangle passes).
// - bvh_isect / bvh_anyhit walk a per-thread stack of kStack entries in
//   exactly `_traverse`'s order, which decides ties: a popped node's own
//   box is tested against the running best t first; an internal node that
//   passes computes both children's slab entries (even for a child whose
//   box misses) and pushes the far child, then the near one, near meaning
//   entry_a <= entry_b; a leaf tests its first min(count, max_leaf) slots
//   in slot order.  The any-hit walk ends at the first leaf that holds a
//   hit (the reference empties the stack there).  A tree deeper than the
//   stack is refused when it is built (geom/bvh.py), so no push is dropped.
// A ray whose t_far is not above t_near (a dead lane; the in-media NEE's
// rays that did not scatter) can hit nothing: it returns a miss at once,
// without reading a node or a triangle.
//
// Exactness: the file is compiled with --fmad=false and without fast math,
// so every product, sum and the division round as separate float32
// operations, in the plain version's order (render/intersect.py:
// `moller_trumbore`, each dot product (x0*y0 + x1*y1) + x2*y2, each cross
// product component a*b - c*d).  min and max propagate NaN as torch's
// minimum and maximum do.  Outputs (closest hit): t (t_far on a miss), tri
// (-1), u, v and det of the hit (0 on a miss), the walk's state that
// `_finalize_hit` completes; any hit: 1 = blocked.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 128;
constexpr int kStack = 48;  // geom/bvh.py STACK_DEPTH

struct RayArgs {
  const float* rox;
  const float* roy;
  const float* roz;
  const float* rdx;
  const float* rdy;
  const float* rdz;
  float tnear;
  const float* tfar;  // null: tfar_all for every ray
  float tfar_all;
};

struct Ray {
  float ox, oy, oz, dx, dy, dz;
};

__device__ __forceinline__ float nmin(float a, float b) { return (a < b || a != a) ? a : b; }
__device__ __forceinline__ float nmax(float a, float b) { return (a > b || a != a) ? a : b; }

__device__ __forceinline__ Ray load_ray(const RayArgs& ra, int i) {
  return Ray{ra.rox[i], ra.roy[i], ra.roz[i], ra.rdx[i], ra.rdy[i], ra.rdz[i]};
}

// Two-sided Moller-Trumbore of one ray against triangle k of the soup;
// returns whether the hit is valid with t in (tnear, lim).
__device__ __forceinline__ bool mt_test(const float* __restrict__ pos, int k, const Ray& r,
                                        float tnear, float lim, float& t, float& u, float& v,
                                        float& det) {
  const float* p = pos + 9 * static_cast<int64_t>(k);
  const float ax = __ldg(p + 0), ay = __ldg(p + 1), az = __ldg(p + 2);
  const float e1x = __ldg(p + 3) - ax, e1y = __ldg(p + 4) - ay, e1z = __ldg(p + 5) - az;
  const float e2x = __ldg(p + 6) - ax, e2y = __ldg(p + 7) - ay, e2z = __ldg(p + 8) - az;
  const float px = r.dy * e2z - r.dz * e2y;
  const float py = r.dz * e2x - r.dx * e2z;
  const float pz = r.dx * e2y - r.dy * e2x;
  det = (e1x * px + e1y * py) + e1z * pz;
  const bool ok = fabsf(det) > 1e-12f;
  const float inv = ok ? 1.0f / det : 0.0f;
  const float tx = r.ox - ax, ty = r.oy - ay, tz = r.oz - az;
  u = ((tx * px + ty * py) + tz * pz) * inv;
  const float qx = ty * e1z - tz * e1y;
  const float qy = tz * e1x - tx * e1z;
  const float qz = tx * e1y - ty * e1x;
  v = ((r.dx * qx + r.dy * qy) + r.dz * qz) * inv;
  t = ((e2x * qx + e2y * qy) + e2z * qz) * inv;
  return ok && u >= 0.0f && v >= 0.0f && u + v <= 1.0f && t > tnear && t < lim;
}

// Slab test of node `node`: its entry, max(largest near plane, tnear), and
// exit, min(smallest far plane, bound).
__device__ __forceinline__ void slab(const float* __restrict__ lo, const float* __restrict__ hi,
                                     int node, const Ray& r, float ix, float iy, float iz,
                                     float tnear, float bound, float& entry, float& exit_) {
  const float* l = lo + 3 * static_cast<int64_t>(node);
  const float* h = hi + 3 * static_cast<int64_t>(node);
  const float t0x = (__ldg(l + 0) - r.ox) * ix, t1x = (__ldg(h + 0) - r.ox) * ix;
  const float t0y = (__ldg(l + 1) - r.oy) * iy, t1y = (__ldg(h + 1) - r.oy) * iy;
  const float t0z = (__ldg(l + 2) - r.oz) * iz, t1z = (__ldg(h + 2) - r.oz) * iz;
  entry = nmax(nmax(nmax(nmin(t0x, t1x), nmin(t0y, t1y)), nmin(t0z, t1z)), tnear);
  exit_ = nmin(nmin(nmin(nmax(t0x, t1x), nmax(t0y, t1y)), nmax(t0z, t1z)), bound);
}

__device__ __forceinline__ float safe_inv(float d) { return fabsf(d) > 1e-12f ? 1.0f / d : 1e12f; }

template <bool kAny>
__global__ void __launch_bounds__(kThreads)
    brute_kernel(const float* __restrict__ pos, int ntri, RayArgs ra, int n,
                 float* __restrict__ t_out, int* __restrict__ tri_out, float* __restrict__ u_out,
                 float* __restrict__ v_out, float* __restrict__ det_out,
                 int* __restrict__ hit_out) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const float tfar = ra.tfar != nullptr ? ra.tfar[i] : ra.tfar_all;
  float best = tfar, bu = 0.0f, bv = 0.0f, bd = 0.0f;
  int bt = -1;
  if (tfar > ra.tnear) {
    const Ray r = load_ray(ra, i);
    for (int k = 0; k < ntri; ++k) {
      float t, u, v, det;
      if (mt_test(pos, k, r, ra.tnear, best, t, u, v, det)) {
        bt = k;
        if (kAny) break;
        best = t;
        bu = u;
        bv = v;
        bd = det;
      }
    }
  }
  if (kAny) {
    hit_out[i] = bt >= 0 ? 1 : 0;
  } else {
    t_out[i] = best;
    tri_out[i] = bt;
    u_out[i] = bu;
    v_out[i] = bv;
    det_out[i] = bd;
  }
}

template <bool kAny>
__global__ void __launch_bounds__(kThreads)
    bvh_kernel(const float* __restrict__ node_lo, const float* __restrict__ node_hi,
               const int* __restrict__ node_a, const int* __restrict__ node_b,
               const int* __restrict__ tri_order, int max_leaf, const float* __restrict__ pos,
               RayArgs ra, int n, float* __restrict__ t_out, int* __restrict__ tri_out,
               float* __restrict__ u_out, float* __restrict__ v_out,
               float* __restrict__ det_out, int* __restrict__ hit_out) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const float tfar = ra.tfar != nullptr ? ra.tfar[i] : ra.tfar_all;
  float best = tfar, bu = 0.0f, bv = 0.0f, bd = 0.0f;
  int bt = -1;
  if (tfar > ra.tnear) {
    const Ray r = load_ray(ra, i);
    const float ix = safe_inv(r.dx), iy = safe_inv(r.dy), iz = safe_inv(r.dz);
    int stack[kStack];
    int sp = 1;
    stack[0] = 0;  // the root
    while (sp > 0) {
      const int node = stack[--sp];
      float entry, exit_;
      slab(node_lo, node_hi, node, r, ix, iy, iz, ra.tnear, best, entry, exit_);
      if (!(entry <= exit_)) continue;
      const int na = __ldg(node_a + node), nb = __ldg(node_b + node);
      if (nb >= 0) {
        float ea, eb, unused;
        slab(node_lo, node_hi, na, r, ix, iy, iz, ra.tnear, best, ea, unused);
        slab(node_lo, node_hi, nb, r, ix, iy, iz, ra.tnear, best, eb, unused);
        const bool a_first = ea <= eb;
        stack[sp++] = a_first ? nb : na;  // far child first: popped last
        stack[sp++] = a_first ? na : nb;
        continue;
      }
      const int count = min(~nb, max_leaf);
      for (int k = 0; k < count; ++k) {
        const int tri = __ldg(tri_order + na + k);
        float t, u, v, det;
        if (mt_test(pos, tri, r, ra.tnear, best, t, u, v, det)) {
          bt = tri;
          best = t;
          bu = u;
          bv = v;
          bd = det;
        }
      }
      if (kAny && bt >= 0) break;
    }
  }
  if (kAny) {
    hit_out[i] = bt >= 0 ? 1 : 0;
  } else {
    t_out[i] = best;
    tri_out[i] = bt;
    u_out[i] = bu;
    v_out[i] = bv;
    det_out[i] = bd;
  }
}

int blocks_for(int n) { return (n + kThreads - 1) / kThreads; }

}  // namespace

extern "C" {

int pim_brute_isect(const float* pos, int ntri, const float* rox, const float* roy,
                    const float* roz, const float* rdx, const float* rdy, const float* rdz,
                    float tnear, const float* tfar, float tfar_all, int n, float* t_out,
                    int* tri_out, float* u_out, float* v_out, float* det_out, void* stream) {
  const RayArgs ra{rox, roy, roz, rdx, rdy, rdz, tnear, tfar, tfar_all};
  brute_kernel<false><<<blocks_for(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      pos, ntri, ra, n, t_out, tri_out, u_out, v_out, det_out, nullptr);
  return static_cast<int>(cudaGetLastError());
}

int pim_brute_anyhit(const float* pos, int ntri, const float* rox, const float* roy,
                     const float* roz, const float* rdx, const float* rdy, const float* rdz,
                     float tnear, const float* tfar, float tfar_all, int n, int* hit_out,
                     void* stream) {
  const RayArgs ra{rox, roy, roz, rdx, rdy, rdz, tnear, tfar, tfar_all};
  brute_kernel<true><<<blocks_for(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      pos, ntri, ra, n, nullptr, nullptr, nullptr, nullptr, nullptr, hit_out);
  return static_cast<int>(cudaGetLastError());
}

int pim_bvh_isect(const float* node_lo, const float* node_hi, const int* node_a,
                  const int* node_b, const int* tri_order, int max_leaf, const float* pos,
                  const float* rox, const float* roy, const float* roz, const float* rdx,
                  const float* rdy, const float* rdz, float tnear,
                  const float* tfar, float tfar_all, int n, float* t_out, int* tri_out,
                  float* u_out, float* v_out, float* det_out, void* stream) {
  const RayArgs ra{rox, roy, roz, rdx, rdy, rdz, tnear, tfar, tfar_all};
  bvh_kernel<false><<<blocks_for(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      node_lo, node_hi, node_a, node_b, tri_order, max_leaf, pos, ra, n, t_out, tri_out, u_out,
      v_out, det_out, nullptr);
  return static_cast<int>(cudaGetLastError());
}

int pim_bvh_anyhit(const float* node_lo, const float* node_hi, const int* node_a,
                   const int* node_b, const int* tri_order, int max_leaf, const float* pos,
                   const float* rox, const float* roy, const float* roz, const float* rdx,
                   const float* rdy, const float* rdz,
                   float tnear, const float* tfar, float tfar_all, int n, int* hit_out,
                   void* stream) {
  const RayArgs ra{rox, roy, roz, rdx, rdy, rdz, tnear, tfar, tfar_all};
  bvh_kernel<true><<<blocks_for(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      node_lo, node_hi, node_a, node_b, tri_order, max_leaf, pos, ra, n, nullptr, nullptr,
      nullptr, nullptr, nullptr, hit_out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
