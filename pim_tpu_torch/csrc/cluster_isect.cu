// Two-level cluster Baldwin-Weber kernels for Hopper (sm_90a): K4 closest hit
// and K5 any hit over the build_clusters hierarchy.
//
// Replaces: pim_tpu/render/cluster.py:_isect_kernel (K4) and :_anyhit_kernel
// (K5), which the reference reaches through its intersect_cluster_raw and
// occluded_cluster; here through render/cluster.py's cluster_isect and
// cluster_anyhit.
//
// Layouts (render/cluster.py, as build_clusters emits them):
//   scb  [8, spad]      rows lox loy loz hix hiy hiz of each supercluster
//   clb  [6 * S, 128]   row a * S + s, column j: component a of cluster s*16+j
//   tris [13, stride]   BW rows 0-11 of each slot, row 12 the tri id (f32);
//                       cluster c owns slots [c * 128, c * 128 + 128)
//
// What bounds it on this card: arithmetic and divergence.  Each (ray, tri)
// test is ~20 float32 operations and one IEEE division; a ray reads 32 bytes
// and writes 8, while the hierarchy (6 MB of BW rows for e1m1's 81,552
// triangles) stays in L2 and is read by every ray that walks into it.
//
// What the design does about it: one thread per ray, and a warp walks the
// hierarchy together in slot order: a supercluster or cluster is entered
// when any lane of the warp needs it (__any_sync), and each lane accepts
// only what its own slab tests allow, so the result is the per-ray one.
// Every lane of a warp reads the same row at the same time, so each read is
// a broadcast from L1.  Superclusters are slab-tested against the ray's
// static t_far, clusters against its running best t (K4) or t_far (K5).  A
// warp with no live ray does no work; K5 leaves as soon as every lane of the
// warp is blocked.
//
// Exactness: compiled with --fmad=false and without fast math, so every
// product, sum and division rounds as the reference's separate float32
// operations, in its order (cluster.py:222-266).  _safe_inv is copied
// (|x| > 1e-12 ? 1/x : 1e12), min and max propagate NaN as jnp.minimum and
// jnp.maximum do, and the BW division is unguarded: padding slots have
// n = 0, so their t is NaN and fails every compare.  Walking the slots in
// order and accepting only t < best keeps the lowest slot among equal t, as
// the reference's final argmin does (cluster.py:327-342).  K5's dead lanes
// (t_far <= 0) report 0 (cluster.py:399-401), unlike K2's.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kCB = 128;   // slots per cluster
constexpr int kCPS = 16;   // clusters per supercluster
constexpr unsigned kFull = 0xffffffffu;

struct Ray {
  float ox, oy, oz, dx, dy, dz, ix, iy, iz, tnear, tfar;
};

__device__ __forceinline__ float safe_inv(float x) { return fabsf(x) > 1e-12f ? 1.0f / x : 1e12f; }

// jnp.minimum / jnp.maximum: NaN in either operand gives NaN.
__device__ __forceinline__ float nmin(float a, float b) { return (a < b || a != a) ? a : b; }
__device__ __forceinline__ float nmax(float a, float b) { return (a > b || a != a) ? a : b; }

__device__ __forceinline__ Ray load_ray(const float* __restrict__ rox, const float* __restrict__ roy,
                                        const float* __restrict__ roz, const float* __restrict__ rdx,
                                        const float* __restrict__ rdy, const float* __restrict__ rdz,
                                        float tnear, const float* __restrict__ tfar,
                                        float tfar_all, int r) {
  Ray ray;
  ray.ox = rox[r];
  ray.oy = roy[r];
  ray.oz = roz[r];
  ray.dx = rdx[r];
  ray.dy = rdy[r];
  ray.dz = rdz[r];
  ray.ix = safe_inv(ray.dx);
  ray.iy = safe_inv(ray.dy);
  ray.iz = safe_inv(ray.dz);
  ray.tnear = tnear;
  ray.tfar = tfar != nullptr ? tfar[r] : tfar_all;
  return ray;
}

// Slab test of the box at column `col` of six rows spaced `pitch` floats
// apart (lox loy loz hix hiy hiz) over [t_near, bound].
__device__ __forceinline__ bool slab(const float* __restrict__ box, int pitch, int col,
                                     const Ray& r, float bound) {
  float entry = r.tnear;
  float exit_ = bound;
  const float o[3] = {r.ox, r.oy, r.oz};
  const float inv[3] = {r.ix, r.iy, r.iz};
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float lo = __ldg(box + a * pitch + col);
    const float hi = __ldg(box + (a + 3) * pitch + col);
    const float t0 = (lo - o[a]) * inv[a];
    const float t1 = (hi - o[a]) * inv[a];
    entry = nmax(entry, nmin(t0, t1));
    exit_ = nmin(exit_, nmax(t0, t1));
  }
  return entry <= exit_;
}

// Baldwin-Weber test of one slot: geometric validity and t (the far test is
// the caller's).
__device__ __forceinline__ bool bw_test(const float* __restrict__ tris, int stride, int slot,
                                        const Ray& r, float& t) {
  const float* p = tris + slot;
  const float nx = __ldg(p), ny = __ldg(p + stride), nz = __ldg(p + 2 * stride);
  const float d = __ldg(p + 3 * stride);
  const float den = nx * r.dx + ny * r.dy + nz * r.dz;
  const float num = d - (nx * r.ox + ny * r.oy + nz * r.oz);
  t = num / den;
  const float px = r.ox + t * r.dx;
  const float py = r.oy + t * r.dy;
  const float pz = r.oz + t * r.dz;
  const float u = __ldg(p + 4 * stride) * px + __ldg(p + 5 * stride) * py +
                  __ldg(p + 6 * stride) * pz + __ldg(p + 7 * stride);
  const float v = __ldg(p + 8 * stride) * px + __ldg(p + 9 * stride) * py +
                  __ldg(p + 10 * stride) * pz + __ldg(p + 11 * stride);
  return (u >= 0.0f) && (v >= 0.0f) && (u + v <= 1.0f) && (t > r.tnear);
}

__global__ void __launch_bounds__(kThreads)
cluster_isect_kernel(const float* __restrict__ scb, int spad, const float* __restrict__ clb,
                     int n_sc, const float* __restrict__ tris, int stride,
                     const float* __restrict__ rox, const float* __restrict__ roy,
                     const float* __restrict__ roz, const float* __restrict__ rdx,
                     const float* __restrict__ rdy, const float* __restrict__ rdz, float tnear,
                     const float* __restrict__ tfar, float tfar_all, int n,
                     float* __restrict__ t_out, int* __restrict__ tri_out) {
  const int r = blockIdx.x * kThreads + threadIdx.x;
  const bool in_range = r < n;
  Ray ray = {};
  bool live = false;
  if (in_range) {
    ray = load_ray(rox, roy, roz, rdx, rdy, rdz, tnear, tfar, tfar_all, r);
    live = ray.tfar > 0.0f;
  }
  float best = ray.tfar;
  int best_slot = -1;
  if (__any_sync(kFull, live)) {
    const int pitch = n_sc * 128;  // clb rows a * n_sc + s are n_sc * 128 floats apart
    for (int s = 0; s < n_sc; ++s) {
      const bool ls = live && slab(scb, spad, s, ray, ray.tfar);
      if (!__any_sync(kFull, ls)) {
        continue;
      }
      for (int j = 0; j < kCPS; ++j) {
        const bool lc = ls && slab(clb, pitch, s * 128 + j, ray, best);
        if (!__any_sync(kFull, lc)) {
          continue;
        }
        const int base = (s * kCPS + j) * kCB;
        for (int l = 0; l < kCB; ++l) {
          float t;
          const bool ok = bw_test(tris, stride, base + l, ray, t);
          if (lc && ok && t < best) {
            best = t;
            best_slot = base + l;
          }
        }
      }
    }
  }
  if (in_range) {
    t_out[r] = best_slot >= 0 ? best : -1.0f;
    tri_out[r] = best_slot >= 0 ? static_cast<int>(__ldg(tris + 12 * stride + best_slot)) : -1;
  }
}

__global__ void __launch_bounds__(kThreads)
cluster_anyhit_kernel(const float* __restrict__ scb, int spad, const float* __restrict__ clb,
                      int n_sc, const float* __restrict__ tris, int stride,
                      const float* __restrict__ rox, const float* __restrict__ roy,
                      const float* __restrict__ roz, const float* __restrict__ rdx,
                      const float* __restrict__ rdy, const float* __restrict__ rdz, float tnear,
                      const float* __restrict__ tfar, float tfar_all, int n,
                      int* __restrict__ hit_out) {
  const int r = blockIdx.x * kThreads + threadIdx.x;
  const bool in_range = r < n;
  Ray ray = {};
  bool live = false;
  if (in_range) {
    ray = load_ray(rox, roy, roz, rdx, rdy, rdz, tnear, tfar, tfar_all, r);
    live = ray.tfar > 0.0f;
  }
  bool open = live;  // live and not yet blocked
  const int pitch = n_sc * 128;
  for (int s = 0; s < n_sc && __any_sync(kFull, open); ++s) {
    const bool ls = open && slab(scb, spad, s, ray, ray.tfar);
    if (!__any_sync(kFull, ls)) {
      continue;
    }
    for (int j = 0; j < kCPS; ++j) {
      const bool lc = ls && open && slab(clb, pitch, s * 128 + j, ray, ray.tfar);
      if (!__any_sync(kFull, lc)) {
        continue;
      }
      const int base = (s * kCPS + j) * kCB;
      for (int l = 0; l < kCB && __any_sync(kFull, lc && open); ++l) {
        if (lc && open) {
          float t;
          const bool ok = bw_test(tris, stride, base + l, ray, t);
          if (ok && t < ray.tfar) {
            open = false;
          }
        }
      }
    }
  }
  if (in_range) {
    hit_out[r] = (live && !open) ? 1 : 0;
  }
}

}  // namespace

extern "C" {

int pim_cluster_isect(const float* scb, int spad, const float* clb, int n_sc, const float* tris,
                      int stride, const float* rox, const float* roy, const float* roz,
                      const float* rdx, const float* rdy, const float* rdz, float tnear,
                      const float* tfar, float tfar_all, int n, float* t_out, int* tri_out,
                      void* stream) {
  const int blocks = (n + kThreads - 1) / kThreads;
  cluster_isect_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      scb, spad, clb, n_sc, tris, stride, rox, roy, roz, rdx, rdy, rdz, tnear, tfar, tfar_all, n,
      t_out, tri_out);
  return static_cast<int>(cudaGetLastError());
}

int pim_cluster_anyhit(const float* scb, int spad, const float* clb, int n_sc, const float* tris,
                       int stride, const float* rox, const float* roy, const float* roz,
                       const float* rdx, const float* rdy, const float* rdz, float tnear,
                       const float* tfar, float tfar_all, int n, int* hit_out, void* stream) {
  const int blocks = (n + kThreads - 1) / kThreads;
  cluster_anyhit_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      scb, spad, clb, n_sc, tris, stride, rox, roy, roz, rdx, rdy, rdz, tnear, tfar, tfar_all, n,
      hit_out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
