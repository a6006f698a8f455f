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
//                       cluster c owns slots [c * 128, c * 128 + 128), its
//                       triangles first, then padding (id -1, rows 0)
//
// What bounds it on this card: the Baldwin-Weber tests a warp issues.  A
// test is ~20 float32 operations and one IEEE division; a ray reads 32 bytes
// and writes 8, and the hierarchy (6 MB of BW rows for e1m1's 81,552
// triangles in 1,056 clusters) stays in L2.  A warp's 32 rays rarely need
// the same clusters: on e1m1's sorted bounce rays a ray needs ~2.7 clusters
// and its warp enters ~12, and the clusters are ~40% real triangles.
//
// What the design does about it: one thread per ray, and a warp walks the
// hierarchy together in slot order.  Each lane culls by its own slab tests
// (superclusters against its static t_far, clusters against its running
// best t for K4 or its t_far for K5), and __ballot_sync gives the lanes
// that enter cluster c.  The warp counts the cluster's real slots from its
// id row (1 + the last slot with id >= 0; padding slots fail every test,
// so those past it need none).  Then, while fewer than lane_loop_min lanes
// enter, the warp loads the real slots' rows once, coalesced, into
// registers (slot = lane + 32 k) and tests the entering rays one at a
// time: the ray is broadcast with __shfl_sync, every lane tests its own
// slots, and a warp reduction keeps the smallest t and, among equal t, the
// lowest slot (K4), or whether any slot blocks (K5).  Where more lanes
// enter, each lane runs its own ray over the real slots, reading each row
// as a broadcast from L1.  Either way a lane's result is the slot-by-slot
// walk's; lane_loop_min (render/cluster.py LANE_LOOP_MIN) only chooses
// which is cheaper.  K5 leaves as soon as every lane of the warp is blocked.
//
// Exactness: compiled with --fmad=false and without fast math, so every
// product, sum and division rounds as the reference's separate float32
// operations, in its order (cluster.py:222-266).  _safe_inv is copied
// (|x| > 1e-12 ? 1/x : 1e12), min and max propagate NaN as jnp.minimum and
// jnp.maximum do, and the BW division is unguarded: padding slots have
// n = 0, so their t is NaN and fails every compare.  K4 accepts only
// t < best and keeps the lowest slot among equal t, as the reference's final
// argmin does (cluster.py:327-342).  K5's dead lanes (t_far <= 0) report 0
// (cluster.py:399-401), unlike K2's.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kCB = 128;                // slots per cluster
constexpr int kCPS = 16;                // clusters per supercluster
constexpr int kChunks = kCB / 32;       // a lane's slots lane + 32 k
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned kNone = 0xffffffffu;  // no candidate in a warp reduction

struct Ray {
  float ox, oy, oz, dx, dy, dz, ix, iy, iz, tnear, tfar;
};

__device__ __forceinline__ float safe_inv(float x) { return fabsf(x) > 1e-12f ? 1.0f / x : 1e12f; }

// jnp.minimum / jnp.maximum: NaN in either operand gives NaN.
__device__ __forceinline__ float nmin(float a, float b) { return (a < b || a != a) ? a : b; }
__device__ __forceinline__ float nmax(float a, float b) { return (a > b || a != a) ? a : b; }

// A key whose unsigned order is the float order of non-NaN t (-0 before +0).
__device__ __forceinline__ unsigned order_key(float t) {
  const unsigned u = __float_as_uint(t);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}
__device__ __forceinline__ float key_value(unsigned k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

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

// Baldwin-Weber test of one slot's rows w[0..11] (nx ny nz d, u row, v row)
// against the ray (o, d): geometric validity and t (the far test is the
// caller's).
__device__ __forceinline__ bool bw_eval(const float* w, float ox, float oy, float oz, float dx,
                                        float dy, float dz, float tnear, float& t) {
  const float den = w[0] * dx + w[1] * dy + w[2] * dz;
  const float num = w[3] - (w[0] * ox + w[1] * oy + w[2] * oz);
  t = num / den;
  const float px = ox + t * dx;
  const float py = oy + t * dy;
  const float pz = oz + t * dz;
  const float u = w[4] * px + w[5] * py + w[6] * pz + w[7];
  const float v = w[8] * px + w[9] * py + w[10] * pz + w[11];
  return (u >= 0.0f) && (v >= 0.0f) && (u + v <= 1.0f) && (t > tnear);
}

// The same test on slot `slot`, its rows read from L1 (every lane of the
// warp reads the same slot: a broadcast).
__device__ __forceinline__ bool bw_slot(const float* __restrict__ tris, int stride, int slot,
                                        const Ray& r, float& t) {
  float w[12];
#pragma unroll
  for (int a = 0; a < 12; ++a) {
    w[a] = __ldg(tris + a * stride + slot);
  }
  return bw_eval(w, r.ox, r.oy, r.oz, r.dx, r.dy, r.dz, r.tnear, t);
}

// 1 + the last slot of cluster `base` whose tri id (row 12) is >= 0; 0 for
// a cluster of padding only.  Every lane gets the same value.
__device__ __forceinline__ int real_slots(const float* __restrict__ tris, int stride, int base,
                                          int lane) {
  int hi = 0;
#pragma unroll
  for (int k = 0; k < kChunks; ++k) {
    const unsigned b =
        __ballot_sync(kFull, __ldg(tris + 12 * stride + base + lane + 32 * k) >= 0.0f);
    if (b != 0u) {
      hi = 32 * k + 32 - __clz(b);
    }
  }
  return hi;
}

// This lane's slots lane + 32 k of the cluster at `base`, for k < nch.
__device__ __forceinline__ void load_rows(const float* __restrict__ tris, int stride, int base,
                                          int lane, int nch, float (&w)[kChunks][12]) {
#pragma unroll
  for (int k = 0; k < kChunks; ++k) {
    if (k < nch) {
#pragma unroll
      for (int a = 0; a < 12; ++a) {
        w[k][a] = __ldg(tris + a * stride + base + lane + 32 * k);
      }
    }
  }
}

// K4 on one cluster, ray by ray: for each lane in `need`, the smallest t
// below its best over the cluster's slots [0, hi), the lowest slot among
// equal t; the lane takes it as its new best.
__device__ __forceinline__ void closest_by_ray(const float* __restrict__ tris, int stride,
                                               int base, int hi, unsigned need, int lane,
                                               const Ray& ray, float& best, int& best_slot) {
  const int nch = (hi + 31) >> 5;
  float w[kChunks][12];
  load_rows(tris, stride, base, lane, nch, w);
  for (unsigned m = need; m != 0u; m &= m - 1u) {
    const int i = __ffs(m) - 1;
    const float ox = __shfl_sync(kFull, ray.ox, i);
    const float oy = __shfl_sync(kFull, ray.oy, i);
    const float oz = __shfl_sync(kFull, ray.oz, i);
    const float dx = __shfl_sync(kFull, ray.dx, i);
    const float dy = __shfl_sync(kFull, ray.dy, i);
    const float dz = __shfl_sync(kFull, ray.dz, i);
    const float bt = __shfl_sync(kFull, best, i);
    float lt = 0.0f;  // this lane's smallest t, at its lowest slot
    int loff = -1;
#pragma unroll
    for (int k = 0; k < kChunks; ++k) {
      if (k < nch) {
        const int off = lane + 32 * k;
        float t;
        const bool ok = bw_eval(w[k], ox, oy, oz, dx, dy, dz, ray.tnear, t);
        if (off < hi && ok && t < bt && (loff < 0 || t < lt)) {
          lt = t;
          loff = off;
        }
      }
    }
    const unsigned kmin = __reduce_min_sync(kFull, loff >= 0 ? order_key(lt) : kNone);
    if (kmin == kNone) {
      continue;
    }
    // the lowest slot whose t equals the smallest (as floats: -0 == +0),
    // and that slot's own t
    const float tmin = key_value(kmin);
    const unsigned off = __reduce_min_sync(
        kFull, (loff >= 0 && lt == tmin) ? static_cast<unsigned>(loff) : kNone);
    const float twin = __shfl_sync(kFull, lt, static_cast<int>(off & 31u));
    if (lane == i) {
      best = twin;
      best_slot = base + static_cast<int>(off);
    }
  }
}

// K5 on one cluster, ray by ray: each lane in `need` whose ray any slot of
// [0, hi) blocks before its t_far closes.
__device__ __forceinline__ void block_by_ray(const float* __restrict__ tris, int stride, int base,
                                             int hi, unsigned need, int lane, const Ray& ray,
                                             bool& open) {
  const int nch = (hi + 31) >> 5;
  float w[kChunks][12];
  load_rows(tris, stride, base, lane, nch, w);
  for (unsigned m = need; m != 0u; m &= m - 1u) {
    const int i = __ffs(m) - 1;
    const float ox = __shfl_sync(kFull, ray.ox, i);
    const float oy = __shfl_sync(kFull, ray.oy, i);
    const float oz = __shfl_sync(kFull, ray.oz, i);
    const float dx = __shfl_sync(kFull, ray.dx, i);
    const float dy = __shfl_sync(kFull, ray.dy, i);
    const float dz = __shfl_sync(kFull, ray.dz, i);
    const float tf = __shfl_sync(kFull, ray.tfar, i);
    bool hit = false;
#pragma unroll
    for (int k = 0; k < kChunks; ++k) {
      if (k < nch) {
        float t;
        const bool ok = bw_eval(w[k], ox, oy, oz, dx, dy, dz, ray.tnear, t);
        hit = hit || (lane + 32 * k < hi && ok && t < tf);
      }
    }
    if (__any_sync(kFull, hit) && lane == i) {
      open = false;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
cluster_isect_kernel(const float* __restrict__ scb, int spad, const float* __restrict__ clb,
                     int n_sc, const float* __restrict__ tris, int stride,
                     const float* __restrict__ rox, const float* __restrict__ roy,
                     const float* __restrict__ roz, const float* __restrict__ rdx,
                     const float* __restrict__ rdy, const float* __restrict__ rdz, float tnear,
                     const float* __restrict__ tfar, float tfar_all, int n, int lane_loop_min,
                     float* __restrict__ t_out, int* __restrict__ tri_out) {
  const int r = blockIdx.x * kThreads + threadIdx.x;
  const int lane = threadIdx.x & 31;
  const bool in_range = r < n;
  Ray ray = {};
  ray.tnear = tnear;  // lanes past n still test their slots against other lanes' rays
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
        const unsigned need = __ballot_sync(kFull, lc);
        if (need == 0u) {
          continue;
        }
        const int base = (s * kCPS + j) * kCB;
        const int hi = real_slots(tris, stride, base, lane);
        if (hi == 0) {
          continue;
        }
        if (__popc(need) < lane_loop_min) {
          closest_by_ray(tris, stride, base, hi, need, lane, ray, best, best_slot);
          continue;
        }
        for (int l = 0; l < hi; ++l) {
          float t;
          const bool ok = bw_slot(tris, stride, base + l, ray, t);
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
                      const float* __restrict__ tfar, float tfar_all, int n, int lane_loop_min,
                      int* __restrict__ hit_out) {
  const int r = blockIdx.x * kThreads + threadIdx.x;
  const int lane = threadIdx.x & 31;
  const bool in_range = r < n;
  Ray ray = {};
  ray.tnear = tnear;  // lanes past n still test their slots against other lanes' rays
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
      const unsigned need = __ballot_sync(kFull, lc);
      if (need == 0u) {
        continue;
      }
      const int base = (s * kCPS + j) * kCB;
      const int hi = real_slots(tris, stride, base, lane);
      if (hi == 0) {
        continue;
      }
      if (__popc(need) < lane_loop_min) {
        block_by_ray(tris, stride, base, hi, need, lane, ray, open);
        continue;
      }
      for (int l = 0; l < hi && __any_sync(kFull, lc && open); ++l) {
        if (lc && open) {
          float t;
          const bool ok = bw_slot(tris, stride, base + l, ray, t);
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
                      const float* tfar, float tfar_all, int n, int lane_loop_min, float* t_out,
                      int* tri_out, void* stream) {
  const int blocks = (n + kThreads - 1) / kThreads;
  cluster_isect_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      scb, spad, clb, n_sc, tris, stride, rox, roy, roz, rdx, rdy, rdz, tnear, tfar, tfar_all, n,
      lane_loop_min, t_out, tri_out);
  return static_cast<int>(cudaGetLastError());
}

int pim_cluster_anyhit(const float* scb, int spad, const float* clb, int n_sc, const float* tris,
                       int stride, const float* rox, const float* roy, const float* roz,
                       const float* rdx, const float* rdy, const float* rdz, float tnear,
                       const float* tfar, float tfar_all, int n, int lane_loop_min, int* hit_out,
                       void* stream) {
  const int blocks = (n + kThreads - 1) / kThreads;
  cluster_anyhit_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      scb, spad, clb, n_sc, tris, stride, rox, roy, roz, rdx, rdy, rdz, tnear, tfar, tfar_all, n,
      lane_loop_min, hit_out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
