// Dense Baldwin-Weber ray/triangle kernels for Hopper (sm_90a): K1 closest
// hit and K2 any hit.
//
// Replaces: pim_tpu/render/pallas_kernels.py:_isect_kernel (K1) and
// :_anyhit_kernel (K2), reached through intersect_pallas_raw and
// occluded_pallas.
//
// What bounds it on this card: arithmetic.  Each (ray, tri) test is about
// 20 float32 operations plus one IEEE division; a ray reads 32 bytes and
// writes 8, while the triangle rows (Tpad x 12 floats, 5.4 KB for the
// Cornell box) are read by every ray.  At 262,144 rays x 112 tris a call is
// ~0.6 GFLOP against ~10 MB of device memory traffic.
//
// What the design does about it: one thread per ray keeps the ray in
// registers and walks the triangles in index order; the triangle rows are
// staged in shared memory in chunks of kTriChunk rows, and every thread of a
// warp reads the same row, so each read is a shared-memory broadcast.  Rays
// are read directly from their SoA [N] tensors (no packing or padding; the
// ragged tail is masked).  t_near is one value for all rays (every caller
// passes 0), and t_far is either a per-ray [N] array or, when its pointer is
// null, one value for all rays, so no caller fills an [N] tensor with a
// constant.  A ray with t_far <= 0 is dead and does no work; a block with no
// live ray skips the triangle loop entirely.
//
// Exactness: the file is compiled with --fmad=false and without fast math,
// so every product, sum and the division round as the reference's separate
// float32 operations, in the reference's order (pallas_kernels.py:130-138).
// Degenerate (padding) rows have n = 0, so their t is NaN and fails every
// compare.  K1 accepts a triangle only when it is valid and t < best_t,
// walking in increasing index, which keeps the lowest index on ties.  K2
// keeps the reference's dead-lane result: a ray with t_far <= 0 reports 1.

#include <cuda_runtime.h>

namespace {

constexpr int kRowFloats = 12;
constexpr int kTriChunk = 256;  // 12 KB of shared memory per block
constexpr int kThreads = 128;
constexpr float kBig = 3.0e38f;

struct Ray {
  float ox, oy, oz, dx, dy, dz, tnear, tfar;
};

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
  ray.tnear = tnear;
  ray.tfar = tfar != nullptr ? tfar[r] : tfar_all;
  return ray;
}

// Baldwin-Weber test of one row against one ray: returns geometric validity
// (u, v >= 0, u + v <= 1, t > t_near) and t; the far-plane test is the
// caller's.
__device__ __forceinline__ bool bw_test(const float* tri, const Ray& r, float& t) {
  const float nx = tri[0], ny = tri[1], nz = tri[2], d = tri[3];
  const float den = nx * r.dx + ny * r.dy + nz * r.dz;
  const float num = d - (nx * r.ox + ny * r.oy + nz * r.oz);
  t = num / den;
  const float px = r.ox + t * r.dx;
  const float py = r.oy + t * r.dy;
  const float pz = r.oz + t * r.dz;
  const float u = tri[4] * px + tri[5] * py + tri[6] * pz + tri[7];
  const float v = tri[8] * px + tri[9] * py + tri[10] * pz + tri[11];
  return (u >= 0.0f) && (v >= 0.0f) && (u + v <= 1.0f) && (t > r.tnear);
}

// Copies rows [c0, c0 + cnt) into shared memory; callers synchronise.
__device__ __forceinline__ void stage_rows(float* s_tris, const float* __restrict__ tris, int c0,
                                           int cnt) {
  for (int k = threadIdx.x; k < cnt * kRowFloats; k += kThreads) {
    s_tris[k] = tris[c0 * kRowFloats + k];
  }
}

__global__ void __launch_bounds__(kThreads)
dense_isect_kernel(const float* __restrict__ tris, int ntri, const float* __restrict__ rox,
                   const float* __restrict__ roy, const float* __restrict__ roz,
                   const float* __restrict__ rdx, const float* __restrict__ rdy,
                   const float* __restrict__ rdz, float tnear, const float* __restrict__ tfar,
                   float tfar_all, int n, float* __restrict__ t_out,
                   int* __restrict__ tri_out) {
  __shared__ float s_tris[kTriChunk * kRowFloats];
  const int r = blockIdx.x * kThreads + threadIdx.x;
  const bool in_range = r < n;
  Ray ray = {};
  bool live = false;
  if (in_range) {
    ray = load_ray(rox, roy, roz, rdx, rdy, rdz, tnear, tfar, tfar_all, r);
    live = ray.tfar > 0.0f;
  }
  float best_t = kBig;
  int best_i = -1;
  if (__syncthreads_or(live)) {
    for (int c0 = 0; c0 < ntri; c0 += kTriChunk) {
      const int cnt = min(kTriChunk, ntri - c0);
      __syncthreads();
      stage_rows(s_tris, tris, c0, cnt);
      __syncthreads();
      if (live) {
        for (int j = 0; j < cnt; ++j) {
          float t;
          const bool ok = bw_test(&s_tris[j * kRowFloats], ray, t);
          if (ok && t < ray.tfar && t < best_t) {
            best_t = t;
            best_i = c0 + j;
          }
        }
      }
    }
  }
  if (in_range) {
    t_out[r] = best_i >= 0 ? best_t : -1.0f;
    tri_out[r] = best_i;
  }
}

__global__ void __launch_bounds__(kThreads)
dense_anyhit_kernel(const float* __restrict__ tris, int ntri, const float* __restrict__ rox,
                    const float* __restrict__ roy, const float* __restrict__ roz,
                    const float* __restrict__ rdx, const float* __restrict__ rdy,
                    const float* __restrict__ rdz, float tnear, const float* __restrict__ tfar,
                    float tfar_all, int n, int* __restrict__ hit_out) {
  __shared__ float s_tris[kTriChunk * kRowFloats];
  const int r = blockIdx.x * kThreads + threadIdx.x;
  const bool in_range = r < n;
  Ray ray = {};
  int hit = 1;
  if (in_range) {
    ray = load_ray(rox, roy, roz, rdx, rdy, rdz, tnear, tfar, tfar_all, r);
    hit = ray.tfar <= 0.0f ? 1 : 0;  // dead lanes start (and stay) blocked
  }
  bool open = hit == 0;
  for (int c0 = 0; c0 < ntri && __syncthreads_or(open); c0 += kTriChunk) {
    const int cnt = min(kTriChunk, ntri - c0);
    stage_rows(s_tris, tris, c0, cnt);
    __syncthreads();
    if (open) {
      for (int j = 0; j < cnt; ++j) {
        float t;
        const bool ok = bw_test(&s_tris[j * kRowFloats], ray, t);
        if (ok && t < ray.tfar) {
          hit = 1;
          open = false;
          break;
        }
      }
    }
  }
  if (in_range) {
    hit_out[r] = hit;
  }
}

}  // namespace

extern "C" {

int pim_dense_isect(const float* tris, int ntri, const float* rox, const float* roy,
                    const float* roz, const float* rdx, const float* rdy, const float* rdz,
                    float tnear, const float* tfar, float tfar_all, int n, float* t_out,
                    int* tri_out, void* stream) {
  const int blocks = (n + kThreads - 1) / kThreads;
  dense_isect_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      tris, ntri, rox, roy, roz, rdx, rdy, rdz, tnear, tfar, tfar_all, n, t_out, tri_out);
  return static_cast<int>(cudaGetLastError());
}

int pim_dense_anyhit(const float* tris, int ntri, const float* rox, const float* roy,
                     const float* roz, const float* rdx, const float* rdy, const float* rdz,
                     float tnear, const float* tfar, float tfar_all, int n, int* hit_out,
                     void* stream) {
  const int blocks = (n + kThreads - 1) / kThreads;
  dense_anyhit_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      tris, ntri, rox, roy, roz, rdx, rdy, rdz, tnear, tfar, tfar_all, n, hit_out);
  return static_cast<int>(cudaGetLastError());
}

const char* pim_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
