// Dense Baldwin-Weber ray/triangle kernels for Hopper (sm_90a): K1 closest
// hit and K2 any hit.
//
// Replaces: pim_tpu/render/pallas_kernels.py:_isect_kernel (K1) and
// :_anyhit_kernel (K2), reached through intersect_pallas_raw and
// occluded_pallas.
//
// What bounds it on this card (K1): issue slots.  With --fmad=false every
// product and sum is an instruction of its own, so a (ray, row) test is 15
// products, 15 sums, the IEEE division (a reciprocal, five FMAs of its own
// refinement, a range check and a branch to its slow path), six compares
// and two selects: about 50 instructions by count of the source's
// operations, at most 4 issued a cycle an SM.
// A ray reads 28 bytes and writes 8, and the rows (Tpad x 48 bytes, 5.4 KB
// for the Cornell box) come from shared memory as three 16-byte loads a
// row, one address for all lanes.  The bound of 31 operations a test at
// 67 TFLOP/s counts an FMA as two, so about twice it is the floor here.  On
// the main path most rays are dead after the first bounces: in sample 0 of
// a Cornell 512^2 step, 99,765 of 262,144 rays are live at bounce 1 and
// 15,650 at bounce 3, spread over every warp.
//
// What the design does about it: a block of kBlock = 512 threads takes 512
// rays, writes the dead rays' results at once and packs the live ones into
// its first warps (ballots and one scan), so dead lanes issue nothing; one
// ray a thread walks the rows in index order with a single limit compare
// (t < min(t_far, best t)); 32 registers a thread keep 4 blocks resident an
// SM.  Measured (tools/dense_variants.py, NVIDIA H100 80GB HBM3, 700.00 W;
// PERF.md): 262,144 random rays 0.0586 ms against the unpacked kernel's
// 0.0641, the 11 K1 calls of a Cornell sample 0.2400 against 0.4361.  Two
// or four rays a thread, and a warp's conservative skip of the division
// and the u/v test where no lane can pass (64% of the warp tests of the
// primary rays), cost more than they saved and were dropped.
//
// K2 (unchanged): one thread per ray walks the rows staged in shared
// memory in chunks of kTriChunk rows; t_near is one value for all rays
// (every caller passes 0), and t_far is either a per-ray [N] array or,
// when its pointer is null, one value for all rays.  A ray with t_far <= 0
// is dead and does no work; a block with no live ray skips the triangle
// loop entirely.
//
// Exactness: the file is compiled with --fmad=false and without fast math,
// so every product, sum and the division round as the reference's separate
// float32 operations, in the reference's order (pallas_kernels.py:130-138).
// Degenerate (padding) rows have n = 0, so their t is NaN and fails every
// compare.  K1 accepts a triangle only when it is valid and t < lim,
// walking in increasing index, which keeps the lowest index on ties; a
// dead ray reports (-1, -1).  K2 keeps the reference's dead-lane result: a
// ray with t_far <= 0 reports 1.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kRowFloats = 12;
constexpr int kTriChunk = 256;  // 12 KB of shared memory per block
constexpr int kThreads = 128;    // K2's block
constexpr int kBlock = 512;      // K1's block: the rays whose live ones it packs
constexpr int kWarps = kBlock / 32;
constexpr int kMinBlocks = 4;    // K1 blocks resident an SM (<= 32 registers)
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

constexpr unsigned kFull = 0xffffffffu;

// Copies rows [c0, c0 + cnt) into shared memory as three float4 a row (the
// rows are 48 bytes, so a 16-byte aligned table keeps every row aligned);
// callers synchronise.
__device__ __forceinline__ void stage_rows4(float4* s_rows, const float* __restrict__ tris,
                                            int c0, int cnt, int threads) {
  const float* src = tris + static_cast<long long>(c0) * kRowFloats;
  if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    const float4* src4 = reinterpret_cast<const float4*>(src);
    for (int k = threadIdx.x; k < cnt * 3; k += threads) s_rows[k] = __ldg(src4 + k);
  } else {
    float* dst = reinterpret_cast<float*>(s_rows);
    for (int k = threadIdx.x; k < cnt * kRowFloats; k += threads) dst[k] = __ldg(src + k);
  }
}

// K1.  A block of kBlock threads takes tiles of kBlock rays.  It writes the
// results of the tile's dead rays at once and packs its live rays, in ray
// order, into the block's first threads (warp ballots and one scan), so
// that a dead lane costs nothing and a warp with a live ray holds 32 of
// them but for the last one.  Its lanes past the last live ray copy their
// warp's first ray and discard their result (a zero ray would send every
// division down its slow path).  Each ray walks the rows in index order
// from shared memory (three 16-byte loads a row, the same address for all
// lanes); its limit `lim` starts at min(t_far, kBig) and becomes the t of
// each accepted hit, so one compare t < lim stands for the reference's
// t < t_far && t < best_t.  The rows are staged once per block when they
// fit in one chunk, and the grid holds no more blocks than stay resident:
// kMinBlocks blocks an SM, which caps the registers at 32 a thread.
__global__ void __launch_bounds__(kBlock, kMinBlocks)
dense_isect_kernel(const float* __restrict__ tris, int ntri, const float* __restrict__ rox,
                   const float* __restrict__ roy, const float* __restrict__ roz,
                   const float* __restrict__ rdx, const float* __restrict__ rdy,
                   const float* __restrict__ rdz, float tnear, const float* __restrict__ tfar,
                   float tfar_all, int n, float* __restrict__ t_out,
                   int* __restrict__ tri_out) {
  __shared__ float4 s_rows[kTriChunk * 3];
  __shared__ int s_live[kBlock];
  __shared__ int s_base[kWarps + 1];
  const int nchunk = (ntri + kTriChunk - 1) / kTriChunk;
  const int tiles = (n + kBlock - 1) / kBlock;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  bool staged = false;  // block-uniform
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    __syncthreads();  // the previous tile is done with s_live and s_base
    const int r0 = tile * kBlock + threadIdx.x;
    const float tf0 = r0 < n ? (tfar != nullptr ? tfar[r0] : tfar_all) : 0.0f;
    const bool live0 = tf0 > 0.0f;
    if (r0 < n && !live0) {
      t_out[r0] = -1.0f;
      tri_out[r0] = -1;
    }
    const unsigned ballot = __ballot_sync(kFull, live0);
    if (lane == 0) s_base[warp] = __popc(ballot);
    __syncthreads();
    if (threadIdx.x == 0) {
      int sum = 0;
      for (int w = 0; w < kWarps; ++w) {
        const int c = s_base[w];
        s_base[w] = sum;
        sum += c;
      }
      s_base[kWarps] = sum;
    }
    __syncthreads();
    if (live0) s_live[s_base[warp] + __popc(ballot & ((1u << lane) - 1u))] = r0;
    __syncthreads();
    const int count = s_base[kWarps];
    const bool warp_live = warp * 32 < count;  // its lane 0 holds a ray
    const int q = threadIdx.x;
    const int r = warp_live ? s_live[q < count ? q : warp * 32] : 0;
    float ox = 0.0f, oy = 0.0f, oz = 0.0f, dx = 0.0f, dy = 0.0f, dz = 0.0f, lim = 0.0f;
    if (warp_live) {
      ox = rox[r];
      oy = roy[r];
      oz = roz[r];
      dx = rdx[r];
      dy = rdy[r];
      dz = rdz[r];
      lim = fminf(tfar != nullptr ? tfar[r] : tfar_all, kBig);
    }
    int best = -1;
    for (int c = 0; c < nchunk && count > 0; ++c) {
      const int c0 = c * kTriChunk;
      const int cnt = min(kTriChunk, ntri - c0);
      if (nchunk > 1 || !staged) {
        __syncthreads();
        stage_rows4(s_rows, tris, c0, cnt, kBlock);
        __syncthreads();
        staged = true;
      }
      if (!warp_live) continue;
      for (int j = 0; j < cnt; ++j) {
        const float4 a = s_rows[3 * j];      // n, d
        const float4 b = s_rows[3 * j + 1];  // U, uw
        const float4 e = s_rows[3 * j + 2];  // V, vw
        const float den = a.x * dx + a.y * dy + a.z * dz;
        const float num = a.w - (a.x * ox + a.y * oy + a.z * oz);
        const float t = num / den;
        const float px = ox + t * dx;
        const float py = oy + t * dy;
        const float pz = oz + t * dz;
        const float u = b.x * px + b.y * py + b.z * pz + b.w;
        const float v = e.x * px + e.y * py + e.z * pz + e.w;
        if (u >= 0.0f && v >= 0.0f && u + v <= 1.0f && t > tnear && t < lim) {
          lim = t;
          best = c0 + j;
        }
      }
    }
    if (q < count) {
      t_out[r] = best >= 0 ? lim : -1.0f;
      tri_out[r] = best;
    }
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

// grid.x: no more blocks than the ray tiles, nor than stay resident.
int pim_dense_isect(const float* tris, int ntri, const float* rox, const float* roy,
                    const float* roz, const float* rdx, const float* rdy, const float* rdz,
                    float tnear, const float* tfar, float tfar_all, int n, float* t_out,
                    int* tri_out, void* stream) {
  static int resident = 0;
  if (resident == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, dense_isect_kernel, kBlock, 0);
    resident = sms * (per_sm > 0 ? per_sm : 1);
  }
  const int tiles = (n + kBlock - 1) / kBlock;
  const int grid = tiles < resident ? (tiles > 0 ? tiles : 1) : resident;
  dense_isect_kernel<<<grid, kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
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
