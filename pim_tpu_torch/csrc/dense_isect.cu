// Dense Baldwin-Weber ray/triangle kernels for Hopper (sm_90a): K1 closest
// hit and K2 any hit.
//
// Replaces: pim_tpu/render/pallas_kernels.py:_isect_kernel (K1) and
// :_anyhit_kernel (K2), reached through intersect_pallas_raw and
// occluded_pallas.
//
// What bounds it on this card: issue slots.  With --fmad=false every
// product and sum is an instruction of its own, so a (ray, row) test is 15
// products, 15 sums, the IEEE division (a reciprocal, five FMAs of its own
// refinement, a range check and a branch to its slow path), six compares
// and two selects: about 50 instructions by count of the source's
// operations, at most 4 issued a cycle an SM.
// A ray reads 28 bytes and writes 8 (K1) or 4 (K2), and the rows (Tpad x
// 48 bytes, 5.4 KB for the Cornell box) come from shared memory as three
// 16-byte loads a row.  The bound of 31 operations a test at 67 TFLOP/s
// counts an FMA as two, so about twice it is the floor here.  On the main
// path most rays are dead after the first bounces: in sample 0 of a
// Cornell 512^2 step, 99,765 of 262,144 rays are live at bounce 1, 15,650
// at bounce 3 and 29 at bounce 10, spread over every warp; there a call
// sits at a latency floor, one warp walking the rows one test after
// another.  K2 needs only the tests up to a ray's first blocker.
//
// What the design does about it: a block of kBlock = 512 threads takes
// tiles of 512 rays, writes the dead rays' results at once and packs the
// live ones, in ray order, into its first slots (warp ballots and one scan,
// `pack_slot`), so dead lanes issue nothing; the grid holds no more blocks
// than stay resident.  The rows are staged in shared memory as three
// float4 a row (`stage_rows4`), once per block when they fit in one chunk
// of kTriChunk rows, and every test is the one `bw_test`.
// - K1: one ray a thread walks the rows in index order with a single limit
//   compare (t < min(t_far, best t)).  Its lanes past the last live ray
//   copy their warp's first ray and discard their result (a zero ray would
//   send every division down its slow path).  kMinBlocks = 4 blocks an SM
//   cap it at 32 registers: one wave.
// - K2: an any hit has no tie rule, so a ray may test its rows in any order
//   and stop at any blocker.  A tile with warp_below live rays or more runs
//   one ray a thread: a warp tests kGroup rows in every lane, straight-line
//   code, then votes whether any of its rays is still open; its lanes past
//   the last live ray copy the warp's first ray and start closed.  A tile
//   with fewer runs one ray a warp: warp w takes the packed rays w, w + 16,
//   ... one at a time, its lanes test rows lane, lane + 32, ... of the
//   chunk, and a vote after each 32-row step ends the ray at its first
//   blocking step (a 112-row walk becomes 4 steps).  Past one chunk the
//   block stages the next only while some ray of the tile is open.
//   warp_below (render/dense_kernels.py ANYHIT_WARP_BELOW) only chooses
//   which form is cheaper: the flag is the same either way.  kAnyMinBlocks
//   = 2 blocks an SM give it 64 registers and no spill: at 32 the row loop
//   spilled and ran slower (PERF.md).
// Measured (tools/dense_variants.py, NVIDIA H100 80GB HBM3, 700.00 W;
// PERF.md): K1 on 262,144 random rays 0.0582 ms, its 11 calls of a
// Cornell sample 0.235-0.239; K2 on the same rays 0.0570 against the
// unpacked kernel's 0.0657-0.0662, its 10 calls of the sample 0.167
// against 0.432-0.435, the last of them (67 live rays) 0.0057 against
// 0.0180.  Two or four rays a thread in K1, and a warp's conservative skip
// of the division and the u/v test where no lane can pass, cost more than
// they saved and were dropped.
//
// Exactness: the file is compiled with --fmad=false and without fast math,
// so every product, sum and the division round as the reference's separate
// float32 operations, in the reference's order (pallas_kernels.py:130-138).
// Degenerate (padding) rows have n = 0, so their t is NaN and fails every
// compare.  t_near is one value for all rays (every caller passes 0);
// t_far is a per-ray [N] array or, when its pointer is null, one value for
// all rays.  K1 accepts a triangle only when it is valid and t < lim,
// walking in increasing index, which keeps the lowest index on ties; a
// dead ray (t_far <= 0) reports (-1, -1).  K2 keeps the reference's
// dead-lane result: a ray with t_far <= 0 reports 1.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kRowFloats = 12;
constexpr int kTriChunk = 256;  // 12 KB of shared memory per block
constexpr int kBlock = 512;     // the rays a block takes and packs
constexpr int kWarps = kBlock / 32;
constexpr int kMinBlocks = 4;   // K1 blocks resident an SM (<= 32 registers)
constexpr int kAnyMinBlocks = 2;  // K2 blocks resident an SM (<= 64 registers)
constexpr int kGroup = 16;      // K2: rows a ray tests between two votes, one ray a thread
constexpr float kBig = 3.0e38f;
constexpr unsigned kFull = 0xffffffffu;

// Baldwin-Weber test of one staged row's three float4 (n, d; U, uw; V, vw)
// against one ray held in registers: t, and whether u, v >= 0, u + v <= 1
// and t_near < t < t_lim.  Both come back by value: through a reference
// out-parameter the compiler kept K1's loop in 60 bytes of spill, not 24,
// and K1 ran 11% slower.
struct BwHit {
  float t;
  bool ok;
};

__device__ __forceinline__ BwHit bw_test(float4 a, float4 b, float4 e, float3 o, float3 d,
                                         float tnear, float tlim) {
  const float den = a.x * d.x + a.y * d.y + a.z * d.z;
  const float num = a.w - (a.x * o.x + a.y * o.y + a.z * o.z);
  const float t = num / den;
  const float px = o.x + t * d.x;
  const float py = o.y + t * d.y;
  const float pz = o.z + t * d.z;
  const float u = b.x * px + b.y * py + b.z * pz + b.w;
  const float v = e.x * px + e.y * py + e.z * pz + e.w;
  return {t, u >= 0.0f && v >= 0.0f && u + v <= 1.0f && t > tnear && t < tlim};
}

// Copies rows [c0, c0 + cnt) into shared memory as three float4 a row (the
// rows are 48 bytes, so a 16-byte aligned table keeps every row aligned);
// callers synchronise.
__device__ __forceinline__ void stage_rows4(float4* s_rows, const float* __restrict__ tris,
                                            int c0, int cnt) {
  const float* src = tris + static_cast<long long>(c0) * kRowFloats;
  if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    const float4* src4 = reinterpret_cast<const float4*>(src);
    for (int k = threadIdx.x; k < cnt * 3; k += kBlock) s_rows[k] = __ldg(src4 + k);
  } else {
    float* dst = reinterpret_cast<float*>(s_rows);
    for (int k = threadIdx.x; k < cnt * kRowFloats; k += kBlock) dst[k] = __ldg(src + k);
  }
}

// The block's scan of its tile's live rays: returns this thread's packed
// slot (meaningful where `live`); s_base[kWarps] holds the tile's live
// rays.  The caller synchronises after writing the slots.
__device__ __forceinline__ int pack_slot(bool live, int* s_base) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const unsigned ballot = __ballot_sync(kFull, live);
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
  return s_base[warp] + __popc(ballot & ((1u << lane) - 1u));
}

// K1.  Each tile's live rays are packed into the block's first threads, so
// that a warp with a live ray holds 32 of them but for the last one; each
// ray walks the rows in index order from shared memory (the same address
// for all lanes); its limit `lim` starts at min(t_far, kBig) and becomes
// the t of each accepted hit, so one compare t < lim stands for the
// reference's t < t_far && t < best_t.
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
    const int slot = pack_slot(live0, s_base);
    if (live0) s_live[slot] = r0;
    __syncthreads();
    const int count = s_base[kWarps];
    const bool warp_live = warp * 32 < count;  // its lane 0 holds a ray
    const int q = threadIdx.x;
    const int r = warp_live ? s_live[q < count ? q : warp * 32] : 0;
    float3 o = make_float3(0.0f, 0.0f, 0.0f), d = o;
    float lim = 0.0f;
    if (warp_live) {
      o = make_float3(rox[r], roy[r], roz[r]);
      d = make_float3(rdx[r], rdy[r], rdz[r]);
      lim = fminf(tfar != nullptr ? tfar[r] : tfar_all, kBig);
    }
    int best = -1;
    for (int c = 0; c < nchunk && count > 0; ++c) {
      const int c0 = c * kTriChunk;
      const int cnt = min(kTriChunk, ntri - c0);
      if (nchunk > 1 || !staged) {
        __syncthreads();
        stage_rows4(s_rows, tris, c0, cnt);
        __syncthreads();
        staged = true;
      }
      if (!warp_live) continue;
      for (int j = 0; j < cnt; ++j) {
        const BwHit h =
            bw_test(s_rows[3 * j], s_rows[3 * j + 1], s_rows[3 * j + 2], o, d, tnear, lim);
        if (h.ok) {
          lim = h.t;
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

// K2.  Each tile's live rays are packed into shared memory (origin and
// t_far, direction and ray index), then run one ray a thread or, in a
// sparse tile, one ray a warp (see the head note).  `open` holds which rays
// are still unblocked: one ray a thread, whether this thread's is; one ray
// a warp, bit i for the warp's ray w + kWarps * i, the same in every lane.
// One ray a thread, a warp tests kGroup rows in every lane before a vote
// on whether any of its rays is still open, so the group's tests are
// straight-line code; its lanes past the last live ray copy the warp's
// first ray (a zero ray would send every division down its slow path) and
// start closed.  A NaN t_far is live, as in the plain version, and never
// blocks.
__global__ void __launch_bounds__(kBlock, kAnyMinBlocks)
dense_anyhit_kernel(const float* __restrict__ tris, int ntri, const float* __restrict__ rox,
                    const float* __restrict__ roy, const float* __restrict__ roz,
                    const float* __restrict__ rdx, const float* __restrict__ rdy,
                    const float* __restrict__ rdz, float tnear, const float* __restrict__ tfar,
                    float tfar_all, int n, int warp_below, int* __restrict__ hit_out) {
  __shared__ float4 s_rows[kTriChunk * 3];
  __shared__ float4 s_org[kBlock];  // packed rays: origin, t_far
  __shared__ float4 s_dir[kBlock];  // direction, ray index (its bits)
  __shared__ int s_base[kWarps + 1];
  const int nchunk = (ntri + kTriChunk - 1) / kTriChunk;
  const int tiles = (n + kBlock - 1) / kBlock;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  bool staged = false;  // block-uniform
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    __syncthreads();  // the previous tile is done with s_org, s_dir and s_base
    const int r0 = tile * kBlock + threadIdx.x;
    const float tf0 = r0 < n ? (tfar != nullptr ? tfar[r0] : tfar_all) : 0.0f;
    const bool live0 = r0 < n && !(tf0 <= 0.0f);
    if (r0 < n && !live0) hit_out[r0] = 1;
    const int slot = pack_slot(live0, s_base);
    if (live0) {
      s_org[slot] = make_float4(rox[r0], roy[r0], roz[r0], tf0);
      s_dir[slot] = make_float4(rdx[r0], rdy[r0], rdz[r0], __int_as_float(r0));
    }
    __syncthreads();
    const int count = s_base[kWarps];
    if (count == 0) continue;
    const bool by_warp = count < warp_below;  // block-uniform
    const int q = by_warp ? warp + kWarps * lane : threadIdx.x;  // the slot whose flag we write
    unsigned open = by_warp ? __ballot_sync(kFull, q < count) : (q < count ? 1u : 0u);
    const bool walks = !by_warp && warp * 32 < count;  // one ray a thread, a warp with a ray
    float4 og = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    float3 d = make_float3(0.0f, 0.0f, 0.0f);
    if (walks) {
      og = s_org[q < count ? q : warp * 32];
      const float4 dr = s_dir[q < count ? q : warp * 32];
      d = make_float3(dr.x, dr.y, dr.z);
    }
    const float3 o = make_float3(og.x, og.y, og.z);
    for (int c = 0; c < nchunk; ++c) {
      // the previous chunk's walk is done; go on while some ray is open
      if (c > 0 && !__syncthreads_or(open != 0)) break;
      const int c0 = c * kTriChunk;
      const int cnt = min(kTriChunk, ntri - c0);
      if (nchunk > 1 || !staged) {
        stage_rows4(s_rows, tris, c0, cnt);
        __syncthreads();
        staged = true;
      }
      if (by_warp) {
        for (unsigned m = open; m != 0; m &= m - 1) {
          const int i = __ffs(m) - 1;
          const float4 wo = s_org[warp + kWarps * i];
          const float4 wd = s_dir[warp + kWarps * i];
          const float3 ow = make_float3(wo.x, wo.y, wo.z), dw = make_float3(wd.x, wd.y, wd.z);
          for (int j0 = 0; j0 < cnt; j0 += 32) {
            const int j = j0 + lane, r = 3 * j;
            const bool blocks =
                j < cnt && bw_test(s_rows[r], s_rows[r + 1], s_rows[r + 2], ow, dw, tnear, wo.w).ok;
            if (__any_sync(kFull, blocks)) {
              open &= ~(1u << i);
              break;
            }
          }
        }
      } else if (walks) {
        int j = 0;
        for (; j + kGroup <= cnt && __any_sync(kFull, open); j += kGroup) {
#pragma unroll
          for (int k = 0; k < kGroup; ++k) {
            const int r = 3 * (j + k);
            if (bw_test(s_rows[r], s_rows[r + 1], s_rows[r + 2], o, d, tnear, og.w).ok) open = 0u;
          }
        }
        for (; j < cnt && __any_sync(kFull, open); ++j) {
          const int r = 3 * j;
          if (bw_test(s_rows[r], s_rows[r + 1], s_rows[r + 2], o, d, tnear, og.w).ok) open = 0u;
        }
      }
    }
    if (q < count) {
      hit_out[__float_as_int(s_dir[q].w)] = ((by_warp ? open >> lane : open) & 1u) ? 0 : 1;
    }
  }
}

// No more blocks than the ray tiles, nor than stay resident (measured once
// a kernel into `resident`).
template <typename Kernel>
int tile_grid(Kernel kernel, int n, int& resident) {
  if (resident == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kBlock, 0);
    resident = sms * (per_sm > 0 ? per_sm : 1);
  }
  const int tiles = (n + kBlock - 1) / kBlock;
  return tiles < resident ? (tiles > 0 ? tiles : 1) : resident;
}

}  // namespace

extern "C" {

int pim_dense_isect(const float* tris, int ntri, const float* rox, const float* roy,
                    const float* roz, const float* rdx, const float* rdy, const float* rdz,
                    float tnear, const float* tfar, float tfar_all, int n, float* t_out,
                    int* tri_out, void* stream) {
  static int resident = 0;
  const int grid = tile_grid(dense_isect_kernel, n, resident);
  dense_isect_kernel<<<grid, kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      tris, ntri, rox, roy, roz, rdx, rdy, rdz, tnear, tfar, tfar_all, n, t_out, tri_out);
  return static_cast<int>(cudaGetLastError());
}

// warp_below: a tile with fewer live rays runs one ray a warp (0: never;
// above 512: always).
int pim_dense_anyhit(const float* tris, int ntri, const float* rox, const float* roy,
                     const float* roz, const float* rdx, const float* rdy, const float* rdz,
                     float tnear, const float* tfar, float tfar_all, int n, int warp_below,
                     int* hit_out, void* stream) {
  static int resident = 0;
  const int grid = tile_grid(dense_anyhit_kernel, n, resident);
  dense_anyhit_kernel<<<grid, kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      tris, ntri, rox, roy, roz, rdx, rdy, rdz, tnear, tfar, tfar_all, n, warp_below, hit_out);
  return static_cast<int>(cudaGetLastError());
}

const char* pim_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
