// Texel gather for Hopper (sm_90a): K7, out[c, k, n] = planes[c, clip(idx[k, n], 0, T-1)],
// and its backward, grad[c, clip(idx[k, n], 0, T-1)] += g[c, k, n].
//
// Replaces: pim_tpu/render/table_gather.py:_gather_kernel, reached through
// gather_texels_pallas and gather_texels (the four bilinear corners of every
// atlas texture set of the differentiable path, K = 4F index sets on the
// [4, H*W] parameter planes, and the sky cube's four corners on its
// [3, 6*S*S] planes).  The TPU kernel has no backward; JAX differentiates the
// CPU form of the same gather (jnp.take, whose transpose is a scatter-add),
// which the backward here computes.
//
// What bounds it on this card: device-memory bytes, the K*N indices read
// and the C*K*N floats written (an e1m1 fetch of K = 12 sets at 262,144
// lanes: 12.6 MB of indices, 50 MB written), and the L2 sectors of the
// scattered texel reads: in the [C, T] layout one query's C channels lie in
// C sectors T floats apart (12.6M sector reads for the atlas fetch).  The
// planes are 512 KiB for the e1m1 atlas and 72 KiB for a 32^2 sky.  The
// backward reads the same indices and the C*K*N gradient and adds into the
// [C, T] planes' gradient, whose columns many lanes share.
//
// What the design does about it (gather_tiles.cuh): a thread owns four
// queries; it loads their indices once (one 16-byte load where K*N is a
// multiple of 4 and the pointer is aligned), clamps them once, loads its
// channels' values before any store, and writes each channel with one
// 16-byte store (a scalar path with coalesced 4-byte accesses takes any
// other K*N).  32-bit offsets whenever C*K*N and C*T fit: the 64-bit form
// took 1.42x as long on random atlas indices and 1.12x on the sky's
// (pim_tpu_torch/tools/gather_variants.py, NVIDIA H100 80GB HBM3, 700.00 W).
// Planes of up to kStageMaxBytes (the sky) are staged in shared memory once per block,
// with 16-byte loads, and the grid holds no more blocks than stay resident.
// Larger planes (the atlas) are read through the read-only cache one plane
// per row of blocks (grid y = C): the blocks that run together then share
// one 128 KiB atlas plane in their SMs' L1 instead of all four.  The
// forward reads f32, so it is exact: the TPU kernel's one-hot MXU
// contraction and its bf16 split (parts = 1, 2, 3) exist only because the
// MXU multiplies bf16.  The backward adds with float atomicAdd into a
// zeroed output that the wrapper allocates, so the last bits of a texel's
// gradient vary from run to run with the order of adds.

#include <cuda_runtime.h>

#include <cstdint>

#include "gather_tiles.cuh"

namespace {

using pim_gather::kLanes;
using pim_gather::kThreads;
using pim_gather::kTileLanes;

__device__ __forceinline__ long long clamp_index(int32_t i, int t) {
  return static_cast<long long>(i < 0 ? 0 : (i > t - 1 ? t - 1 : i));
}

// The four queries' clamped texel indices for this thread in `tile`.
template <typename Off, bool kVec>
__device__ __forceinline__ void load_texels(const int32_t* __restrict__ idx, Off tile, Off kn,
                                            int t, Off (&col)[kLanes]) {
  int32_t i[kLanes] = {0, 0, 0, 0};
  if (kVec) {
    const Off e0 = pim_gather::lane<true>(tile, 0);
    if (e0 < kn) {
      const int4 v = __ldg(reinterpret_cast<const int4*>(idx + e0));
      i[0] = v.x;
      i[1] = v.y;
      i[2] = v.z;
      i[3] = v.w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < kLanes; ++j) {
      const Off e = pim_gather::lane<false>(tile, j);
      if (e < kn) i[j] = __ldg(idx + e);
    }
  }
#pragma unroll
  for (int j = 0; j < kLanes; ++j) {
    col[j] = static_cast<Off>(i[j] < 0 ? 0 : (i[j] > t - 1 ? t - 1 : i[j]));
  }
}

// Stores the four queries' values v of one channel row `dst`.
template <typename Off, bool kVec>
__device__ __forceinline__ void store_queries(float* __restrict__ dst, Off tile, Off kn,
                                              const float (&v)[kLanes]) {
  if (kVec) {
    const Off e0 = pim_gather::lane<true>(tile, 0);
    if (e0 < kn) {
      *reinterpret_cast<float4*>(dst + e0) = make_float4(v[0], v[1], v[2], v[3]);
    }
  } else {
#pragma unroll
    for (int j = 0; j < kLanes; ++j) {
      const Off e = pim_gather::lane<false>(tile, j);
      if (e < kn) dst[e] = v[j];
    }
  }
}

template <typename Off, bool kStaged, bool kVec>
__global__ void __launch_bounds__(kThreads)
gather_texels_kernel(const float* __restrict__ planes, int c, int t,
                     const int32_t* __restrict__ idx, long long kn_ll, float* __restrict__ out) {
  extern __shared__ float4 stage4[];
  const Off kn = static_cast<Off>(kn_ll);
  const float* tab = planes;
  if constexpr (kStaged) {
    float* stage = reinterpret_cast<float*>(stage4);
    pim_gather::stage(planes, c * t, stage);
    __syncthreads();
    tab = stage;
  }
  const Off tiles = (kn + kTileLanes - 1) / kTileLanes;
  for (Off tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    Off col[kLanes];
    load_texels<Off, kVec>(idx, tile, kn, t, col);
    if constexpr (kStaged) {
      for (int c0 = 0; c0 < c; c0 += 4) {
        float v[4][kLanes];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          if (c0 + q < c) {
            const float* plane = tab + static_cast<Off>(c0 + q) * t;
#pragma unroll
            for (int j = 0; j < kLanes; ++j) {
              v[q][j] = plane[col[j]];
            }
          }
        }
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          if (c0 + q < c) {
            store_queries<Off, kVec>(out + static_cast<Off>(c0 + q) * kn, tile, kn, v[q]);
          }
        }
      }
    } else {
      // one plane per block row: an SM's cache then holds one plane, not C
      const float* plane = tab + static_cast<Off>(blockIdx.y) * t;
      float v[kLanes];
#pragma unroll
      for (int j = 0; j < kLanes; ++j) {
        v[j] = __ldg(plane + col[j]);
      }
      store_queries<Off, kVec>(out + static_cast<Off>(blockIdx.y) * kn, tile, kn, v);
    }
  }
}

template <typename Off, bool kStaged, bool kVec>
int launch_texels(const float* planes, int c, int t, const int32_t* idx, long long kn,
                  float* out, cudaStream_t stream) {
  const long long tiles = (kn + kTileLanes - 1) / kTileLanes;
  const size_t smem = kStaged ? sizeof(float) * c * t : 0;
  auto kernel = gather_texels_kernel<Off, kStaged, kVec>;
  if (const int rc = pim_gather::allow_smem(kernel, smem)) {
    return rc;
  }
  const dim3 grid(kStaged ? pim_gather::staged_blocks(tiles, 1, smem)
                          : pim_gather::direct_blocks(tiles),
                  kStaged ? 1 : c);
  kernel<<<grid, kThreads, smem, stream>>>(planes, c, t, idx, kn, out);
  return static_cast<int>(cudaGetLastError());
}

__global__ void __launch_bounds__(kThreads)
gather_texels_bwd_kernel(const float* __restrict__ g, int c, int t,
                         const int32_t* __restrict__ idx, long long kn,
                         float* __restrict__ grad) {
  const long long e = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (e >= kn) {
    return;
  }
  const long long i = clamp_index(idx[e], t);
  for (int ch = 0; ch < c; ++ch) {
    atomicAdd(grad + ch * static_cast<long long>(t) + i, g[ch * kn + e]);
  }
}

}  // namespace

extern "C" {

// staged: the planes in shared memory; wide: 64-bit offsets; vec: 16-byte
// index loads and output stores (K*N % 4 == 0, idx aligned).
int pim_gather_texels(const float* planes, int c, int t, const int32_t* idx, long long kn,
                      float* out, int staged, int wide, int vec, void* stream_ptr) {
  const auto stream = static_cast<cudaStream_t>(stream_ptr);
  const int pick = (staged ? 4 : 0) | (wide ? 2 : 0) | (vec ? 1 : 0);
  switch (pick) {
    case 0: return launch_texels<int, false, false>(planes, c, t, idx, kn, out, stream);
    case 1: return launch_texels<int, false, true>(planes, c, t, idx, kn, out, stream);
    case 2: return launch_texels<long long, false, false>(planes, c, t, idx, kn, out, stream);
    case 3: return launch_texels<long long, false, true>(planes, c, t, idx, kn, out, stream);
    case 4: return launch_texels<int, true, false>(planes, c, t, idx, kn, out, stream);
    case 5: return launch_texels<int, true, true>(planes, c, t, idx, kn, out, stream);
    case 6: return launch_texels<long long, true, false>(planes, c, t, idx, kn, out, stream);
    default: return launch_texels<long long, true, true>(planes, c, t, idx, kn, out, stream);
  }
}

int pim_gather_texels_bwd(const float* g, int c, int t, const int32_t* idx, long long kn,
                          float* grad, void* stream) {
  const long long blocks = (kn + kThreads - 1) / kThreads;
  gather_texels_bwd_kernel<<<static_cast<unsigned int>(blocks), kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(g, c, t, idx, kn, grad);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
