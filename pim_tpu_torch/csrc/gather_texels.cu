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
// What bounds it on this card: device-memory bytes and gather latency.  The
// forward reads K*N indices and writes C*K*N floats (an e1m1 fetch of
// K = 12 sets at 262,144 lanes: 12.6 MB of indices, 50 MB written); the
// planes (512 KiB for the e1m1 atlas, 72 KiB for a 32^2 sky) stay in L2.
// The backward reads the same indices and the C*K*N gradient and adds into
// the [C, T] planes' gradient, whose columns many lanes share.
//
// What the design does about it: one thread per (k, n) query, n the fast
// index, so index loads and output stores (or gradient loads) coalesce;
// each thread moves its C channels.  The forward reads the planes through
// the read-only cache as plain f32, so it is exact: the TPU kernel's
// one-hot MXU contraction and its bf16 split (parts = 1, 2, 3) exist only
// because the MXU multiplies bf16.  The backward adds with float
// atomicAdd into a zeroed output that the wrapper allocates, so the last
// bits of a texel's gradient vary from run to run with the order of adds.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ long long clamp_index(int32_t i, int t) {
  return static_cast<long long>(i < 0 ? 0 : (i > t - 1 ? t - 1 : i));
}

__global__ void __launch_bounds__(kThreads)
gather_texels_kernel(const float* __restrict__ planes, int c, int t,
                     const int32_t* __restrict__ idx, long long kn, float* __restrict__ out) {
  const long long e = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (e >= kn) {
    return;
  }
  const long long i = clamp_index(idx[e], t);
  for (int ch = 0; ch < c; ++ch) {
    out[ch * kn + e] = __ldg(planes + ch * static_cast<long long>(t) + i);
  }
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

int pim_gather_texels(const float* planes, int c, int t, const int32_t* idx, long long kn,
                      float* out, void* stream) {
  const long long blocks = (kn + kThreads - 1) / kThreads;
  gather_texels_kernel<<<static_cast<unsigned int>(blocks), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(planes, c, t, idx, kn, out);
  return static_cast<int>(cudaGetLastError());
}

int pim_gather_texels_bwd(const float* g, int c, int t, const int32_t* idx, long long kn,
                          float* grad, void* stream) {
  const long long blocks = (kn + kThreads - 1) / kThreads;
  gather_texels_bwd_kernel<<<static_cast<unsigned int>(blocks), kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(g, c, t, idx, kn, grad);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
