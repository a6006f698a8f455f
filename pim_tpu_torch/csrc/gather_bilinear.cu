// Filtered bilinear fetch from corner-resolved planes for Hopper (sm_90a):
// K6, out[ch, k, n] = w00 q00 + w10 q10 + w01 q01 + w11 q11, and 0 where the
// query is invalid.
//
// Replaces: pim_tpu/render/table_gather.py:_bilinear_kernel, reached through
// gather_bilinear_pallas (the atlas fetch of surface.sample_atlas_bilinear_multi
// with C = 4, and the sky fetch of sky.sample_sky_cubemap_soa with C = 3).
//
// planes [4C, T]: row corner * C + ch, corners in the order 00, 10, 01, 11,
// each texel's neighbours already clamped inside its own sub-texture (or
// cube face), so one index i00 per query names all four corners.
//
// What bounds it on this card: device-memory bytes and gather latency.  A
// query reads its index, two weights and a flag (13 bytes) and 4C scattered
// texels, and writes C floats; the tables (the e1m1 atlas corner planes,
// 16 x 32,768 floats, 2 MB; the sky's 12 x 6,144) stay in L2.
//
// What the design does about it: one thread per (query, lane), lanes the
// fast index, so the index, weight and flag loads and the output stores
// coalesce; texels come through the read-only cache.  The TPU's one-hot MXU
// contraction and its bf16 split are gone: texels are read as plain f32, so
// the atlas result is bitwise the TPU kernel's (texels are snapped to bf16 at
// import) and the sky result is exact where the TPU's parts=2 keeps 16
// mantissa bits.
//
// Exactness: --fmad=false; the weights are the sanitized ones of
// table_gather.py:200-209 and the sum runs left to right, as the reference.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
gather_bilinear_kernel(const float* __restrict__ planes, int c, int t,
                       const int32_t* __restrict__ idx, const float* __restrict__ tx,
                       const float* __restrict__ ty, const uint8_t* __restrict__ valid,
                       long long kn, float* __restrict__ out) {
  const long long e = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (e >= kn) {
    return;
  }
  const bool v = valid[e] != 0;
  if (!v) {
    for (int ch = 0; ch < c; ++ch) {
      out[ch * kn + e] = 0.0f;
    }
    return;
  }
  const float txv = tx[e];
  const float tyv = ty[e];
  const float w00 = (1.0f - txv) * (1.0f - tyv);
  const float w10 = txv * (1.0f - tyv);
  const float w01 = (1.0f - txv) * tyv;
  const float w11 = txv * tyv;
  int i = idx[e];
  i = i < 0 ? 0 : (i > t - 1 ? t - 1 : i);
  const long long tt = t;
  for (int ch = 0; ch < c; ++ch) {
    const float q00 = __ldg(planes + (0LL * c + ch) * tt + i);
    const float q10 = __ldg(planes + (1LL * c + ch) * tt + i);
    const float q01 = __ldg(planes + (2LL * c + ch) * tt + i);
    const float q11 = __ldg(planes + (3LL * c + ch) * tt + i);
    out[ch * kn + e] = w00 * q00 + w10 * q10 + w01 * q01 + w11 * q11;
  }
}

}  // namespace

extern "C" {

int pim_gather_bilinear(const float* planes, int c, int t, const int32_t* idx, const float* tx,
                        const float* ty, const uint8_t* valid, long long kn, float* out,
                        void* stream) {
  const long long blocks = (kn + kThreads - 1) / kThreads;
  gather_bilinear_kernel<<<static_cast<unsigned int>(blocks), kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(planes, c, t, idx, tx, ty, valid,
                                                                kn, out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
