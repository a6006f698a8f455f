// Filtered bilinear fetch from corner-resolved texel rows for Hopper
// (sm_90a): K6, out[ch, k, n] = w00 q00 + w10 q10 + w01 q01 + w11 q11, and 0
// where the query is invalid.
//
// Replaces: pim_tpu/render/table_gather.py:_bilinear_kernel, reached through
// gather_bilinear_pallas (the atlas fetch of surface.sample_atlas_bilinear_multi
// with C = 4, and the sky fetch of sky.sample_sky_cubemap_soa with C = 3).
//
// rows [T, 4C]: the texel-interleaved copy of the corner planes [4C, T] that
// the wrapper keeps (render/gather_kernel.py: table_rows), row i holding
// planes[corner * C + ch, i] in that order, corners 00, 10, 01, 11; each
// texel's neighbours are already clamped inside its own sub-texture (or cube
// face), so one index i00 per query names all four corners, and a query's
// 4C values are one row: 64 bytes for the atlas, 48 for the sky, read as C
// 16-byte loads.
//
// What bounds it on this card: the rows' L2 sectors.  The tables (the e1m1
// atlas, 32,768 texels x 64 bytes, 2 MB; the sky's 6,144 x 48 bytes) stay in
// L2, so device memory sees the queries' 13 bytes in and 4C bytes out; from
// the planes [4C, T] each query read 4C scattered 4-byte values from 4C
// sectors (16 sectors for 64 useful bytes on the atlas), which held the
// parent kernel at about 5 TB/s of L2 traffic.  From the rows a query reads
// two sectors.
//
// What the design does about it: the interleaved copy above, one query a
// thread (the index, weight and flag loads and each channel's store
// coalesce across the warp), and no row load for an invalid query.  Two
// other forms measured slower or no faster on the main path's queries
// (pim_tpu_torch/tools/fetch_variants.py --forms, NVIDIA H100 80GB HBM3,
// 700.00 W; PERF.md): four queries a thread with 16-byte index,
// weight, flag and output accesses (1.2x the time on the serving step's
// atlas calls), and a bf16 copy of the atlas rows, 32 bytes a query (0.8%
// less there, 30% less on random queries).
//
// Exactness: --fmad=false; the weights are the sanitized ones of
// table_gather.py:200-209 and the sum runs left to right, as the reference
// and gather_bilinear_plain do, so the result is bit for bit the plain
// version's.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;

template <int C>
__global__ void __launch_bounds__(kThreads)
gather_bilinear_kernel(const float* __restrict__ rows, int t, const int32_t* __restrict__ idx,
                       const float* __restrict__ tx, const float* __restrict__ ty,
                       const uint8_t* __restrict__ valid, long long kn, float* __restrict__ out) {
  const long long e = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (e >= kn) {
    return;
  }
  if (valid[e] == 0) {
#pragma unroll
    for (int ch = 0; ch < C; ++ch) out[ch * kn + e] = 0.0f;
    return;
  }
  const float txv = __ldg(tx + e);
  const float tyv = __ldg(ty + e);
  const float w00 = (1.0f - txv) * (1.0f - tyv);
  const float w10 = txv * (1.0f - tyv);
  const float w01 = (1.0f - txv) * tyv;
  const float w11 = txv * tyv;
  int i = __ldg(idx + e);
  i = i < 0 ? 0 : (i > t - 1 ? t - 1 : i);
  float q[4 * C];
  const float4* row = reinterpret_cast<const float4*>(rows) + static_cast<long long>(i) * C;
#pragma unroll
  for (int k = 0; k < C; ++k) {
    const float4 v = __ldg(row + k);
    q[4 * k] = v.x;
    q[4 * k + 1] = v.y;
    q[4 * k + 2] = v.z;
    q[4 * k + 3] = v.w;
  }
#pragma unroll
  for (int ch = 0; ch < C; ++ch) {
    out[ch * kn + e] = w00 * q[ch] + w10 * q[C + ch] + w01 * q[2 * C + ch] + w11 * q[3 * C + ch];
  }
}

template <int C>
int launch(const float* rows, int t, const int32_t* idx, const float* tx, const float* ty,
           const uint8_t* valid, long long kn, float* out, cudaStream_t stream) {
  const long long blocks = (kn + kThreads - 1) / kThreads;
  gather_bilinear_kernel<C><<<static_cast<unsigned int>(blocks), kThreads, 0, stream>>>(
      rows, t, idx, tx, ty, valid, kn, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// rows [T, 4C] f32; C is 3 or 4, any other value returns
// cudaErrorInvalidValue.
int pim_gather_bilinear(const float* rows, int c, int t, const int32_t* idx, const float* tx,
                        const float* ty, const uint8_t* valid, long long kn, float* out,
                        void* stream_ptr) {
  const auto stream = static_cast<cudaStream_t>(stream_ptr);
  if (c == 4) {
    return launch<4>(rows, t, idx, tx, ty, valid, kn, out, stream);
  }
  if (c == 3) {
    return launch<3>(rows, t, idx, tx, ty, valid, kn, out, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
