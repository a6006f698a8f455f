// Column gather for Hopper (sm_90a): K3, out[f, r] = table[f, idx[r]], and 0
// where idx[r] lies outside [0, T); and its backward, the column scatter-add
// grad[f, idx[r]] += g[f, r] over the lanes with idx[r] inside [0, T).
//
// Replaces: pim_tpu/render/gather_kernel.py:_gather_kernel, reached through
// gather_cols_pallas and fetch.fetch_cols (every per-hit attribute, light-
// table and emissive-table fetch).
//
// What bounds it on this card: device-memory bytes.  The tables are small
// (the Cornell tri table is 48 x 108 floats, 20 KB; the light table 38 x 343)
// and stay in L1/L2, so a call costs its [F, N] float32 output write plus
// the index read: 50 MB written for the [48, 262144] attribute fetch.
//
// What the design does about it: one thread per output element with r as
// the fast index, so a warp's stores cover 128 contiguous bytes and the
// index loads coalesce too; the table is read through the read-only cache.
// The value moves as a plain 32-bit load and store, so the gather is exact
// by construction: the TPU kernel's bf16 three-way split, domain gate and
// size thresholds have no counterpart here.
//
// The backward replaces pim_tpu/render/fetch.py:_fetch_cols_pallas_bwd (the
// custom VJP of the same fetch, an XLA scatter-add).  What bounds it: the
// [F, N] gradient read and the index read (50 MB at [48, 262144]), plus the
// atomics' serialisation where many lanes share a column: the material
// graft of the differentiable path scatters 81,552 lanes into 208 columns.
// The design is the simplest one that is right: one thread per gradient
// element, r the fast index (coalesced reads), a float atomicAdd into the
// zeroed [F, T] output, which the wrapper allocates.  The order of the
// adds, and so the last bits of a column's sum, vary from run to run.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;

template <typename Index>
__global__ void __launch_bounds__(kThreads)
gather_cols_kernel(const float* __restrict__ table, int f, int t, const Index* __restrict__ idx,
                   long long n, float* __restrict__ out) {
  const long long e = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (e >= static_cast<long long>(f) * n) {
    return;
  }
  const long long row = e / n;
  const long long r = e - row * n;
  const long long i = static_cast<long long>(idx[r]);
  out[e] = (i >= 0 && i < t) ? __ldg(&table[row * t + i]) : 0.0f;
}

template <typename Index>
int launch(const float* table, int f, int t, const Index* idx, long long n, float* out,
           void* stream) {
  const long long total = static_cast<long long>(f) * n;
  const long long blocks = (total + kThreads - 1) / kThreads;
  gather_cols_kernel<Index><<<static_cast<unsigned int>(blocks), kThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(table, f, t, idx, n, out);
  return static_cast<int>(cudaGetLastError());
}

template <typename Index>
__global__ void __launch_bounds__(kThreads)
gather_cols_bwd_kernel(const float* __restrict__ g, int f, int t, const Index* __restrict__ idx,
                       long long n, float* __restrict__ grad) {
  const long long e = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (e >= static_cast<long long>(f) * n) {
    return;
  }
  const long long row = e / n;
  const long long r = e - row * n;
  const long long i = static_cast<long long>(idx[r]);
  if (i >= 0 && i < t) {
    atomicAdd(&grad[row * t + i], g[e]);
  }
}

template <typename Index>
int launch_bwd(const float* g, int f, int t, const Index* idx, long long n, float* grad,
               void* stream) {
  const long long total = static_cast<long long>(f) * n;
  const long long blocks = (total + kThreads - 1) / kThreads;
  gather_cols_bwd_kernel<Index><<<static_cast<unsigned int>(blocks), kThreads, 0,
                                  static_cast<cudaStream_t>(stream)>>>(g, f, t, idx, n, grad);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int pim_gather_cols_i32(const float* table, int f, int t, const int32_t* idx, long long n,
                        float* out, void* stream) {
  return launch<int32_t>(table, f, t, idx, n, out, stream);
}

int pim_gather_cols_i64(const float* table, int f, int t, const int64_t* idx, long long n,
                        float* out, void* stream) {
  return launch<int64_t>(table, f, t, idx, n, out, stream);
}

int pim_gather_cols_bwd_i32(const float* g, int f, int t, const int32_t* idx, long long n,
                            float* grad, void* stream) {
  return launch_bwd<int32_t>(g, f, t, idx, n, grad, stream);
}

int pim_gather_cols_bwd_i64(const float* g, int f, int t, const int64_t* idx, long long n,
                            float* grad, void* stream) {
  return launch_bwd<int64_t>(g, f, t, idx, n, grad, stream);
}

}  // extern "C"
