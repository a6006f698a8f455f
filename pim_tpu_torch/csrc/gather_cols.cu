// Column gather for Hopper (sm_90a): K3, out[f, r] = table[f, idx[r]], and 0
// where idx[r] lies outside [0, T); and its backward, the column scatter-add
// grad[f, idx[r]] += g[f, r] over the lanes with idx[r] inside [0, T).
//
// Replaces: pim_tpu/render/gather_kernel.py:_gather_kernel, reached through
// gather_cols_pallas and fetch.fetch_cols (every per-hit attribute, light-
// table and emissive-table fetch).
//
// What bounds it on this card: device-memory bytes, the [F, N] float32
// output write (50 MB for the [48, 262144] attribute fetch) plus the index
// read, and, for a table that does not fit in shared memory, the L2 sectors
// of its scattered reads: in the [F, T] layout a lane's F values lie in F
// different 32-byte sectors, so random indices into the e1m1 tri table
// (15.7 MB, held in L2) cost about 400 MB of sector traffic for 50 MB out.
//
// What the design does about it (gather_tiles.cuh): a block writes kRows
// rows of the output for a tile of 1,024 lanes, and a thread owns four of
// those lanes.  It loads their indices once (one 16-byte load where N is a
// multiple of 4 and the pointer is aligned), checks their range once, then
// walks its rows, loading the row's four values before any store, and
// writes out[f, r:r+4] with one 16-byte store a row (a scalar path with
// coalesced 4-byte accesses takes any other N).  The grid's second axis is
// the row group, so enough blocks are in flight at N = 262,144.  No integer
// division, and 32-bit offsets whenever F*N and F*T fit: the 64-bit form
// took 1.22x as long on random e1m1 tri-table indices and 1.17x on the
// light table's (pim_tpu_torch/tools/gather_variants.py, NVIDIA H100 80GB
// HBM3, 700.00 W).  A table of up to kStageMaxBytes (the Cornell tri and
// light tables, the emissive table, the texture records) is staged: each
// block copies its row group's slice into shared memory once, with 16-byte
// loads, walks tiles from there, and the grid holds no more blocks than
// stay resident.  Larger tables are read
// directly through the read-only cache, or, when F is a multiple of 4, by
// gather_cols_rows_kernel from a row-major [T, F] copy of the table that the
// wrapper keeps beside it: a lane's values in a row group are then two
// 16-byte loads from one 32-byte sector instead of 8 scattered ones.
// Values move as plain 32-bit loads and stores, so the gather is exact by
// construction: the TPU kernel's bf16 three-way split, domain gate and size
// thresholds have no counterpart here.
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

#include "gather_tiles.cuh"

namespace {

using pim_gather::kLanes;
using pim_gather::kThreads;
using pim_gather::kTileLanes;

constexpr int kRows = 8;  // output rows a block writes

template <typename Index>
__device__ __forceinline__ Index load_index(const Index* p) {
  if constexpr (sizeof(Index) == 4) {
    return static_cast<Index>(__ldg(reinterpret_cast<const int*>(p)));
  } else {
    return static_cast<Index>(__ldg(reinterpret_cast<const long long*>(p)));
  }
}

// The four lanes' column offsets and range flags for this thread in `tile`.
template <typename Index, typename Off, bool kVec>
__device__ __forceinline__ void load_cols(const Index* __restrict__ idx, Off tile, Off n, int t,
                                          Off (&col)[kLanes], bool (&ok)[kLanes]) {
  Index i[kLanes];
  if (kVec) {
    const Off r0 = pim_gather::lane<true>(tile, 0);
    if (r0 < n) {
      if constexpr (sizeof(Index) == 4) {
        const int4 v = __ldg(reinterpret_cast<const int4*>(idx + r0));
        i[0] = v.x;
        i[1] = v.y;
        i[2] = v.z;
        i[3] = v.w;
      } else {
        const longlong2 a = __ldg(reinterpret_cast<const longlong2*>(idx + r0));
        const longlong2 b = __ldg(reinterpret_cast<const longlong2*>(idx + r0) + 1);
        i[0] = a.x;
        i[1] = a.y;
        i[2] = b.x;
        i[3] = b.y;
      }
    } else {
#pragma unroll
      for (int j = 0; j < kLanes; ++j) i[j] = -1;
    }
  } else {
#pragma unroll
    for (int j = 0; j < kLanes; ++j) {
      const Off r = pim_gather::lane<false>(tile, j);
      i[j] = r < n ? load_index(idx + r) : static_cast<Index>(-1);
    }
  }
#pragma unroll
  for (int j = 0; j < kLanes; ++j) {
    ok[j] = i[j] >= 0 && i[j] < t;
    col[j] = ok[j] ? static_cast<Off>(i[j]) : 0;
  }
}

// Stores the four lanes' values v of one output row `dst`.
template <typename Off, bool kVec>
__device__ __forceinline__ void store_lanes(float* __restrict__ dst, Off tile, Off n,
                                            const float (&v)[kLanes]) {
  if (kVec) {
    const Off r0 = pim_gather::lane<true>(tile, 0);
    if (r0 < n) {
      *reinterpret_cast<float4*>(dst + r0) = make_float4(v[0], v[1], v[2], v[3]);
    }
  } else {
#pragma unroll
    for (int j = 0; j < kLanes; ++j) {
      const Off r = pim_gather::lane<false>(tile, j);
      if (r < n) dst[r] = v[j];
    }
  }
}

template <typename Index, typename Off, bool kStaged, bool kVec>
__global__ void __launch_bounds__(kThreads)
gather_cols_kernel(const float* __restrict__ table, int f, int t, const Index* __restrict__ idx,
                   long long n_ll, float* __restrict__ out) {
  extern __shared__ float4 stage4[];
  const Off n = static_cast<Off>(n_ll);
  const int f0 = blockIdx.y * kRows;
  const int rows = min(kRows, f - f0);
  const float* src = table + static_cast<Off>(f0) * t;
  const float* tab = src;
  if constexpr (kStaged) {
    float* stage = reinterpret_cast<float*>(stage4);
    pim_gather::stage(src, rows * t, stage);
    __syncthreads();
    tab = stage;
  }
  const Off tiles = (n + kTileLanes - 1) / kTileLanes;
  for (Off tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    Off col[kLanes];
    bool ok[kLanes];
    load_cols<Index, Off, kVec>(idx, tile, n, t, col, ok);
    float v[kRows][kLanes];
#pragma unroll
    for (int q = 0; q < kRows; ++q) {
      if (q < rows) {
        const float* row = tab + static_cast<Off>(q) * t;
#pragma unroll
        for (int j = 0; j < kLanes; ++j) {
          if constexpr (kStaged) {
            v[q][j] = ok[j] ? row[col[j]] : 0.0f;
          } else {
            v[q][j] = ok[j] ? __ldg(row + col[j]) : 0.0f;
          }
        }
      }
    }
#pragma unroll
    for (int q = 0; q < kRows; ++q) {
      if (q < rows) {
        store_lanes<Off, kVec>(out + static_cast<Off>(f0 + q) * n, tile, n, v[q]);
      }
    }
  }
}

// The same gather from a row-major [T, F] copy of the table, F % 4 == 0.
template <typename Index, typename Off, bool kVec>
__global__ void __launch_bounds__(kThreads)
gather_cols_rows_kernel(const float* __restrict__ rows_tf, int f, int t,
                        const Index* __restrict__ idx, long long n_ll, float* __restrict__ out) {
  const Off n = static_cast<Off>(n_ll);
  const int f0 = blockIdx.y * kRows;
  const int rows = min(kRows, f - f0);  // a multiple of 4
  const Off tiles = (n + kTileLanes - 1) / kTileLanes;
  for (Off tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    Off col[kLanes];
    bool ok[kLanes];
    load_cols<Index, Off, kVec>(idx, tile, n, t, col, ok);
    float4 v[kRows / 4][kLanes];
#pragma unroll
    for (int h = 0; h < kRows / 4; ++h) {
      if (4 * h < rows) {
#pragma unroll
        for (int j = 0; j < kLanes; ++j) {
          v[h][j] = ok[j] ? __ldg(reinterpret_cast<const float4*>(
                                rows_tf + col[j] * f + f0 + 4 * h))
                          : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        }
      }
    }
#pragma unroll
    for (int h = 0; h < kRows / 4; ++h) {
      if (4 * h < rows) {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const float w[kLanes] = {pim_gather::component(v[h][0], c),
                                   pim_gather::component(v[h][1], c),
                                   pim_gather::component(v[h][2], c),
                                   pim_gather::component(v[h][3], c)};
          store_lanes<Off, kVec>(out + static_cast<Off>(f0 + 4 * h + c) * n, tile, n, w);
        }
      }
    }
  }
}

template <typename Index, typename Off, bool kStaged, bool kVec>
int launch_cols(const float* table, int f, int t, const Index* idx, long long n, float* out,
                cudaStream_t stream) {
  const long long tiles = (n + kTileLanes - 1) / kTileLanes;
  const int blocks_y = (f + kRows - 1) / kRows;
  const size_t smem = kStaged ? sizeof(float) * (f < kRows ? f : kRows) * t : 0;
  auto kernel = gather_cols_kernel<Index, Off, kStaged, kVec>;
  if (const int rc = pim_gather::allow_smem(kernel, smem)) {
    return rc;
  }
  const dim3 grid(kStaged ? pim_gather::staged_blocks(tiles, blocks_y, smem)
                          : pim_gather::direct_blocks(tiles),
                  blocks_y);
  kernel<<<grid, kThreads, smem, stream>>>(table, f, t, idx, n, out);
  return static_cast<int>(cudaGetLastError());
}

// staged: the table's row slices in shared memory; wide: 64-bit offsets;
// vec: 16-byte index loads and output stores (N % 4 == 0, idx aligned).
template <typename Index>
int launch(const float* table, int f, int t, const Index* idx, long long n, float* out,
           int staged, int wide, int vec, void* stream_ptr) {
  const auto stream = static_cast<cudaStream_t>(stream_ptr);
  const int pick = (staged ? 4 : 0) | (wide ? 2 : 0) | (vec ? 1 : 0);
  switch (pick) {
    case 0: return launch_cols<Index, int, false, false>(table, f, t, idx, n, out, stream);
    case 1: return launch_cols<Index, int, false, true>(table, f, t, idx, n, out, stream);
    case 2: return launch_cols<Index, long long, false, false>(table, f, t, idx, n, out, stream);
    case 3: return launch_cols<Index, long long, false, true>(table, f, t, idx, n, out, stream);
    case 4: return launch_cols<Index, int, true, false>(table, f, t, idx, n, out, stream);
    case 5: return launch_cols<Index, int, true, true>(table, f, t, idx, n, out, stream);
    case 6: return launch_cols<Index, long long, true, false>(table, f, t, idx, n, out, stream);
    default: return launch_cols<Index, long long, true, true>(table, f, t, idx, n, out, stream);
  }
}

template <typename Index, typename Off, bool kVec>
int launch_rows_as(const float* rows_tf, int f, int t, const Index* idx, long long n, float* out,
                   cudaStream_t stream) {
  const long long tiles = (n + kTileLanes - 1) / kTileLanes;
  const dim3 grid(pim_gather::direct_blocks(tiles), (f + kRows - 1) / kRows);
  gather_cols_rows_kernel<Index, Off, kVec><<<grid, kThreads, 0, stream>>>(rows_tf, f, t, idx,
                                                                           n, out);
  return static_cast<int>(cudaGetLastError());
}

template <typename Index>
int launch_rows(const float* rows_tf, int f, int t, const Index* idx, long long n, float* out,
                int wide, int vec, void* stream_ptr) {
  const auto stream = static_cast<cudaStream_t>(stream_ptr);
  if (wide) {
    return vec ? launch_rows_as<Index, long long, true>(rows_tf, f, t, idx, n, out, stream)
               : launch_rows_as<Index, long long, false>(rows_tf, f, t, idx, n, out, stream);
  }
  return vec ? launch_rows_as<Index, int, true>(rows_tf, f, t, idx, n, out, stream)
             : launch_rows_as<Index, int, false>(rows_tf, f, t, idx, n, out, stream);
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
                        float* out, int staged, int wide, int vec, void* stream) {
  return launch<int32_t>(table, f, t, idx, n, out, staged, wide, vec, stream);
}

int pim_gather_cols_i64(const float* table, int f, int t, const int64_t* idx, long long n,
                        float* out, int staged, int wide, int vec, void* stream) {
  return launch<int64_t>(table, f, t, idx, n, out, staged, wide, vec, stream);
}

int pim_gather_cols_rows_i32(const float* rows_tf, int f, int t, const int32_t* idx, long long n,
                             float* out, int wide, int vec, void* stream) {
  return launch_rows<int32_t>(rows_tf, f, t, idx, n, out, wide, vec, stream);
}

int pim_gather_cols_rows_i64(const float* rows_tf, int f, int t, const int64_t* idx, long long n,
                             float* out, int wide, int vec, void* stream) {
  return launch_rows<int64_t>(rows_tf, f, t, idx, n, out, wide, vec, stream);
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
