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
// [F, N] gradient read and the index read (50 MB at [48, 262144]), the
// zeroed [F, T] sum written, and the atomics where many lanes share a
// column.  On the main path they do: a training step's tri-table calls send
// every miss lane to column 0 (clamp_min(tri, 0)), up to 258,213 of 262,144
// lanes, some thousands of them with a nonzero gradient; the material graft
// adds 81,552 lanes into 208 columns.
//
// What the design does about it: a thread owns four lanes, loads their
// indices once (16-byte loads where N % 4 == 0 and idx and g are aligned,
// else lanes kThreads apart, as gather_tiles.cuh does for the forward) and
// walks kRows rows of g (grid y), loading all of them before it adds.  The
// warp combines its adds into one column (add_group: __match_any_sync per
// slot, a tree of shuffles over a group), so a column takes at most one
// atomic a slot and a row from a warp, and none where its sum is 0, which
// leaves the column's sum as it is.  A sum of up to kStageMaxBytes (the
// graft, the emissive table, Cornell's tri table) is staged: the block adds
// into its rows in shared memory and adds each nonzero entry into the output
// once at the end, with a grid sized to residency.  A larger sum with F % 4
// == 0 (e1m1's tri table) is added into a row-major [T, F] buffer instead,
// whose transposed view the wrapper returns: four rows of one column are 16
// contiguous bytes there, so a group adds them with one float4 atomic (sm_90)
// where the [F, T] sum takes four scattered ones.  No integer division, and
// 32-bit offsets where F*N and F*T fit.  Measured (tools/fetch_variants.py
// --forms, NVIDIA H100 80GB HBM3, 700.00 W; PERF.md): the row-major
// sum took 0.34x the [F, T] one's time on random tri-table indices and 0.82x
// over a training step's tri-table calls; head flags between neighbour lanes
// in place of the groups (one segmented scan a row, combining only runs of
// neighbours) took 1.4x as long over a step's calls.  The order of the adds,
// and so the last bits of a column's sum, vary from run to run; every sum
// stays within gamma(adds - 1) * sum |g| of the exact one.

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

// ---- the backward: the column scatter-add ----------------------------------

constexpr unsigned kFull = 0xffffffffu;

// A warp's adds into one column, combined: a thread first sums its equal
// neighbouring slots into the last of them (any two lanes of one column may
// be summed together); then, slot by slot, the lanes that hold the same
// column across the warp form a group (__match_any_sync), a tree over the
// group in lane order sums it, and its lowest lane adds the sum unless it
// is 0.  Where no slot group of the warp has two lanes, the tree is skipped.
template <typename Off>
struct Group {
  Off key;     // the column this slot adds into, or -1
  int rank;    // position in the group, in lane order
  int src[5];  // the group's lane 2^k positions on, or -1
  bool tree;   // some group of the warp in this slot has two lanes or more
};

template <typename Off>
__device__ __forceinline__ void find_group(Group<Off>& p) {
  const int lane = threadIdx.x & 31;
  const unsigned peers = __match_any_sync(kFull, p.key);
  p.rank = __popc(peers & ((1u << lane) - 1u));
  const unsigned above = lane == 31 ? 0u : peers & ~((2u << lane) - 1u);
#pragma unroll
  for (int k = 0; k < 5; ++k) {
    unsigned m = above;
    for (int i = 1; i < (1 << k); ++i) m &= m - 1u;
    p.src[k] = m ? __ffs(m) - 1 : -1;
  }
  p.tree = __any_sync(kFull, p.key >= 0 && p.rank > 0);
}

template <typename Off>
__device__ __forceinline__ void add_group(float* row, const Group<Off>& p, float v) {
  if (p.tree) {
    const int lane = threadIdx.x & 31;
#pragma unroll
    for (int k = 0; k < 5; ++k) {
      const float y = __shfl_sync(kFull, v, p.src[k] >= 0 ? p.src[k] : lane);
      if (p.src[k] >= 0 && (p.rank & ((2 << k) - 1)) == 0) v += y;
    }
  }
  if (p.rank == 0 && p.key >= 0 && v != 0.0f) atomicAdd(row + p.key, v);
}

// The sum of four rows at once, for the row-major form: the same group,
// its tree over float4, its lowest lane adding with one 16-byte atomic.
template <typename Off>
__device__ __forceinline__ void add_group4(float* at, const Group<Off>& p, float4 v) {
  if (p.tree) {
    const int lane = threadIdx.x & 31;
#pragma unroll
    for (int k = 0; k < 5; ++k) {
      const int from = p.src[k] >= 0 ? p.src[k] : lane;
      const float4 y = make_float4(__shfl_sync(kFull, v.x, from), __shfl_sync(kFull, v.y, from),
                                   __shfl_sync(kFull, v.z, from), __shfl_sync(kFull, v.w, from));
      if (p.src[k] >= 0 && (p.rank & ((2 << k) - 1)) == 0) {
        v.x += y.x;
        v.y += y.y;
        v.z += y.z;
        v.w += y.w;
      }
    }
  }
  if (p.rank == 0 && p.key >= 0 &&
      (v.x != 0.0f || v.y != 0.0f || v.z != 0.0f || v.w != 0.0f)) {
    atomicAdd(reinterpret_cast<float4*>(at + p.key), v);
  }
}

// One lane tile of a backward block: the four lanes' gradients in `rows`
// rows from `src` (row stride n) and their groups (a thread's equal
// neighbouring slots are left to the last of them).
template <typename Index, typename Off, bool kVec>
__device__ __forceinline__ void load_tile(const float* __restrict__ src, const Index* __restrict__ idx,
                                          Off tile, Off n, int t, int rows,
                                          float (&v)[kRows][kLanes], Off (&key)[kLanes],
                                          Group<Off> (&p)[kLanes]) {
  Off col[kLanes];
  bool ok[kLanes];
  load_cols<Index, Off, kVec>(idx, tile, n, t, col, ok);
#pragma unroll
  for (int q = 0; q < kRows; ++q) {
    if (q < rows) {
      const float* row = src + static_cast<Off>(q) * n;
      if (kVec) {
        const Off r0 = pim_gather::lane<true>(tile, 0);
        const float4 w = r0 < n ? __ldg(reinterpret_cast<const float4*>(row + r0))
                                : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        v[q][0] = w.x;
        v[q][1] = w.y;
        v[q][2] = w.z;
        v[q][3] = w.w;
      } else {
#pragma unroll
        for (int j = 0; j < kLanes; ++j) {
          const Off r = pim_gather::lane<false>(tile, j);
          v[q][j] = r < n ? __ldg(row + r) : 0.0f;
        }
      }
    } else {
#pragma unroll
      for (int j = 0; j < kLanes; ++j) v[q][j] = 0.0f;
    }
  }
#pragma unroll
  for (int j = 0; j < kLanes; ++j) key[j] = ok[j] ? col[j] : static_cast<Off>(-1);
#pragma unroll
  for (int j = 0; j < kLanes; ++j) {
    p[j].key = j + 1 < kLanes && key[j + 1] == key[j] ? static_cast<Off>(-1) : key[j];
    find_group(p[j]);
  }
}

// grad[f, idx[r]] += g[f, r].  A block takes kRows rows of g (grid y) and
// walks lane tiles; a thread loads its four lanes' indices once, then their
// values row by row, and the warp combines its adds (add_group).  kStaged:
// the block adds into its rows of grad held in shared memory and adds each
// nonzero entry into grad at the end.
template <typename Index, typename Off, bool kStaged, bool kVec>
__global__ void __launch_bounds__(kThreads)
gather_cols_bwd_kernel(const float* __restrict__ g, int f, int t, const Index* __restrict__ idx,
                       long long n_ll, float* __restrict__ grad) {
  extern __shared__ float4 stage4[];
  const Off n = static_cast<Off>(n_ll);
  const int f0 = blockIdx.y * kRows;
  const int rows = min(kRows, f - f0);
  float* out = grad + static_cast<Off>(f0) * t;
  if constexpr (kStaged) {
    float* stage = reinterpret_cast<float*>(stage4);
    for (int e = threadIdx.x; e < rows * t; e += kThreads) stage[e] = 0.0f;
    __syncthreads();
    out = stage;
  }
  const float* src = g + static_cast<Off>(f0) * n;
  const Off tiles = (n + kTileLanes - 1) / kTileLanes;
  for (Off tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    float v[kRows][kLanes];
    Off key[kLanes];
    Group<Off> p[kLanes];
    load_tile<Index, Off, kVec>(src, idx, tile, n, t, rows, v, key, p);
#pragma unroll
    for (int q = 0; q < kRows; ++q) {
      if (q < rows) {
#pragma unroll
        for (int j = 1; j < kLanes; ++j) {
          if (key[j] == key[j - 1]) v[q][j] += v[q][j - 1];
        }
#pragma unroll
        for (int j = 0; j < kLanes; ++j) add_group(out + static_cast<Off>(q) * t, p[j], v[q][j]);
      }
    }
  }
  if constexpr (kStaged) {
    __syncthreads();
    float* dst = grad + static_cast<Off>(f0) * t;
    for (int e = threadIdx.x; e < rows * t; e += kThreads) {
      const float s = out[e];
      if (s != 0.0f) atomicAdd(dst + e, s);
    }
  }
}

// The same sum into a row-major [T, F] buffer, F % 4 == 0 (for a sum too
// large to stage): a lane's four rows q..q+3 of one column are 16
// contiguous bytes there, so a group adds them with one float4 atomic
// (sm_90) instead of four scattered ones.  The wrapper transposes the
// buffer into [F, T].
template <typename Index, typename Off, bool kVec>
__global__ void __launch_bounds__(kThreads)
gather_cols_bwd_rows_kernel(const float* __restrict__ g, int f, int t,
                            const Index* __restrict__ idx, long long n_ll,
                            float* __restrict__ sum_tf) {
  const Off n = static_cast<Off>(n_ll);
  const int f0 = blockIdx.y * kRows;
  const int rows = min(kRows, f - f0);  // a multiple of 4
  const float* src = g + static_cast<Off>(f0) * n;
  const Off tiles = (n + kTileLanes - 1) / kTileLanes;
  for (Off tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    float v[kRows][kLanes];
    Off key[kLanes];
    Group<Off> p[kLanes];
    load_tile<Index, Off, kVec>(src, idx, tile, n, t, rows, v, key, p);
#pragma unroll
    for (int h = 0; h < kRows / 4; ++h) {
      if (4 * h < rows) {
        float4 w[kLanes];
#pragma unroll
        for (int j = 0; j < kLanes; ++j) {
          w[j] = make_float4(v[4 * h][j], v[4 * h + 1][j], v[4 * h + 2][j], v[4 * h + 3][j]);
        }
#pragma unroll
        for (int j = 1; j < kLanes; ++j) {
          if (key[j] == key[j - 1]) {
            w[j].x += w[j - 1].x;
            w[j].y += w[j - 1].y;
            w[j].z += w[j - 1].z;
            w[j].w += w[j - 1].w;
          }
        }
        Group<Off> q[kLanes];
#pragma unroll
        for (int j = 0; j < kLanes; ++j) {
          q[j] = p[j];
          q[j].key = p[j].key >= 0 ? p[j].key * f : p[j].key;
          add_group4(sum_tf + f0 + 4 * h, q[j], w[j]);
        }
      }
    }
  }
}

template <typename Index, typename Off, bool kStaged, bool kVec>
int launch_bwd_as(const float* g, int f, int t, const Index* idx, long long n, float* grad,
                  cudaStream_t stream) {
  const long long tiles = (n + kTileLanes - 1) / kTileLanes;
  const int blocks_y = (f + kRows - 1) / kRows;
  const size_t smem = kStaged ? sizeof(float) * (f < kRows ? f : kRows) * t : 0;
  auto kernel = gather_cols_bwd_kernel<Index, Off, kStaged, kVec>;
  if (const int rc = pim_gather::allow_smem(kernel, smem)) {
    return rc;
  }
  const dim3 grid(kStaged ? pim_gather::staged_blocks(tiles, blocks_y, smem)
                          : pim_gather::direct_blocks(tiles),
                  blocks_y);
  kernel<<<grid, kThreads, smem, stream>>>(g, f, t, idx, n, grad);
  return static_cast<int>(cudaGetLastError());
}

// staged: grad's row slices summed in shared memory; wide: 64-bit offsets;
// vec: 16-byte index and gradient loads (N % 4 == 0, idx and g aligned).
template <typename Index, typename Off, bool kVec>
int launch_bwd_rows_as(const float* g, int f, int t, const Index* idx, long long n, float* sum_tf,
                       cudaStream_t stream) {
  const long long tiles = (n + kTileLanes - 1) / kTileLanes;
  const dim3 grid(pim_gather::direct_blocks(tiles), (f + kRows - 1) / kRows);
  gather_cols_bwd_rows_kernel<Index, Off, kVec><<<grid, kThreads, 0, stream>>>(g, f, t, idx, n,
                                                                             sum_tf);
  return static_cast<int>(cudaGetLastError());
}

template <typename Index>
int launch_bwd_rows(const float* g, int f, int t, const Index* idx, long long n, float* sum_tf,
                    int wide, int vec, void* stream_ptr) {
  const auto stream = static_cast<cudaStream_t>(stream_ptr);
  if (wide) {
    return vec ? launch_bwd_rows_as<Index, long long, true>(g, f, t, idx, n, sum_tf, stream)
               : launch_bwd_rows_as<Index, long long, false>(g, f, t, idx, n, sum_tf, stream);
  }
  return vec ? launch_bwd_rows_as<Index, int, true>(g, f, t, idx, n, sum_tf, stream)
             : launch_bwd_rows_as<Index, int, false>(g, f, t, idx, n, sum_tf, stream);
}

template <typename Index>
int launch_bwd(const float* g, int f, int t, const Index* idx, long long n, float* grad,
               int staged, int wide, int vec, void* stream_ptr) {
  const auto stream = static_cast<cudaStream_t>(stream_ptr);
  const int pick = (staged ? 4 : 0) | (wide ? 2 : 0) | (vec ? 1 : 0);
  switch (pick) {
    case 0: return launch_bwd_as<Index, int, false, false>(g, f, t, idx, n, grad, stream);
    case 1: return launch_bwd_as<Index, int, false, true>(g, f, t, idx, n, grad, stream);
    case 2: return launch_bwd_as<Index, long long, false, false>(g, f, t, idx, n, grad, stream);
    case 3: return launch_bwd_as<Index, long long, false, true>(g, f, t, idx, n, grad, stream);
    case 4: return launch_bwd_as<Index, int, true, false>(g, f, t, idx, n, grad, stream);
    case 5: return launch_bwd_as<Index, int, true, true>(g, f, t, idx, n, grad, stream);
    case 6: return launch_bwd_as<Index, long long, true, false>(g, f, t, idx, n, grad, stream);
    default: return launch_bwd_as<Index, long long, true, true>(g, f, t, idx, n, grad, stream);
  }
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
                            float* grad, int staged, int wide, int vec, void* stream) {
  return launch_bwd<int32_t>(g, f, t, idx, n, grad, staged, wide, vec, stream);
}

int pim_gather_cols_bwd_i64(const float* g, int f, int t, const int64_t* idx, long long n,
                            float* grad, int staged, int wide, int vec, void* stream) {
  return launch_bwd<int64_t>(g, f, t, idx, n, grad, staged, wide, vec, stream);
}

int pim_gather_cols_bwd_rows_i32(const float* g, int f, int t, const int32_t* idx, long long n,
                                 float* sum_tf, int wide, int vec, void* stream) {
  return launch_bwd_rows<int32_t>(g, f, t, idx, n, sum_tf, wide, vec, stream);
}

int pim_gather_cols_bwd_rows_i64(const float* g, int f, int t, const int64_t* idx, long long n,
                                 float* sum_tf, int wide, int vec, void* stream) {
  return launch_bwd_rows<int64_t>(g, f, t, idx, n, sum_tf, wide, vec, stream);
}

}  // extern "C"
