// Pieces shared by the gather kernels K3 (gather_cols.cu) and K7
// (gather_texels.cu): the lane tile a block walks, staging a table slice in
// shared memory, and the launch geometry of a staged gather.
//
// A block of kThreads threads covers kTileLanes = 4 * kThreads lanes per
// tile; each thread owns four of them.  On the vector path (the lane count a
// multiple of 4 and the index pointer 16-byte aligned) they are four
// consecutive lanes, so a thread loads its indices and stores each output
// row with one 16-byte access; on the scalar path they are kThreads apart,
// so each of a warp's 4-byte loads and stores covers 128 contiguous bytes.

#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace pim_gather {

constexpr int kThreads = 256;
constexpr int kLanes = 4;
constexpr int kTileLanes = kThreads * kLanes;
// the most a block may stage: the wrappers stage a table up to this size
// (render/gather_kernel.py, render/table_gather.py: STAGE_MAX_BYTES)
constexpr int kStageMaxBytes = 200 * 1024;
// an SM's shared memory that its resident blocks can share (227 KB)
constexpr int kSmemPerSm = 232448;
constexpr int kBlocksPerSm = 8;  // 2048 resident threads / kThreads

// Lane j of this thread in lane tile `tile`.
template <bool kVec, typename Off>
__device__ __forceinline__ Off lane(Off tile, int j) {
  return kVec ? tile * kTileLanes + static_cast<Off>(threadIdx.x) * kLanes + j
              : tile * kTileLanes + static_cast<Off>(j) * kThreads + threadIdx.x;
}

// Copies src[0, count) into shared dst with the block's threads: 16-byte
// loads where src is 16-byte aligned, coalesced either way.
__device__ __forceinline__ void stage(const float* __restrict__ src, int count,
                                      float* __restrict__ dst) {
  int done = 0;
  if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    const int count4 = count >> 2;
    const float4* s4 = reinterpret_cast<const float4*>(src);
    float4* d4 = reinterpret_cast<float4*>(dst);
    for (int k = threadIdx.x; k < count4; k += kThreads) {
      d4[k] = __ldg(s4 + k);
    }
    done = count4 << 2;
  }
  for (int k = done + threadIdx.x; k < count; k += kThreads) {
    dst[k] = __ldg(src + k);
  }
}

__device__ __forceinline__ float component(const float4& v, int c) {
  return c == 0 ? v.x : (c == 1 ? v.y : (c == 2 ? v.z : v.w));
}

inline int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  return sms;
}

// grid.x of a staged launch: every block stages its slice once and walks
// tiles, so launch no more blocks than can be resident at once (`blocks_y`
// rows of blocks share the card).
inline unsigned int staged_blocks(long long tiles, int blocks_y, size_t smem_bytes) {
  const long long per_sm = smem_bytes == 0 ? kBlocksPerSm
      : (kSmemPerSm / static_cast<long long>(smem_bytes + 1024) < kBlocksPerSm
             ? kSmemPerSm / static_cast<long long>(smem_bytes + 1024) : kBlocksPerSm);
  long long blocks = (static_cast<long long>(sm_count()) * (per_sm > 0 ? per_sm : 1)
                      + blocks_y - 1) / blocks_y;
  if (blocks > tiles) blocks = tiles;
  return static_cast<unsigned int>(blocks > 0 ? blocks : 1);
}

// Dynamic shared memory past 48 KB must be allowed per kernel.
template <typename Kernel>
int allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) {
    return 0;
  }
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes)));
}

// grid.x of a direct launch: one block per tile (capped at the limit).
inline unsigned int direct_blocks(long long tiles) {
  return static_cast<unsigned int>(tiles < 0x7fffffffLL ? tiles : 0x7fffffffLL);
}

}  // namespace pim_gather
