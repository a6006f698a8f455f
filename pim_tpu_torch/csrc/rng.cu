// The per-ray RNG streams of core/rng.py for Hopper (sm_90a), one thread a
// lane: rng_seed (make_state: two pcg4d rounds over (pixel id, sample id,
// seed, 0xDEADBEEF)) and rng_draw (one pcg4d round on the four words, then
// up to four of the new words as floats in [0, 1)).
//
// Replaces: no TPU kernel.  XLA fuses the JAX package's core/rng.py into
// the ops around it; the port composed it of PyTorch ops on int64 words
// with every product split into 16-bit halves, about 130 launches a draw
// and 260 a seed, each dispatched by the host.  These kernels take their
// place on CUDA tensors; the composed version stays in core/rng.py for the
// CPU.
//
// What bounds it on this card: device memory.  A draw reads four int64
// words and writes four and its k floats: 64 + 4k bytes a lane (72 for a
// two-float draw, 18.9 MB at 262,144 lanes, about 5.6 us at 3.35 TB/s); a
// seed reads the id (8, and 8 for each key given as an [N] tensor) and
// writes 32.  The hash is 16 integer multiplies a round.
//
// What the design does about it: one thread a lane, each word row read and
// written by a warp as 256 contiguous bytes, the words as uint32 in
// registers; a sample id or seed given as a device tensor is read by the
// kernel, so the host neither copies nor waits.

#include <cuda_runtime.h>

#include <cstdint>

#include "rng.cuh"

namespace {

constexpr int kThreads = 256;
constexpr uint32_t kBeef = 0xDEADBEEFu;

using pim_rng::pcg4d;
using pim_rng::to_float;
using pim_rng::word;

// A key word of the seed: a constant, or an int32 / int64 device tensor
// read at lane * step (step 0: one value for every lane).
struct Key {
  const void* ptr;
  int bytes;
  int step;
  uint32_t value;
};

__device__ __forceinline__ uint32_t key_word(const Key& k, long long e) {
  if (k.ptr == nullptr) {
    return k.value;
  }
  const long long at = e * k.step;
  if (k.bytes == 8) {
    return static_cast<uint32_t>(__ldg(static_cast<const long long*>(k.ptr) + at));
  }
  return static_cast<uint32_t>(__ldg(static_cast<const int*>(k.ptr) + at));
}

__device__ __forceinline__ void store_words(int64_t* words, long long n, long long e, uint32_t x,
                                            uint32_t y, uint32_t z, uint32_t w) {
  words[e] = x;
  words[n + e] = y;
  words[2 * n + e] = z;
  words[3 * n + e] = w;
}

// words [4, N] int64
__global__ void __launch_bounds__(kThreads)
rng_seed_kernel(const int64_t* __restrict__ pix, long long n, Key sample, Key seed,
                int64_t* __restrict__ words) {
  const long long e = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (e >= n) {
    return;
  }
  uint32_t x = word(pix, e);
  uint32_t y = key_word(sample, e);
  uint32_t z = key_word(seed, e);
  uint32_t w = kBeef;
  pcg4d(x, y, z, w);
  pcg4d(x, y, z, w);
  store_words(words, n, e, x, y, z, w);
}

// words [4, N] int64; out [k, N] float32, the first k new words as floats
__global__ void __launch_bounds__(kThreads)
rng_draw_kernel(const int64_t* __restrict__ sx, const int64_t* __restrict__ sy,
                const int64_t* __restrict__ sz, const int64_t* __restrict__ sw, long long n,
                int k, int64_t* __restrict__ words, float* __restrict__ out) {
  const long long e = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (e >= n) {
    return;
  }
  uint32_t x = word(sx, e);
  uint32_t y = word(sy, e);
  uint32_t z = word(sz, e);
  uint32_t w = word(sw, e);
  pcg4d(x, y, z, w);
  store_words(words, n, e, x, y, z, w);
  if (k > 0) out[e] = to_float(x);
  if (k > 1) out[n + e] = to_float(y);
  if (k > 2) out[2 * n + e] = to_float(z);
  if (k > 3) out[3 * n + e] = to_float(w);
}

unsigned int blocks(long long n) {
  return static_cast<unsigned int>((n + kThreads - 1) / kThreads);
}

}  // namespace

extern "C" {

// pix [N] int64; each key a device pointer (null: `value` for every lane),
// its element size (4 or 8) and step (0 or 1); words [4, N] int64.
int pim_rng_seed(const int64_t* pix, long long n, const void* sample_ptr, int sample_bytes,
                 int sample_step, unsigned int sample_value, const void* seed_ptr,
                 int seed_bytes, int seed_step, unsigned int seed_value, int64_t* words,
                 void* stream_ptr) {
  const Key sample{sample_ptr, sample_bytes, sample_step, sample_value};
  const Key seed{seed_ptr, seed_bytes, seed_step, seed_value};
  rng_seed_kernel<<<blocks(n), kThreads, 0, static_cast<cudaStream_t>(stream_ptr)>>>(
      pix, n, sample, seed, words);
  return static_cast<int>(cudaGetLastError());
}

// x, y, z, w [N] int64; k in 0..4 (out may be null when k is 0).
int pim_rng_draw(const int64_t* x, const int64_t* y, const int64_t* z, const int64_t* w,
                 long long n, int k, int64_t* words, float* out, void* stream_ptr) {
  rng_draw_kernel<<<blocks(n), kThreads, 0, static_cast<cudaStream_t>(stream_ptr)>>>(
      x, y, z, w, n, k, words, out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
