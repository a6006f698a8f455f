// The pcg4d hash of core/rng.py on uint32 words, the one device copy of
// the port's RNG: rng.cu (the seed and draw kernels), bsdf.cu (the BSDF's
// own draws) and media.cu (the marches' draws, and the fBm's cell hash, its
// first word) include it.
//
// The Python side carries each word as an int64 tensor holding a value in
// [0, 2^32) and forms every product from 16-bit halves; here a word is a
// uint32 in a register and the products wrap mod 2^32, which gives the
// same bits (a CUDA test holds them).

#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace pim_rng {

constexpr float kToFloat = 0x1p-24f;

// Jarzynski-Olano pcg4d (core/rng.py:_pcg4d_comps)
__device__ __forceinline__ void pcg4d(uint32_t& x, uint32_t& y, uint32_t& z, uint32_t& w) {
  x = x * 1664525u + 1013904223u;
  y = y * 1664525u + 1013904223u;
  z = z * 1664525u + 1013904223u;
  w = w * 1664525u + 1013904223u;
  x += y * w;
  y += z * x;
  z += x * y;
  w += y * z;
  x ^= x >> 16;
  y ^= y >> 16;
  z ^= z >> 16;
  w ^= w >> 16;
  x += y * w;
  y += z * x;
  z += x * y;
  w += y * z;
}

// an int64 word as the uint32 it holds (its low 32 bits: `& MASK32`)
__device__ __forceinline__ uint32_t word(const int64_t* w, long long e) {
  return static_cast<uint32_t>(__ldg(reinterpret_cast<const long long*>(w) + e));
}

// core/rng.py:to_float: the top 24 bits, exact in float32
__device__ __forceinline__ float to_float(uint32_t bits) {
  return static_cast<float>(bits >> 8) * kToFloat;
}

}  // namespace pim_rng
