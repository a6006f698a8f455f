// The participating medium's marches for Hopper (sm_90a), one thread a
// lane: media_scatter (render/media.py: scatter_ray's 32-step null-scattering
// march and sample_phase_dir's 8 rejection tries, with the phase of the
// sampled direction and the march's outputs) and media_transmittance
// (calc_transmittance's 32-step ratio tracking, for the in-media NEE and the
// surface NEE's shadow rays).
//
// Replaces: no TPU kernel.  The JAX package leaves the marches to XLA
// (pim_tpu/render/media.py, fixed-trip lax.scans), which fuses them; the
// port composed them of PyTorch ops in Python loops: the fBm density hashes
// each of its 8 lattice corners on int64 words with every product split in
// 16-bit halves (about 40 launches a corner), so a scatter march is about
// 40,000 launches and a transmittance march about 17,000, each dispatched
// by the host.  These kernels take their place on CUDA tensors that carry
// no gradient; the composed version stays in render/media.py for the CPU
// and for autograd.
//
// What bounds it on this card: the arithmetic.  A lane reads its ray (24
// bytes), its segment length (4) and four int64 RNG words (32), and writes
// four new words and at most 13 floats and a flag: about 150 bytes, 39 MB
// at 262,144 lanes, 12 us at 3.35 TB/s.  It evaluates the density 32 times
// (8 pcg4d cell hashes and ~60 float operations an octave) and hashes 80
// pcg4d rounds of RNG: about 15,000 32-bit operations a lane, 60 us of the
// card's 67 TFLOP/s at 262,144 lanes.  Of that, the result needs far less:
// a lane's words, and the density only at the steps where the lane is still
// live (the fBm only where the point is in the band), and only on the lanes
// whose caller keeps the result (pimbench/metrics/media_roofline.py counts
// that work, from the plain form, with the tally below); the rest is the
// masked march's.
//
// What the design does about it: one thread a lane reading the SoA [N]
// tensors as they are (each field's load and store coalesces across the
// warp), the RNG words as uint32 in registers, the medium's constants as a
// kernel argument.  Lanes stay masked, never compacted, so every lane draws
// its words as the plain form does.  A density evaluation outside the
// noise band skips the fBm: there the plain form multiplies the band's
// density by 0, which gives +0 whatever the noise is, as long as the point
// is finite (a lane with a non-finite point evaluates it all).  Where the
// profiler asks, each lane also writes its tally: the steps at which it was
// live, and those whose point was in the band.
//
// Exactness: --fmad=false, and every expression in PyTorch's order of
// operations on CUDA, so the outputs are bit for bit the composed version's
// there: a tensor divided by a Python constant is a product with the
// constant's float32 reciprocal (formed on the host, as ATen's div_true
// does), torch.maximum and clamp pass a NaN through, torch.where selects,
// floorf, logf, sqrtf, sinf and cosf are the same libdevice calls, and a
// float's conversion to int32 is the same cvt.rzi.  The pcg4d on uint32
// words is rng.cuh's (shared with rng.cu and bsdf.cu); the noise's cell
// hash is its first word (math/noise.py:_pcg4_x).

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>
#include <cstring>

#include "rng.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kSteps = 32;        // render/media.py MEDIA_STEPS
constexpr int kPhaseTries = 8;    // PHASE_RETRIES
constexpr int kMaxOctaves = 16;   // render/media.py MAX_OCTAVES
constexpr uint32_t kNoiseSeed = 1u;  // fbm_gradient_noise3's seed: octave i hashes seed + i + 1

constexpr float kEps = 0x1.0c6f7ap-20f;    // 1e-6
constexpr float kEpsSq = 0x1.197998p-40f;  // 1e-12
constexpr float kTau = 0x1.921fb6p+2f;

using pim_rng::pcg4d;
using pim_rng::to_float;
using pim_rng::word;

// The medium's float32 constants, in render/media.py:kernel_constants'
// order (MEDIUM_FLOATS floats), then the octave count.
struct Medium {
  float c_mu[3];        // scattering, constant term
  float n_mu[3];        // scattering, noise band term
  float ext_scale;      // f32(1 + absorption)
  float noise_freq;
  float noise_height;
  float noise_range;
  float noise_scale;
  float rcp_scale;      // float32 reciprocal of f32(max(noise_scale, EPS))
  float rcp_majorant;
  float mie_a[3];       // mie_constants(phase_dir_a): k, 1 + g^2, 2 g
  float mie_b[3];       // mie_constants(phase_dir_b)
  float blend;
  float oct_freq[kMaxOctaves];  // each octave's frequency and amplitude,
  float oct_ampl[kMaxOctaves];  // rounded to float32 as fbm's loop rounds them
  int octaves;
};
constexpr int kMediumFloats = 20 + 2 * kMaxOctaves;

struct V {
  float x, y, z;
};

// torch.clamp / clamp_min with Python bounds: a NaN passes
__device__ __forceinline__ float clampf(float v, float lo, float hi) {
  return isnan(v) ? v : fminf(fmaxf(v, lo), hi);
}
__device__ __forceinline__ float clamp_min(float v, float lo) {
  return isnan(v) ? v : fmaxf(v, lo);
}
__device__ __forceinline__ float saturate(float v) { return clampf(v, 0.0f, 1.0f); }
// torch.maximum: a NaN on either side wins
__device__ __forceinline__ float maximum(float a, float b) {
  return isnan(a) ? a : (isnan(b) ? b : fmaxf(a, b));
}
// vec3.sqrt0: sqrt(max(x, 0))
__device__ __forceinline__ float sqrt0(float x) {
  return x > 0.0f ? sqrtf(x) : sqrtf(clamp_min(x, 0.0f));
}
__device__ __forceinline__ float dot(V a, V b) { return a.x * b.x + a.y * b.y + a.z * b.z; }
// ro + rd * t
__device__ __forceinline__ V along(V ro, V rd, float t) {
  return {ro.x + rd.x * t, ro.y + rd.y * t, ro.z + rd.z * t};
}

// --- math/noise.py

// signed unit-corner gradient of the lattice cell (ix, iy, iz), dotted
// with the offset (rx - ox, ry - oy, rz - oz)
__device__ __forceinline__ float corner(uint32_t ix, uint32_t iy, uint32_t iz, uint32_t seed,
                                        float rx, float ry, float rz) {
  uint32_t x = ix, y = iy, z = iz, w = seed;
  pcg4d(x, y, z, w);
  const float gx = (x & (1u << 31)) != 0u ? 1.0f : -1.0f;
  const float gy = (x & (1u << 30)) != 0u ? 1.0f : -1.0f;
  const float gz = (x & (1u << 29)) != 0u ? 1.0f : -1.0f;
  return gx * rx + gy * ry + gz * rz;
}

__device__ __forceinline__ float smoothstep(float t) { return t * t * (3.0f - 2.0f * t); }
__device__ __forceinline__ float lerp(float a, float b, float t) { return a + (b - a) * t; }

__device__ float gradient_noise3(float px, float py, float pz, uint32_t seed) {
  const float fx = floorf(px);
  const float fy = floorf(py);
  const float fz = floorf(pz);
  // .to(int32) (cvt.rzi: saturating, NaN to 0), then int64 and & MASK32
  const uint32_t ix = static_cast<uint32_t>(static_cast<int>(fx));
  const uint32_t iy = static_cast<uint32_t>(static_cast<int>(fy));
  const uint32_t iz = static_cast<uint32_t>(static_cast<int>(fz));
  const float rx = px - fx;
  const float ry = py - fy;
  const float rz = pz - fz;
  const float rx1 = rx - 1.0f;
  const float ry1 = ry - 1.0f;
  const float rz1 = rz - 1.0f;
  const float c000 = corner(ix, iy, iz, seed, rx, ry, rz);
  const float c001 = corner(ix, iy, iz + 1u, seed, rx, ry, rz1);
  const float c010 = corner(ix, iy + 1u, iz, seed, rx, ry1, rz);
  const float c011 = corner(ix, iy + 1u, iz + 1u, seed, rx, ry1, rz1);
  const float c100 = corner(ix + 1u, iy, iz, seed, rx1, ry, rz);
  const float c101 = corner(ix + 1u, iy, iz + 1u, seed, rx1, ry, rz1);
  const float c110 = corner(ix + 1u, iy + 1u, iz, seed, rx1, ry1, rz);
  const float c111 = corner(ix + 1u, iy + 1u, iz + 1u, seed, rx1, ry1, rz1);
  const float ux = smoothstep(rx);
  const float uy = smoothstep(ry);
  const float uz = smoothstep(rz);
  const float c00 = lerp(c000, c001, uz);
  const float c01 = lerp(c010, c011, uz);
  const float c10 = lerp(c100, c101, uz);
  const float c11 = lerp(c110, c111, uz);
  const float c0 = lerp(c00, c01, uy);
  const float c1 = lerp(c10, c11, uy);
  return lerp(c0, c1, ux);
}

// --- render/media.py

// media_sample: the scattering and extinction coefficients at p
__device__ __forceinline__ void media_sample(const Medium& m, V p, V& scat, V& ext) {
  const bool in_band = fabsf(p.y - m.noise_height) <= m.noise_range;
  float density = 0.0f;
  if (in_band || !(isfinite(p.x) && isfinite(p.y) && isfinite(p.z))) {
    const float qx = p.x * m.noise_freq;
    const float qy = p.y * m.noise_freq;
    const float qz = p.z * m.noise_freq;
    float total = 0.0f;
    for (int i = 0; i < m.octaves; ++i) {
      const float f = m.oct_freq[i];
      total = total + gradient_noise3(qx * f, qy * f, qz * f, kNoiseSeed + i + 1u) *
                          m.oct_ampl[i];
    }
    const float height = total * m.noise_scale + m.noise_height;
    const float dist = fabsf(p.y - height) * m.rcp_scale;
    density = saturate(1.0f - dist) * (in_band ? 1.0f : 0.0f);
  }
  scat = {m.c_mu[0] + m.n_mu[0] * density, m.c_mu[1] + m.n_mu[1] * density,
          m.c_mu[2] + m.n_mu[2] * density};
  ext = {scat.x * m.ext_scale, scat.y * m.ext_scale, scat.z * m.ext_scale};
}

// _attenuate: atten * (1 + ((1 - ext / majorant) - 1) * live)
__device__ __forceinline__ V attenuate(V a, V ext, float rcp_maj, float live) {
  return {a.x * (1.0f + ((1.0f - ext.x * rcp_maj) - 1.0f) * live),
          a.y * (1.0f + ((1.0f - ext.y * rcp_maj) - 1.0f) * live),
          a.z * (1.0f + ((1.0f - ext.z * rcp_maj) - 1.0f) * live)};
}

// sampling.sample_free_path
__device__ __forceinline__ float free_path(float xi, float mfp) {
  return -logf(clamp_min(1.0f - xi, kEps)) * mfp;
}

// sampling.mie_phase with mie_constants (k, a, b)
__device__ __forceinline__ float mie_phase(float ct, const float* c) {
  float l = c[1] - c[2] * ct;
  l = l * sqrtf(clamp_min(l, kEpsSq));
  return c[0] * (1.0f + ct * ct) / clamp_min(l, kEps);
}

__device__ __forceinline__ float calc_phase(const Medium& m, float ct) {
  return lerp(mie_phase(ct, m.mie_a), mie_phase(ct, m.mie_b), m.blend);
}

struct Ray {
  V ro, rd;
  float len;
};

__device__ __forceinline__ Ray load_ray(const float* const* p, long long e) {
  return {{__ldg(p[0] + e), __ldg(p[1] + e), __ldg(p[2] + e)},
          {__ldg(p[3] + e), __ldg(p[4] + e), __ldg(p[5] + e)},
          __ldg(p[6] + e)};
}

__device__ __forceinline__ void store3(float* out, long long n, int row, long long e, V v) {
  out[row * n + e] = v.x;
  out[(row + 1) * n + e] = v.y;
  out[(row + 2) * n + e] = v.z;
}

__device__ __forceinline__ void store_words(int64_t* words, long long n, long long e, uint32_t x,
                                            uint32_t y, uint32_t z, uint32_t w) {
  words[e] = x;
  words[n + e] = y;
  words[2 * n + e] = z;
  words[3 * n + e] = w;
}

// media.py:_tally_step: a step's density counts where the lane is live,
// and needs the fBm where the point is in the band besides
__device__ __forceinline__ void tally_step(const Medium& m, bool live, V p, int& steps,
                                           int& band) {
  steps += live ? 1 : 0;
  band += (live && fabsf(p.y - m.noise_height) <= m.noise_range) ? 1 : 0;
}

// tally [2, N] int32, where the profiler asks for it (else null): each
// lane's density evaluations that count, and those in the band
__device__ __forceinline__ void store_tally(int32_t* tally, long long n, long long e, int steps,
                                            int band) {
  if (tally != nullptr) {
    tally[e] = steps;
    tally[n + e] = band;
  }
}

// The lanes' inputs, in the order of render/media.py:LANE_FIELDS: ro x/y/z,
// rd x/y/z, the segment length, the four RNG words.
struct LaneArgs {
  const float* ray[7];
  const int64_t* state[4];
};

// out [13, N]: the march's attenuation (rows 0-2), the scatter point (3-5),
// the continuation's direction (6-8), attenuation (9-11) and phase pdf (12);
// scattered [N]; words [4, N] int64
__global__ void __launch_bounds__(kThreads)
media_scatter_kernel(LaneArgs a, const __grid_constant__ Medium m, long long n, float* __restrict__ out,
                     bool* __restrict__ scattered_out, int64_t* __restrict__ words,
                     int32_t* __restrict__ tally) {
  const long long e = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (e >= n) {
    return;
  }
  const Ray r = load_ray(a.ray, e);
  uint32_t sx = word(a.state[0], e);
  uint32_t sy = word(a.state[1], e);
  uint32_t sz = word(a.state[2], e);
  uint32_t sw = word(a.state[3], e);
  const float rcp_maj = m.rcp_majorant;

  // scatter_ray: the null-scattering march
  float t = 0.0f;
  V atten = {1.0f, 1.0f, 1.0f};
  bool live = true;
  bool scattered = false;
  V spos = r.ro;
  int steps = 0;
  int band = 0;
  for (int s = 0; s < kSteps; ++s) {
    pcg4d(sx, sy, sz, sw);
    const float t_new = t + free_path(to_float(sx), rcp_maj);
    live = live && (t_new < r.len);
    const V p = along(r.ro, r.rd, t_new);
    V scat, ext;
    media_sample(m, p, scat, ext);
    tally_step(m, live, p, steps, band);
    atten = attenuate(atten, ext, rcp_maj, live ? 1.0f : 0.0f);
    const float prob = maximum(scat.x, maximum(scat.y, scat.z)) * rcp_maj;
    pcg4d(sx, sy, sz, sw);
    const bool does = live && (to_float(sx) < prob);
    if (does && !scattered) spos = p;
    scattered = scattered || does;
    live = live && !does;
    t = live ? t_new : t;
  }

  // sample_phase_dir: masked rejection tries, three words each
  V best = r.rd;
  bool found = false;
  for (int k = 0; k < kPhaseTries; ++k) {
    pcg4d(sx, sy, sz, sw);
    const float u = to_float(sx);
    const float v = to_float(sy);
    pcg4d(sx, sy, sz, sw);
    const float ur = to_float(sx);
    const float cos_theta = v * 2.0f - 1.0f;
    const float phi = u * kTau;
    const float sin_theta = sqrt0(1.0f - cos_theta * cos_theta);
    const V l = {sin_theta * cosf(phi), sin_theta * sinf(phi), cos_theta};
    const float ph = calc_phase(m, dot(r.rd, l));
    const bool accept = !found && (ur <= ph);
    if (accept) best = l;
    found = found || accept;
  }
  const float ph_out = calc_phase(m, dot(r.rd, best));

  store3(out, n, 0, e, atten);
  store3(out, n, 3, e, spos);
  store3(out, n, 6, e, scattered ? best : r.rd);
  store3(out, n, 9, e,
         scattered ? V{atten.x * ph_out, atten.y * ph_out, atten.z * ph_out} : atten);
  out[12 * n + e] = scattered ? ph_out : 0.0f;
  scattered_out[e] = scattered;
  store_words(words, n, e, sx, sy, sz, sw);
  store_tally(tally, n, e, steps, band);
}

// out [3, N]: the transmittance; words [4, N] int64
__global__ void __launch_bounds__(kThreads)
media_transmittance_kernel(LaneArgs a, const __grid_constant__ Medium m, long long n, float* __restrict__ out,
                           int64_t* __restrict__ words, int32_t* __restrict__ tally) {
  const long long e = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (e >= n) {
    return;
  }
  const Ray r = load_ray(a.ray, e);
  uint32_t sx = word(a.state[0], e);
  uint32_t sy = word(a.state[1], e);
  uint32_t sz = word(a.state[2], e);
  uint32_t sw = word(a.state[3], e);
  const float rcp_maj = m.rcp_majorant;

  // calc_transmittance: ratio tracking, one word a step
  float t = 0.0f;
  V atten = {1.0f, 1.0f, 1.0f};
  bool live = true;
  int steps = 0;
  int band = 0;
  for (int s = 0; s < kSteps; ++s) {
    pcg4d(sx, sy, sz, sw);
    const float dt = free_path(to_float(sx), rcp_maj);
    live = live && ((t + dt) < r.len);
    const V p = along(r.ro, r.rd, t);
    V scat, ext;
    media_sample(m, p, scat, ext);
    tally_step(m, live, p, steps, band);
    atten = attenuate(atten, ext, rcp_maj, live ? 1.0f : 0.0f);
    t = t + (live ? dt : 0.0f);
  }
  store3(out, n, 0, e, atten);
  store_words(words, n, e, sx, sy, sz, sw);
  store_tally(tally, n, e, steps, band);
}

unsigned int blocks(long long n) {
  return static_cast<unsigned int>((n + kThreads - 1) / kThreads);
}

// The kernel arguments from the host tables.
void unpack(const void* const* ptrs, const float* consts, int octaves, LaneArgs& a, Medium& m) {
  static_assert(sizeof(LaneArgs) == 11 * sizeof(void*), "LaneArgs is 11 pointers");
  std::memcpy(&a, ptrs, sizeof(LaneArgs));
  static_assert(offsetof(Medium, octaves) == kMediumFloats * sizeof(float),
                "Medium's floats come first");
  std::memcpy(&m, consts, kMediumFloats * sizeof(float));
  m.octaves = octaves;
}

}  // namespace

extern "C" {

// ptrs: the LaneArgs pointers in order (11); consts: the Medium's floats
// (kMediumFloats); octaves in 0..kMaxOctaves (the wrapper checks it);
// tally null or [2, N] int32.
int pim_media_scatter(const void* const* ptrs, const float* consts, int octaves, long long n,
                      float* out, bool* scattered, int64_t* words, int32_t* tally,
                      void* stream_ptr) {
  LaneArgs a;
  Medium m;
  unpack(ptrs, consts, octaves, a, m);
  media_scatter_kernel<<<blocks(n), kThreads, 0, static_cast<cudaStream_t>(stream_ptr)>>>(
      a, m, n, out, scattered, words, tally);
  return static_cast<int>(cudaGetLastError());
}

int pim_media_transmittance(const void* const* ptrs, const float* consts, int octaves,
                            long long n, float* out, int64_t* words, int32_t* tally,
                            void* stream_ptr) {
  LaneArgs a;
  Medium m;
  unpack(ptrs, consts, octaves, a, m);
  media_transmittance_kernel<<<blocks(n), kThreads, 0, static_cast<cudaStream_t>(stream_ptr)>>>(
      a, m, n, out, words, tally);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
