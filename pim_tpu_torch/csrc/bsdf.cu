// The principled BSDF's sample and evaluation for Hopper (sm_90a), one
// thread a lane: bsdf_scatter (render/bsdf.py:scatter_principled, with the
// refractive sample up to its thickness probe), bsdf_refract_finish (the
// Beer-Lambert attenuation after the probe) and bsdf_eval
// (render/bsdf.py:eval_principled, NEE's evaluation).
//
// Replaces: no TPU kernel.  The JAX package leaves the BSDF to XLA
// (pim_tpu/render/bsdf.py), which fuses it; the port composed it of PyTorch
// ops, about 1,300 launches a scatter call with the glass probe (e1m1),
// 760 without it (Cornell) and 330 an eval call, each dispatched by the
// host.  These kernels take their place on CUDA tensors that carry no
// gradient; the composed version stays in render/bsdf.py for the CPU and
// for autograd.
//
// What bounds it on this card: device memory, on the lane's own fields.
// A scatter lane reads p, m, n, albedo (48 bytes), roughness, metallic,
// ior, flags, backface (17), the incoming direction (12) and four int64
// RNG words (32), and writes position, direction, attenuation, pdf (40)
// and the four new words (32): about 181 bytes; with the glass probe it
// also writes the probe's origin, direction and mask (25).  An eval lane
// moves 76 bytes, a finish lane at most 37.  At 262,144 lanes and
// 3.35 TB/s the scatter's floor is about 14 us; the arithmetic (two pcg4d
// draws, a GGX and a cosine sample, both lobes' evaluation, about 400
// float operations and 8 transcendentals) is a few us of the card's
// float32 rate.
//
// What the design does about it: one thread a lane reading the SoA [N]
// tensors as they are (each field's load and store coalesces across the
// warp), every intermediate in registers, the RNG words as uint32 in
// registers, and the 2 KB BRDF LUT through the read-only cache.  The
// thickness probe stays the eager closest-hit call it was between the two
// glass kernels, so the intersection kernels and their counters see it.
//
// Exactness: --fmad=false, and every expression in PyTorch's order of
// operations on CUDA, so the outputs are bit for bit the composed version's
// there: a Python constant divided by a tensor is a reciprocal times the
// constant (Tensor.__rdiv__), a tensor divided by a Python constant is a
// product with the constant's float32 reciprocal (ATen's div_true on CUDA),
// clamp and clamp_min pass a NaN through, torch.where selects, and sqrt,
// rsqrt, sin, cos, log and exp are the same libdevice calls.  Constants
// are the float32 values the Python code forms, written exactly in hex.
// The pcg4d on uint32 words (rng.cuh, shared with rng.cu) gives the int64
// form's bits (core/rng.py).

#include <cuda_runtime.h>

#include <cstdint>

#include "rng.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRefractive = 1 << 5;  // MatFlag.REFRACTIVE

constexpr float kEps = 0x1.0c6f7ap-20f;         // 1e-6
constexpr float kEpsSq = 0x1.197998p-40f;       // 1e-12
constexpr float kPi = 0x1.921fb6p+1f;
constexpr float kTau = 0x1.921fb6p+2f;
constexpr float kPi4 = 0x1.921fb6p-1f;
constexpr float kPi2 = 0x1.921fb6p+0f;
constexpr float kRcpPi = 0x1.45f306p-2f;        // float32(1) / float32(pi)
constexpr float kMinAlpha = 0x1p-10f;           // K_MIN_ALPHA
constexpr float kF90Scale = 16.5f;              // float32(50 * 0.33)
constexpr float kDiskSpan = 0x1.ffffbcp-1f;     // (1 - EPS) - EPS
constexpr float kF0Dielectric = 0x1.47ae14p-5f; // 0.04
constexpr float kEtaAir = 0x1.001228p+0f;       // 1.000277
constexpr float kInsideBias = 0x1.a36e3p-14f;   // MILLI * 0.1
constexpr float kTirDot = 0x1.5798eep-27f;      // 1e-8
constexpr float kNoHit = 1.0e6f;
// sigma_a_from_reflectance's polynomial (math/brdf.py:_SIGMA_C)
constexpr float kC0 = 0x1.7e0418p+2f, kC1 = 0x1.b851ecp-3f, kC2 = 0x1.441894p+1f;
constexpr float kC3 = 0x1.575c28p+3f, kC4 = 0x1.64bc6ap+2f, kC5 = 0x1.f5c29p-3f;

struct V {
  float x, y, z;
};

__device__ __forceinline__ V operator+(V a, V b) { return {a.x + b.x, a.y + b.y, a.z + b.z}; }
__device__ __forceinline__ V operator-(V a, V b) { return {a.x - b.x, a.y - b.y, a.z - b.z}; }
__device__ __forceinline__ V operator*(V a, V b) { return {a.x * b.x, a.y * b.y, a.z * b.z}; }
__device__ __forceinline__ V operator*(V a, float s) { return {a.x * s, a.y * s, a.z * s}; }
__device__ __forceinline__ V operator-(V a) { return {-a.x, -a.y, -a.z}; }
__device__ __forceinline__ V sel(bool c, V a, V b) { return c ? a : b; }

// torch.clamp / clamp_min / clamp_max with Python bounds: a NaN passes
__device__ __forceinline__ float clampf(float v, float lo, float hi) {
  return isnan(v) ? v : fminf(fmaxf(v, lo), hi);
}
__device__ __forceinline__ float clamp_min(float v, float lo) {
  return isnan(v) ? v : fmaxf(v, lo);
}
__device__ __forceinline__ float clamp_max(float v, float hi) {
  return isnan(v) ? v : fminf(v, hi);
}
__device__ __forceinline__ float saturate(float v) { return clampf(v, 0.0f, 1.0f); }
// `c / x` with a Python c: Tensor.__rdiv__ is x.reciprocal() * c
__device__ __forceinline__ float rdiv(float c, float x) { return (1.0f / x) * c; }

__device__ __forceinline__ float dot(V a, V b) { return a.x * b.x + a.y * b.y + a.z * b.z; }
__device__ __forceinline__ float dotsat(V a, V b) { return saturate(dot(a, b)); }
__device__ __forceinline__ V normalize(V v) { return v * rsqrtf(clamp_min(dot(v, v), kEpsSq)); }
__device__ __forceinline__ V reflect(V i, V n) { return i - n * (dot(i, n) * 2.0f); }
// vec3.sqrt0: sqrt(max(x, 0))
__device__ __forceinline__ float sqrt0(float x) {
  return x > 0.0f ? sqrtf(x) : sqrtf(clamp_min(x, 0.0f));
}

__device__ __forceinline__ V refract(V i, V n, float eta) {
  const float cosi = -dot(i, n);
  const float k = 1.0f - eta * eta * (1.0f - cosi * cosi);
  const V out = i * eta + n * (eta * cosi - sqrt0(k));
  return k < 0.0f ? V{0.0f, 0.0f, 0.0f} : out;
}

// --- sampling.py

__device__ __forceinline__ V tan_to_world(V n, V v) {
  const float s = n.z < 0.0f ? -1.0f : 1.0f;
  const float a = rdiv(-1.0f, s + n.z);
  const float b = n.x * n.y * a;
  const V t = {s * n.x * n.x * a + 1.0f, s * b, -s * n.x};
  const V bt = {b, s + n.y * n.y * a, -n.y};
  return t * v.x + bt * v.y + n * v.z;
}

__device__ __forceinline__ V spherical_to_cartesian(float cos_theta, float phi) {
  const float sin_theta = sqrt0(1.0f - cos_theta * cos_theta);
  return {sin_theta * cosf(phi), sin_theta * sinf(phi), cos_theta};
}

__device__ __forceinline__ V sample_ggx_microfacet(float u, float v, float alpha) {
  const float a2 = alpha * alpha;
  const float phi = u * kTau;
  const float b = clamp_min((a2 - 1.0f) * v + 1.0f, kEps);
  const float cos_theta = sqrtf(clamp_min((1.0f - v) / b, kEpsSq));
  return spherical_to_cartesian(cos_theta, phi);
}

__device__ __forceinline__ V sample_cosine_hemisphere(float u, float v) {
  u = u * kDiskSpan + kEps;
  v = v * kDiskSpan + kEps;
  const float a = u * 2.0f - 1.0f;
  const float b = v * 2.0f - 1.0f;
  const bool use_a = (a * a) > (b * b);
  const float r = use_a ? a : b;
  const float safe_a = fabsf(a) > 0.0f ? a : 1.0f;
  const float safe_b = fabsf(b) > 0.0f ? b : 1.0f;
  const float phi = use_a ? (b / safe_a) * kPi4 : kPi2 - (a / safe_b) * kPi4;
  const float dx = r * cosf(phi);
  const float dy = r * sinf(phi);
  return {dx, dy, sqrtf(clamp_min(1.0f - (dx * dx + dy * dy), kEpsSq))};
}

// surface.fix_shading_normal
__device__ __forceinline__ V fix_shading_normal(V m, V n) {
  return dot(m, n) <= 0.0f ? reflect(n, m) : n;
}

// --- brdf.py

__device__ __forceinline__ float brdf_alpha(float roughness) {
  return clamp_min(roughness * roughness, kMinAlpha);
}

__device__ __forceinline__ float f_dielectric(float cos_theta_i, float eta_i, float eta_t) {
  cos_theta_i = clampf(cos_theta_i, -1.0f, 1.0f);
  const bool trans = cos_theta_i < 0.0f;
  const float cos_i = fabsf(cos_theta_i);
  const float ei = trans ? eta_t : eta_i;
  const float et = trans ? eta_i : eta_t;
  const float sin_i = sqrtf(clamp_min(1.0f - cos_i * cos_i, kEpsSq));
  const float sin_t = (ei / et) * sin_i;
  const bool tir = sin_t >= 1.0f;
  const float cos_t = sqrtf(clamp_min(1.0f - sin_t * sin_t, kEpsSq));
  const float r_parl = ((et * cos_i) - (ei * cos_t)) / clamp_min((et * cos_i) + (ei * cos_t), kEps);
  const float r_perp = ((ei * cos_i) - (et * cos_t)) / clamp_min((ei * cos_i) + (et * cos_t), kEps);
  const float f = saturate((r_parl * r_parl + r_perp * r_perp) * 0.5f);
  return tir ? 1.0f : f;
}

__device__ __forceinline__ float d_gtr(float noh, float alpha) {
  const float a2 = alpha * alpha;
  float f = (a2 - 1.0f) * (noh * noh) + 1.0f;
  f = f * f * kPi;
  return a2 / clamp_min(f, kEps);
}

__device__ __forceinline__ float v_smith_correlated(float nol, float nov, float alpha) {
  const float a2 = alpha * alpha;
  const float v = nol * sqrtf(clamp_min(a2 + (nov - nov * a2) * nov, kEpsSq));
  const float l = nov * sqrtf(clamp_min(a2 + (nol - nol * a2) * nol, kEpsSq));
  return rdiv(0.5f, clamp_min(v + l, kEps));
}

// lerp(1, f90, (1 - cos)^5)
__device__ __forceinline__ float f_schlick1(float f90, float cos_theta) {
  const float t = 1.0f - cos_theta;
  const float t5 = t * t * t * t * t;
  return (f90 - 1.0f) * t5 + 1.0f;
}

__device__ __forceinline__ float fd_burley(float nol, float nov, float hov, float roughness) {
  const float fd90 = hov * 2.0f * hov * roughness + 0.5f;
  // `/ PI` on CUDA: a product with float32(1) / float32(pi)
  return (f_schlick1(fd90, nol) * f_schlick1(fd90, nov)) * kRcpPi;
}

// brdf_lut_sample's second channel: the 4-tap tent filter at (NoV, alpha)
__device__ __forceinline__ float brdf_lut_dv(const float* __restrict__ lut, int size, float nov,
                                             float alpha) {
  const float top = static_cast<float>(size - 1);
  const float x = saturate(nov) * top;
  const float y = saturate(alpha) * top;
  const float x0 = floorf(x);
  const float y0 = floorf(y);
  const float x1 = clamp_max(x0 + 1.0f, top);
  const float y1 = clamp_max(y0 + 1.0f, top);
  const float wx0 = clamp_min(1.0f - fabsf(x0 - x), 0.0f);
  const float wx1 = clamp_min(1.0f - fabsf((x0 + 1.0f) - x), 0.0f);
  const float wy0 = clamp_min(1.0f - fabsf(y0 - y), 0.0f);
  const float wy1 = clamp_min(1.0f - fabsf((y0 + 1.0f) - y), 0.0f);
  // finite coordinates land in [0, size - 1]; the clamp only keeps a NaN
  // lane inside the table
  const int ix0 = min(max(static_cast<int>(x0), 0), size - 1);
  const int ix1 = min(max(static_cast<int>(x1), 0), size - 1);
  const int iy0 = min(max(static_cast<int>(y0), 0), size - 1);
  const int iy1 = min(max(static_cast<int>(y1), 0), size - 1);
  const float r0 = __ldg(lut + 2 * (ix0 * size + iy0) + 1) * wx0 +
                   __ldg(lut + 2 * (ix1 * size + iy0) + 1) * wx1;
  const float r1 = __ldg(lut + 2 * (ix0 * size + iy1) + 1) * wx0 +
                   __ldg(lut + 2 * (ix1 * size + iy1) + 1) * wx1;
  return r0 * wy0 + r1 * wy1;
}

struct Lobe {
  V atten;
  float pdf;
};

struct Shading {
  V n, albedo;
  float roughness, metallic;
};

__device__ __forceinline__ Lobe eval_specular(const float* __restrict__ lut, int lut_size,
                                              const Shading& s, V i, V l) {
  const float nol = dot(s.n, l);
  const float alpha = brdf_alpha(s.roughness);
  const V v = -i;
  const V h = normalize(v + l);
  const float noh = dot(s.n, h);
  const float hov = dot(h, v);
  const float d = d_gtr(noh, alpha);
  const float pdf = (d * noh) / clamp_min(hov * 4.0f, kEps);  // ggx_pdf
  const bool valid = (nol > kEps) && (pdf > kEps);
  const float nov = dotsat(s.n, v);
  const float f_d = saturate(f_dielectric(hov, 1.0f, 1.5f));
  const V f0 = {(s.albedo.x - kF0Dielectric) * s.metallic + kF0Dielectric,
                (s.albedo.y - kF0Dielectric) * s.metallic + kF0Dielectric,
                (s.albedo.z - kF0Dielectric) * s.metallic + kF0Dielectric};
  const float f90 = saturate((f0.x + f0.y + f0.z) * kF90Scale);
  const V f = {f0.x + (f90 - f0.x) * f_d, f0.y + (f90 - f0.y) * f_d, f0.z + (f90 - f0.z) * f_d};
  const float g = v_smith_correlated(nol, nov, alpha);
  // ggx_energy_compensation
  const float t = rdiv(1.0f, clamp_min(brdf_lut_dv(lut, lut_size, nov, alpha), kEps)) - 1.0f;
  const V comp = {f0.x * t + 1.0f, f0.y * t + 1.0f, f0.z * t + 1.0f};
  const float sv = valid ? d * g * nol : 0.0f;
  return {f * comp * sv, valid ? pdf : 0.0f};
}

__device__ __forceinline__ Lobe eval_diffuse(const Shading& s, V i, V l) {
  const float nol = dot(s.n, l);
  const float pdf = nol * kRcpPi;  // lambert_pdf
  const bool valid = pdf > kEps;
  const V v = -i;
  const V h = normalize(v + l);
  const float hov = dotsat(h, v);
  const float nov = dotsat(s.n, v);
  const float sv = valid ? fd_burley(nol, nov, hov, s.roughness) * nol : 0.0f;
  return {s.albedo * sv, valid ? pdf : 0.0f};
}

// --- core/rng.py (rng.cuh)

using pim_rng::pcg4d;
using pim_rng::to_float;
using pim_rng::word;

// --- the kernels

__device__ __forceinline__ V load3(const float* const* p, long long e) {
  return {__ldg(p[0] + e), __ldg(p[1] + e), __ldg(p[2] + e)};
}

__device__ __forceinline__ void store3(float* out, long long n, int row, long long e, V v) {
  out[row * n + e] = v.x;
  out[(row + 1) * n + e] = v.y;
  out[(row + 2) * n + e] = v.z;
}

// The scatter's inputs, in the order of the pointer table the wrapper
// passes (render/bsdf.py:SCATTER_FIELDS).
struct ScatterArgs {
  const float* p[3];
  const float* m[3];
  const float* n[3];
  const float* albedo[3];
  const float* roughness;
  const float* metallic;
  const float* ior;
  const int32_t* flags;
  const bool* backface;
  const float* i[3];
  const int64_t* state[4];
};

// out [10, N] (pos, dir, attenuation, pdf), or [16, N] on the refractive
// path (then rows 10-15 the probe's origin and direction); words [4, N]
// int64; probe [N] (refractive path only): the lanes whose thickness the
// probe traces
__global__ void __launch_bounds__(kThreads)
bsdf_scatter_kernel(ScatterArgs a, const float* __restrict__ lut, int lut_size, long long n,
                    int refractive_path, float* __restrict__ out,
                    int64_t* __restrict__ words, bool* __restrict__ probe) {
  const long long e = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (e >= n) {
    return;
  }
  uint32_t sx = word(a.state[0], e);
  uint32_t sy = word(a.state[1], e);
  uint32_t sz = word(a.state[2], e);
  uint32_t sw = word(a.state[3], e);
  Shading s;
  s.n = load3(a.n, e);
  s.albedo = load3(a.albedo, e);
  s.roughness = __ldg(a.roughness + e);
  s.metallic = __ldg(a.metallic + e);
  const V i = load3(a.i, e);
  const V sm = load3(a.m, e);
  V pos = load3(a.p, e);

  pcg4d(sx, sy, sz, sw);
  const float u_lobe = to_float(sx);
  pcg4d(sx, sy, sz, sw);
  const float xu = to_float(sx);
  const float xv = to_float(sy);
  const float amt_spec = s.metallic * 0.5f + 0.5f;  // lerp(0.5, 1.0, metallic)
  const float amt_diff = 1.0f - amt_spec;
  const bool use_spec = u_lobe < amt_spec;

  const float alpha = brdf_alpha(s.roughness);
  const V m = fix_shading_normal(sm, tan_to_world(s.n, sample_ggx_microfacet(xu, xv, alpha)));
  const V l_spec = reflect(i, m);
  const V l_diff = tan_to_world(s.n, sample_cosine_hemisphere(xu, xv));
  V l = sel(use_spec, l_spec, l_diff);
  const Lobe spec = eval_specular(lut, lut_size, s, i, l);
  const Lobe diff = eval_diffuse(s, i, l);
  V atten = use_spec ? spec.atten + (diff.atten - spec.atten) * amt_diff
                     : diff.atten + (spec.atten - diff.atten) * amt_spec;
  float pdf = use_spec ? spec.pdf + (diff.pdf - spec.pdf) * amt_diff
                       : diff.pdf + (spec.pdf - diff.pdf) * amt_spec;

  if (refractive_path) {
    // _scatter_refractive up to the thickness probe, on every lane
    const float eta_t = clamp_min(__ldg(a.ior + e), 1.0f);
    pcg4d(sx, sy, sz, sw);
    const float ru = to_float(sx);
    const float rv = to_float(sy);
    pcg4d(sx, sy, sz, sw);
    const float u_fresnel = to_float(sx);
    const V v = -i;
    const V mr = fix_shading_normal(sm, tan_to_world(s.n, sample_ggx_microfacet(ru, rv, alpha)));
    const bool entering = !a.backface[e];
    const float cos_i = saturate(fabsf(dot(v, mr)));
    const float fres = f_dielectric(entering ? cos_i : -cos_i, kEtaAir, eta_t);
    const bool do_reflect = u_fresnel < fres;
    const V l_reflect = reflect(i, mr);
    // _ETA_AIR / eta_t is a reciprocal times the constant; eta_t / _ETA_AIR
    // a product with the constant's float32 reciprocal
    const float k = entering ? rdiv(kEtaAir, eta_t) : eta_t * (1.0f / kEtaAir);
    V l_refract = refract(i, mr, k);
    const bool tir = dot(l_refract, l_refract) < kTirDot;
    l_refract = sel(tir, l_reflect, l_refract);
    const V lr = sel(do_reflect, l_reflect, l_refract);
    const float pdf_r = do_reflect ? fres : 1.0f - fres;
    const V pos_r = dot(lr, sm) < 0.0f ? pos - sm * kInsideBias : pos;
    const bool refracting_in = !do_reflect && entering && !tir;
    const bool refractive = (__ldg(a.flags + e) & kRefractive) != 0;
    store3(out, n, 10, e, pos_r);
    store3(out, n, 13, e, lr);
    probe[e] = refractive && refracting_in;
    if (refractive) {
      // bsdf_refract_finish replaces the attenuation of the probed lanes
      pos = pos_r;
      l = lr;
      atten = {pdf_r, pdf_r, pdf_r};
      pdf = pdf_r;
    }
  }
  store3(out, n, 0, e, pos);
  store3(out, n, 3, e, l);
  store3(out, n, 6, e, atten);
  out[9 * n + e] = pdf;
  words[e] = sx;
  words[n + e] = sy;
  words[2 * n + e] = sz;
  words[3 * n + e] = sw;
}

// The probed lanes' Beer-Lambert attenuation, in place on the scatter's
// out rows 6-8, from its pdf (row 9) and the probe's hit distance.
__global__ void __launch_bounds__(kThreads)
bsdf_refract_finish_kernel(const bool* __restrict__ probe, const float* __restrict__ t_hit,
                           const float* __restrict__ ax, const float* __restrict__ ay,
                           const float* __restrict__ az, const float* __restrict__ roughness,
                           long long n, float* __restrict__ out) {
  const long long e = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (e >= n || !probe[e]) {
    return;
  }
  const float t = __ldg(t_hit + e);
  const float thickness = t >= 0.0f ? clamp_min(t, kEps) : kNoHit;
  // albedo_to_transmittance: sigma_a_from_reflectance, then Beer-Lambert
  const float beta = __ldg(roughness + e);
  const float r2 = beta * beta;
  const float r3 = r2 * beta;
  const float r4 = r3 * beta;
  const float r5 = r4 * beta;
  const float den =
      clamp_min(kC0 - beta * kC1 + r2 * kC2 - r3 * kC3 + r4 * kC4 + r5 * kC5, kEps);
  const float pdf = out[9 * n + e];
  const float alb[3] = {__ldg(ax + e), __ldg(ay + e), __ldg(az + e)};
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float sig_s = logf(clamp_min(alb[c], kEps)) / den;
    const float sig = sig_s * sig_s;
    out[(6 + c) * n + e] = expf(-sig * thickness) * pdf;
  }
}

// The evaluation's inputs, in the order of render/bsdf.py:EVAL_FIELDS.
struct EvalArgs {
  const float* n[3];
  const float* albedo[3];
  const float* roughness;
  const float* metallic;
  const int32_t* flags;
  const float* i[3];
  const float* l[3];
};

// out [4, N]: attenuation, pdf
__global__ void __launch_bounds__(kThreads)
bsdf_eval_kernel(EvalArgs a, const float* __restrict__ lut, int lut_size, long long n,
                 float* __restrict__ out) {
  const long long e = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (e >= n) {
    return;
  }
  Shading s;
  s.n = load3(a.n, e);
  s.albedo = load3(a.albedo, e);
  s.roughness = __ldg(a.roughness + e);
  s.metallic = __ldg(a.metallic + e);
  const V i = load3(a.i, e);
  const V l = load3(a.l, e);
  const float nol = dot(s.n, l);
  const float amt_spec = s.metallic * 0.5f + 0.5f;
  const float amt_diff = 1.0f - amt_spec;
  const Lobe spec = eval_specular(lut, lut_size, s, i, l);
  const Lobe diff = eval_diffuse(s, i, l);
  const bool dead = ((__ldg(a.flags + e) & kRefractive) != 0) || (nol <= kEps);
  const V atten = dead ? V{0.0f, 0.0f, 0.0f} : spec.atten + (diff.atten - spec.atten) * amt_diff;
  store3(out, n, 0, e, atten);
  out[3 * n + e] = dead ? 0.0f : spec.pdf + (diff.pdf - spec.pdf) * amt_diff;
}

unsigned int blocks(long long n) {
  return static_cast<unsigned int>((n + kThreads - 1) / kThreads);
}

}  // namespace

extern "C" {

// ptrs: the ScatterArgs pointers in order (24); refractive_path 0 or 1
// (probe may be null without it).
int pim_bsdf_scatter(const void* const* ptrs, const float* lut, int lut_size, long long n,
                     int refractive_path, float* out, int64_t* words, bool* probe,
                     void* stream_ptr) {
  ScatterArgs a;
  static_assert(sizeof(ScatterArgs) == 24 * sizeof(void*), "ScatterArgs is 24 pointers");
  const void** dst = reinterpret_cast<const void**>(&a);
  for (int k = 0; k < 24; ++k) dst[k] = ptrs[k];
  bsdf_scatter_kernel<<<blocks(n), kThreads, 0, static_cast<cudaStream_t>(stream_ptr)>>>(
      a, lut, lut_size, n, refractive_path, out, words, probe);
  return static_cast<int>(cudaGetLastError());
}

int pim_bsdf_refract_finish(const bool* probe, const float* t_hit, const float* ax,
                            const float* ay, const float* az, const float* roughness, long long n,
                            float* out, void* stream_ptr) {
  bsdf_refract_finish_kernel<<<blocks(n), kThreads, 0, static_cast<cudaStream_t>(stream_ptr)>>>(
      probe, t_hit, ax, ay, az, roughness, n, out);
  return static_cast<int>(cudaGetLastError());
}

// ptrs: the EvalArgs pointers in order (15).
int pim_bsdf_eval(const void* const* ptrs, const float* lut, int lut_size, long long n, float* out,
                  void* stream_ptr) {
  EvalArgs a;
  static_assert(sizeof(EvalArgs) == 15 * sizeof(void*), "EvalArgs is 15 pointers");
  const void** dst = reinterpret_cast<const void**>(&a);
  for (int k = 0; k < 15; ++k) dst[k] = ptrs[k];
  bsdf_eval_kernel<<<blocks(n), kThreads, 0, static_cast<cudaStream_t>(stream_ptr)>>>(
      a, lut, lut_size, n, out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
