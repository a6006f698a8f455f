// The sky's Rayleigh/Mie single-scatter bake for Hopper (sm_90a): sky_bake
// (render/sky.py:atmosphere's forward, every direction's view march with a
// 96-step sun march from each view sample) and its backward in the sun's
// direction and luminance, sky_bake_bwd (one partial gradient a direction)
// and sky_grad_sum (the partials summed in a fixed order).
//
// Replaces: no TPU kernel.  The JAX package leaves the march to XLA
// (pim_tpu/render/sky.py, a masked lax.scan over the view steps); the port
// composed it of PyTorch ops, a Python loop over the view steps, which for
// the training step's 32^2 cube at 8 steps (448 view steps) is about 57,000
// launches in the forward and 51,000 in its backward (autograd, with the
// checkpoint's recompute of every sun march): about 106,000 of a training
// step's 134,895.  These kernels take its place on CUDA tensors; the
// composed version stays in render/sky.py (atmosphere_plain) for the CPU.
//
// What bounds it on this card: the density evaluations, at most 6,144
// directions x 448 view steps x 96 sun steps (about 264 M; a march stops
// where it enters the crust or leaves the atmosphere, so far fewer run),
// each two expf, one correctly rounded sqrtf and the squared norm in
// float64 (two float64 products and sums, three conversions).  At the
// H100's SFU and FP64 rates that is about 0.15-0.3 ms a bake at most; the
// inputs and outputs are a few hundred KB.
//
// What the design does about it: one block a direction.  Its threads
// stride over the view steps: the view samples' densities, the view march's
// live prefix (one thread), a sun march from each live view sample (the
// independent work, all threads, 16 sun steps a trip) into shared memory
// (at most 1,024 steps x 46 B).  One thread then forms the view march's running optical depths in
// order, all threads each step's three transmittances, and six threads the
// six running sums, each in the plain code's order.  The backward
// recomputes the same and carries three forward-mode tangents (the sun
// direction's components) through each sun march in float64; each block
// reduces its direction's gradient by warp shuffles in a fixed order, and
// sky_grad_sum sums the directions in a fixed order: no float atomics, so
// two runs give the same bits.
//
// Exactness: --fmad=false, and every expression in PyTorch's order on CUDA,
// so the forward is bit for bit the composed version there: the march
// positions are the plain code's running float32 sums of the step; the
// squared norm is x*x in float32, then the float64 sums of the float64
// squares, each rounded once to float32; a 96-step sum is in torch.sum's
// order over dim 0 of [96, D] (its partial sums, which depend on D: see
// partial_of); the view march's sums run in step order.  Steps past the view march's end or a sun
// march's end add +0 in the plain code and are skipped here.

#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>

namespace {

constexpr int kThreads = 224;  // 7 warps: 2 view steps a thread at 8 steps (448)
constexpr int kSunSteps = 96;
constexpr int kMaxWarps = 8;   // of kThreads and kSumThreads
constexpr int kSumThreads = 256;
constexpr int kGrads = 6;      // d/d sun direction (3), d/d luminance (3)
constexpr int kAcc = 9;        // the backward's sums: tr_r (3), tr_m (3), d/d sun direction (3)

// the float32 constants of render/sky.py, in sky.py's SKY_CONSTS order
struct Consts {
  float ox, oy, oz;           // the view rays' origin (planet centre at 0)
  float mfp;                  // the march step
  float r_crust, rho_r, rho_m;
  float mu_r[3], mu_m;
  float k_ray;                // rayleigh_phase's constant
  float k_mie, a_mie, b_mie;  // mie_phase's k, 1 + g^2 and 2 g
  float eps, eps_sq, min_density;
};
constexpr int kConsts = 18;
static_assert(sizeof(Consts) == kConsts * sizeof(float), "Consts is 18 floats");
static_assert(kSunSteps % 16 == 0, "the sun march runs 16 steps a trip");

// torch.clamp_min / clamp_max with a Python bound: a NaN passes
__device__ __forceinline__ float clamp_min(float v, float lo) {
  return isnan(v) ? v : fmaxf(v, lo);
}
__device__ __forceinline__ float clamp_max(float v, float hi) {
  return isnan(v) ? v : fminf(v, hi);
}

struct Density {
  float s;     // the squared norm
  float root;  // sqrt(clamp_min(s, eps))
  float h, dr, dm;
};

// sky.py's density: |p| - r_crust and the two exponential densities
__device__ __forceinline__ Density density(float px, float py, float pz, const Consts& c) {
  Density d;
  const float s0 = static_cast<float>(static_cast<double>(px * px) +
                                      static_cast<double>(py) * static_cast<double>(py));
  d.s = static_cast<float>(static_cast<double>(s0) +
                           static_cast<double>(pz) * static_cast<double>(pz));
  d.root = sqrtf(clamp_min(d.s, c.eps));
  d.h = d.root - c.r_crust;
  d.dr = expf(clamp_max(-d.h * c.rho_r, 0.0f));
  d.dm = expf(clamp_max(-d.h * c.rho_m, 0.0f));
  return d;
}

// d density / dh as autograd of exp(clamp_max(-h rho, 0)) takes it: the
// clamp passes the gradient where -h rho <= 0
__device__ __forceinline__ double ddensity_dh(float h, float rho, float dens) {
  return -h * rho <= 0.0f ? -static_cast<double>(rho) * dens : 0.0;
}

// The shared arrays of one block, n view steps.
struct Steps {
  float* tv;     // [n] view positions
  float* ts;     // [96] sun positions
  float* odr;    // [n] each view step's optical depths, dr * mfp and dm * mfp
  float* odm;
  float* ar;     // [n] the sun march's optical depths, then a_r and a_m
  float* am;
  float* extra;  // [6 * n] the forward's terms, the backward's tangents
  unsigned char* ok;   // [n] the view sample is outside the crust and dense enough
  unsigned char* hit;  // [n] its sun march met the crust
};

__device__ __forceinline__ Steps carve(float* smem, int n) {
  Steps s;
  s.tv = smem;
  s.ts = s.tv + n;
  s.odr = s.ts + kSunSteps;
  s.odm = s.odr + n;
  s.ar = s.odm + n;
  s.am = s.ar + n;
  s.extra = s.am + n;
  s.ok = reinterpret_cast<unsigned char*>(s.extra + 6 * n);
  s.hit = s.ok + n;
  return s;
}

size_t shared_bytes(int n) {
  return (11 * static_cast<size_t>(n) + kSunSteps) * sizeof(float) + 2 * static_cast<size_t>(n);
}

// 0, mfp, mfp + mfp, ...: the plain code's running float32 sums
__device__ __forceinline__ void positions(float* out, int n, float mfp) {
  float t = 0.0f;
  for (int k = 0; k < n; ++k) {
    out[k] = t;
    t = t + mfp;
  }
}

// The view march up to its sun marches: the positions, the view samples
// and the live prefix (the number of view steps before the first dead one).
__device__ int view_samples(const Steps& s, int n, float dx, float dy, float dz, const Consts& c,
                            int* live) {
  if (threadIdx.x == 0) positions(s.tv, n, c.mfp);
  if (threadIdx.x == (blockDim.x > 32 ? 32 : 0)) positions(s.ts, kSunSteps, c.mfp);
  __syncthreads();
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const float t = s.tv[i];
    const Density v = density(dx * t + c.ox, dy * t + c.oy, dz * t + c.oz, c);
    s.ok[i] = (v.h >= 0.0f) && (v.dr + v.dm >= c.min_density);
    s.odr[i] = v.dr * c.mfp;
    s.odm[i] = v.dm * c.mfp;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int k = 0;
    while (k < n && s.ok[k]) ++k;
    *live = k;
  }
  __syncthreads();
  return *live;
}

// Which of a sun march's partial sums step k adds into, as torch.sum
// over dim 0 of the plain code's [96, D] orders them (ATen's
// Reduce.cuh): four accumulators over k mod 4 in one thread, or, where the
// reduction splits the 96 steps over 4 threads (kSplit 4), four
// accumulators in each thread y over its steps y + 4 i + 16 m, i the
// accumulator.
template <int kSplit>
__device__ __forceinline__ int partial_of(int j) {  // j = k mod 16
  return kSplit == 1 ? (j & 3) : (j & 3) * 4 + (j >> 2);
}

// The partial sums combined as torch.sum combines them: in one thread
// ((a0 + a1) + a2) + a3; over 4 threads each thread's so, then the
// threads' (t0 + t2) + (t1 + t3).
template <int kSplit>
__device__ __forceinline__ float combine(const float* a) {
  if constexpr (kSplit == 1) {
    return ((a[0] + a[1]) + a[2]) + a[3];
  } else {
    float t[4];
#pragma unroll
    for (int y = 0; y < 4; ++y) t[y] = ((a[4 * y] + a[4 * y + 1]) + a[4 * y + 2]) + a[4 * y + 3];
    return (t[0] + t[2]) + (t[1] + t[3]);
  }
}

// One sun march from p: the optical depths (in torch.sum's order, above)
// and whether it met the crust while live.  With kTangents, t_r[j] and
// t_m[j] add d od / d light_dir[j] in float64, the derivative autograd of
// the plain code takes (clamps pass the gradient where their bound does
// not act; the liveness masks pass none).
template <bool kTangents, int kSplit>
__device__ __forceinline__ void sun_march(float px, float py, float pz, float lx, float ly,
                                          float lz, const float* ts, const Consts& c,
                                          float* od_r, float* od_m, bool* hit, double* t_r,
                                          double* t_m) {
  constexpr int kParts = 4 * kSplit;
  float acc_r[kParts];
  float acc_m[kParts];
#pragma unroll
  for (int q = 0; q < kParts; ++q) acc_r[q] = acc_m[q] = 0.0f;
  bool alive = true;
  bool met = false;
  for (int k0 = 0; k0 < kSunSteps && alive; k0 += 16) {
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      if (!alive) continue;
      const float t = ts[k0 + j];
      const float qx = px + t * lx;
      const float qy = py + t * ly;
      const float qz = pz + t * lz;
      const Density q = density(qx, qy, qz, c);
      if (q.h < 0.0f) {  // the crust, met while live
        met = true;
        alive = false;
        continue;
      }
      if (!(q.dr + q.dm >= c.min_density)) {
        alive = false;
        continue;
      }
      // a step past the march's end adds +0 in the plain code: skipped
      acc_r[partial_of<kSplit>(j)] = acc_r[partial_of<kSplit>(j)] + q.dr * c.mfp;
      acc_m[partial_of<kSplit>(j)] = acc_m[partial_of<kSplit>(j)] + q.dm * c.mfp;
      if constexpr (kTangents) {
        // dh / d light_dir[j] = q_j t / root where the norm's clamp passes
        const double dh = q.s >= c.eps ? static_cast<double>(t) / q.root : 0.0;
        const double gr = ddensity_dh(q.h, c.rho_r, q.dr) * c.mfp * dh;
        const double gm = ddensity_dh(q.h, c.rho_m, q.dm) * c.mfp * dh;
        t_r[0] += gr * qx;
        t_r[1] += gr * qy;
        t_r[2] += gr * qz;
        t_m[0] += gm * qx;
        t_m[1] += gm * qy;
        t_m[2] += gm * qz;
      }
    }
  }
  *od_r = combine<kSplit>(acc_r);
  *od_m = combine<kSplit>(acc_m);
  *hit = met;
}

// One thread: the view march's running optical depths in step order, and
// a = the running depth + the sun march's (in ar, am).
__device__ __forceinline__ void running_depths(const Steps& s, int live) {
  if (threadIdx.x != 0) return;
  float vr = 0.0f;
  float vm = 0.0f;
  for (int i = 0; i < live; ++i) {
    vr = vr + s.odr[i];
    vm = vm + s.odm[i];
    s.ar[i] = vr + s.ar[i];
    s.am[i] = vm + s.am[i];
  }
}

__device__ __forceinline__ float transmittance(const Steps& s, int i, int ch, const Consts& c) {
  return expf(-(s.ar[i] * c.mu_r[ch] + s.am[i] * c.mu_m));
}

struct Phases {
  float cos_theta, c2, ph_r, ph_m;
  float l0, root, l;  // mie's 1 + g^2 - 2 g cos, sqrt(clamp_min(l0)), l0 * root
};

// rayleigh_phase and mie_phase of cos_theta = rd . light_dir
__device__ __forceinline__ Phases phases(float dx, float dy, float dz, float lx, float ly,
                                         float lz, const Consts& c) {
  Phases p;
  p.cos_theta = dx * lx + dy * ly + dz * lz;
  p.c2 = p.cos_theta * p.cos_theta + 1.0f;
  p.ph_r = p.c2 * c.k_ray;
  p.l0 = c.a_mie - p.cos_theta * c.b_mie;
  p.root = sqrtf(clamp_min(p.l0, c.eps_sq));
  p.l = p.l0 * p.root;
  p.ph_m = (p.c2 * c.k_mie) / clamp_min(p.l, c.eps);
  return p;
}

template <int kSplit>
__global__ void __launch_bounds__(kThreads)
    sky_bake_kernel(const float* __restrict__ rx, const float* __restrict__ ry,
                    const float* __restrict__ rz, const float* __restrict__ ld,
                    const float* __restrict__ lum, Consts c, int n, long long count,
                    float* __restrict__ out) {
  extern __shared__ float smem[];
  __shared__ int live_n;
  __shared__ float sums[6];
  const long long d = blockIdx.x;
  const Steps s = carve(smem, n);
  const float dx = rx[d], dy = ry[d], dz = rz[d];
  const float lx = ld[0], ly = ld[1], lz = ld[2];
  const int live = view_samples(s, n, dx, dy, dz, c, &live_n);
  for (int i = threadIdx.x; i < live; i += blockDim.x) {
    const float t = s.tv[i];
    float od_r, od_m;
    bool hit;
    sun_march<false, kSplit>(dx * t + c.ox, dy * t + c.oy, dz * t + c.oz, lx, ly, lz, s.ts, c, &od_r,
                     &od_m, &hit, nullptr, nullptr);
    s.ar[i] = od_r;
    s.am[i] = od_m;
    s.hit[i] = hit;
  }
  __syncthreads();
  running_depths(s, live);
  __syncthreads();
  // each live step's terms tr_i * (od_i * m), rows (channel, rayleigh or mie)
  for (int i = threadIdx.x; i < live; i += blockDim.x) {
    const float m = s.hit[i] ? 0.0f : 1.0f;
    const float wr = s.odr[i] * m;
    const float wm = s.odm[i] * m;
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) {
      const float tr = transmittance(s, i, ch, c);
      s.extra[(2 * ch) * n + i] = tr * wr;
      s.extra[(2 * ch + 1) * n + i] = tr * wm;
    }
  }
  __syncthreads();
  for (int q = threadIdx.x; q < 6; q += blockDim.x) {
    float acc = 0.0f;
    const float* row = s.extra + q * n;
    for (int i = 0; i < live; ++i) acc = acc + row[i];
    sums[q] = acc;
  }
  __syncthreads();
  const Phases p = phases(dx, dy, dz, lx, ly, lz, c);
  for (int ch = threadIdx.x; ch < 3; ch += blockDim.x) {
    out[ch * count + d] =
        ((sums[2 * ch] * c.mu_r[ch]) * p.ph_r + sums[2 * ch + 1] * (p.ph_m * c.mu_m)) * lum[ch];
  }
}

__device__ __forceinline__ double warp_sum(double v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

// The block's kAcc sums into thread 0's acc, in a fixed order.
__device__ __forceinline__ void block_sum(double* acc, double (*red)[kAcc]) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int warps = (blockDim.x + 31) >> 5;
#pragma unroll
  for (int q = 0; q < kAcc; ++q) {
    const double v = warp_sum(acc[q]);
    if (lane == 0) red[warp][q] = v;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int q = 0; q < kAcc; ++q) {
      double t = 0.0;
      for (int w = 0; w < warps; ++w) t += red[w][q];
      acc[q] = t;
    }
  }
}

template <int kSplit>
__global__ void __launch_bounds__(kThreads)
    sky_bake_bwd_kernel(const float* __restrict__ rx, const float* __restrict__ ry,
                        const float* __restrict__ rz, const float* __restrict__ ld,
                        const float* __restrict__ lum, Consts c, int n, long long count,
                        const float* __restrict__ grad, double* __restrict__ partial) {
  extern __shared__ float smem[];
  __shared__ int live_n;
  __shared__ double red[kMaxWarps][kAcc];
  const long long d = blockIdx.x;
  const Steps s = carve(smem, n);
  float* tang = s.extra;  // [6, n]: d od_r / d l_j (rows 0-2), d od_m / d l_j (rows 3-5)
  const float dx = rx[d], dy = ry[d], dz = rz[d];
  const float lx = ld[0], ly = ld[1], lz = ld[2];
  const int live = view_samples(s, n, dx, dy, dz, c, &live_n);
  for (int i = threadIdx.x; i < live; i += blockDim.x) {
    const float t = s.tv[i];
    float od_r, od_m;
    bool hit;
    double t_r[3] = {0.0, 0.0, 0.0};
    double t_m[3] = {0.0, 0.0, 0.0};
    sun_march<true, kSplit>(dx * t + c.ox, dy * t + c.oy, dz * t + c.oz, lx, ly, lz, s.ts, c, &od_r,
                    &od_m, &hit, t_r, t_m);
    s.ar[i] = od_r;
    s.am[i] = od_m;
    s.hit[i] = hit;
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      tang[j * n + i] = static_cast<float>(t_r[j]);
      tang[(3 + j) * n + i] = static_cast<float>(t_m[j]);
    }
  }
  __syncthreads();
  running_depths(s, live);
  __syncthreads();

  const Phases p = phases(dx, dy, dz, lx, ly, lz, c);
  double w[3], pr[3], pm[3];  // g_c lum_c, and its weights of tr_r and tr_m in out_c
#pragma unroll
  for (int ch = 0; ch < 3; ++ch) {
    w[ch] = static_cast<double>(grad[ch * count + d]) * lum[ch];
    pr[ch] = w[ch] * c.mu_r[ch] * p.ph_r;
    pm[ch] = w[ch] * c.mu_m * p.ph_m;
  }
  double acc[kAcc];  // tr_r (3), tr_m (3), d out / d light_dir through the transmittances (3)
#pragma unroll
  for (int q = 0; q < kAcc; ++q) acc[q] = 0.0;
  for (int i = threadIdx.x; i < live; i += blockDim.x) {
    const float m = s.hit[i] ? 0.0f : 1.0f;
    const float wr = s.odr[i] * m;
    const float wm = s.odm[i] * m;
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) {
      const float tr = transmittance(s, i, ch, c);
      acc[ch] += static_cast<double>(tr * wr);
      acc[3 + ch] += static_cast<double>(tr * wm);
      if (m != 0.0f) {
        // d tr / d l_j = -tr (mu_r d a_r / d l_j + mu_m d a_m / d l_j)
        const double k = -static_cast<double>(tr) * (pr[ch] * s.odr[i] + pm[ch] * s.odm[i]);
#pragma unroll
        for (int j = 0; j < 3; ++j) {
          acc[6 + j] += k * (static_cast<double>(c.mu_r[ch]) * tang[j * n + i] +
                             static_cast<double>(c.mu_m) * tang[(3 + j) * n + i]);
        }
      }
    }
  }
  block_sum(acc, red);
  if (threadIdx.x != 0) return;
  // the phases' derivatives in cos_theta
  const double cs = p.cos_theta;
  const double dph_r = static_cast<double>(c.k_ray) * 2.0 * cs;
  const double lc = p.l >= c.eps ? static_cast<double>(p.l) : c.eps;
  double dl = -static_cast<double>(c.b_mie) *
              (p.root + (p.l0 >= c.eps_sq ? p.l0 / (2.0 * p.root) : 0.0));
  if (!(p.l >= c.eps)) dl = 0.0;
  const double dph_m = static_cast<double>(c.k_mie) * (2.0 * cs / lc - p.c2 / (lc * lc) * dl);
  double by_cos = 0.0;
  double* out = partial + d * kGrads;
#pragma unroll
  for (int ch = 0; ch < 3; ++ch) {
    by_cos += w[ch] * (acc[ch] * c.mu_r[ch] * dph_r + acc[3 + ch] * c.mu_m * dph_m);
    out[3 + ch] = static_cast<double>(grad[ch * count + d]) *
                  (acc[ch] * c.mu_r[ch] * p.ph_r + acc[3 + ch] * c.mu_m * p.ph_m);
  }
  out[0] = acc[6] + by_cos * dx;
  out[1] = acc[7] + by_cos * dy;
  out[2] = acc[8] + by_cos * dz;
}

// out[q] = the sum over the directions of partial[d][q], in a fixed order
__global__ void __launch_bounds__(kSumThreads)
    sky_grad_sum_kernel(const double* __restrict__ partial, long long count,
                        float* __restrict__ out) {
  __shared__ double red[kMaxWarps][kAcc];
  double acc[kAcc];
#pragma unroll
  for (int q = 0; q < kAcc; ++q) acc[q] = 0.0;
  for (long long d = threadIdx.x; d < count; d += blockDim.x) {
#pragma unroll
    for (int q = 0; q < kGrads; ++q) acc[q] += partial[d * kGrads + q];
  }
  block_sum(acc, red);
  if (threadIdx.x == 0) {
    for (int q = 0; q < kGrads; ++q) out[q] = static_cast<float>(acc[q]);
  }
}

cudaError_t fit_shared(const void* kernel, size_t bytes) {
  if (bytes <= 32 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

template <int kSplit>
int launch_bake(const float* rx, const float* ry, const float* rz, const float* ld,
                const float* lum, const Consts& c, int trips, long long count, float* out,
                cudaStream_t stream) {
  const size_t bytes = shared_bytes(trips);
  const cudaError_t err = fit_shared(reinterpret_cast<const void*>(sky_bake_kernel<kSplit>), bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  sky_bake_kernel<kSplit><<<static_cast<unsigned int>(count), kThreads, bytes, stream>>>(
      rx, ry, rz, ld, lum, c, trips, count, out);
  return static_cast<int>(cudaGetLastError());
}

template <int kSplit>
int launch_bake_bwd(const float* rx, const float* ry, const float* rz, const float* ld,
                    const float* lum, const Consts& c, int trips, long long count,
                    const float* grad, double* partial, cudaStream_t stream) {
  const size_t bytes = shared_bytes(trips);
  const cudaError_t err =
      fit_shared(reinterpret_cast<const void*>(sky_bake_bwd_kernel<kSplit>), bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  sky_bake_bwd_kernel<kSplit><<<static_cast<unsigned int>(count), kThreads, bytes, stream>>>(
      rx, ry, rz, ld, lum, c, trips, count, grad, partial);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// rx, ry, rz: [count] directions; ld, lum: [3] on the device; consts: the
// 18 host floats of Consts; trips: the view steps (1..1024); split: 1 or 4,
// how torch.sum splits a sun march's 96 steps at this count; out [3, count].
int pim_sky_bake(const float* rx, const float* ry, const float* rz, const float* ld,
                 const float* lum, const float* consts, int trips, int split, long long count,
                 float* out, void* stream_ptr) {
  Consts c;
  std::memcpy(&c, consts, sizeof(Consts));
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (split == 4) return launch_bake<4>(rx, ry, rz, ld, lum, c, trips, count, out, stream);
  if (split == 1) return launch_bake<1>(rx, ry, rz, ld, lum, c, trips, count, out, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

// As pim_sky_bake, with grad [3, count] (d loss / d out); partial [count, 6]
// float64: each direction's d loss / d (light_dir, luminance).
int pim_sky_bake_bwd(const float* rx, const float* ry, const float* rz, const float* ld,
                     const float* lum, const float* consts, int trips, int split,
                     long long count, const float* grad, double* partial, void* stream_ptr) {
  Consts c;
  std::memcpy(&c, consts, sizeof(Consts));
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (split == 4) {
    return launch_bake_bwd<4>(rx, ry, rz, ld, lum, c, trips, count, grad, partial, stream);
  }
  if (split == 1) {
    return launch_bake_bwd<1>(rx, ry, rz, ld, lum, c, trips, count, grad, partial, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// out [6] float32: partial [count, 6] summed over the directions.
int pim_sky_grad_sum(const double* partial, long long count, float* out, void* stream_ptr) {
  sky_grad_sum_kernel<<<1, kSumThreads, 0, static_cast<cudaStream_t>(stream_ptr)>>>(partial,
                                                                                     count, out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
