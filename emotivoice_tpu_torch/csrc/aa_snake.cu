// Anti-aliased SnakeBeta of BigVGAN-v2 for Hopper (sm_90a): the generator's
// `Activation1d` (models/bigvgan.py), before every convolution of its AMP
// blocks and before conv_post, 109 launches a generator call.
//
// Replaces no TPU kernel: the JAX package has no BigVGAN. It is added
// because the plain chain (ops/cuda/aa_snake.py `aa_snake_plain`) is about
// eight launches an activation (replicate pad, a depthwise transposed conv,
// a scale, a crop, the snake's element-wise ops over the doubled signal, a
// pad, a strided depthwise conv), each passing over the tensor or its
// doubled copy in device memory.
//
//   u[m] = 2 sum_i x[clamp(i)] f_up[m + 5 - 2i]              m < 2T  (x2 up)
//   s[m] = u[m] + 1 / (exp(beta_log) + 1e-9) sin^2(exp(alpha_log) u[m])
//   y[q] = sum_k f_down[k] s[clamp(2q + k - 5)]               q < T   (x2 down)
//
// with clamp to the row's ends (replicate padding of x and of s, the
// tensor's ends, not a request's) and the 12-tap Kaiser-windowed sinc
// filters of BigVGAN's `alias_free_activation`.
//
// Bound on the H100: bytes. An output takes 24 multiply-adds and two sines
// against 2 + 2 bytes in bf16 (x read once, y written once), ~15 FLOP a
// byte, far below the CUDA cores' balance (~20 in f32 FMA, more counting
// the sine's range reduction), so the design keeps the doubled signal out of
// device memory and spends few instructions an output.
//
// Design: the generator keeps its activations time-major, (B, C, T) in
// memory (the (B, T, C) tensors of the port are views of cuDNN's NCW
// outputs), so a row (b, c) is contiguous. One block of kThreads threads
// takes kTile outputs of one row: it stages x[q0 - 6, q0 + kTile + 6) in
// shared memory as f32, replicated past the row's ends (coalesced loads;
// the halo comes from the neighbouring tiles' data, so tile seams are
// exact). Each thread then walks kPerThread consecutive outputs with two
// register windows: the six x samples that the next pair of up-sampled
// values (odd phase, even phase) share, and the twelve snake values the
// next output's down filter reads; each output adds one x sample and two
// snake values. A warp with a thread whose outputs reach within three
// samples of a row end takes the same walk with the end's values put in
// where the padding repeats them (whole warps: no divergence). The outputs go through
// shared memory (padded a float every 32, as the staged x, so that the
// threads' strided walks are free of bank conflicts) and leave coalesced.
// All arithmetic is f32 in registers: exp(alpha_log) and the reciprocal of
// exp(beta_log) + 1e-9 once a thread, the sine after a three-part
// Cody-Waite reduction by pi (sin^2 has period pi) on the SFU's __sinf,
// accurate to ~4e-7 on [-pi/2, pi/2].

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace evt {
namespace aa {

constexpr int kTaps = 12;                  // filter taps, up and down
constexpr int kHalo = 6;                   // x samples a tile reads past each end
constexpr int kPerThread = 32;             // consecutive outputs a thread walks
constexpr int kThreads = 128;
constexpr int kTile = kThreads * kPerThread;
constexpr int kStaged = kTile + 2 * kHalo;

__host__ __device__ constexpr int padded(int n) { return n + (n >> 5); }

constexpr float kInvPi = 0.318309886183790671538f;
constexpr float kPiA = 3.140625f;  // pi in three parts: exact products with small k
constexpr float kPiB = 9.67502593994140625e-4f;
constexpr float kPiC = 1.509957990978376432e-7f;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

__device__ __forceinline__ float snake(float u, float alpha, float inv_beta) {
  const float z = alpha * u;
  const float k = rintf(z * kInvPi);
  float r = fmaf(-k, kPiA, z);
  r = fmaf(-k, kPiB, r);
  r = fmaf(-k, kPiC, r);
  const float s = __sinf(r);
  return fmaf(inv_beta, s * s, u);
}

struct Filters {
  float up_odd[6];   // 2 f_up[10 - 2j]: u[2p + 1] from x[p - 2 + j]
  float up_even[6];  // 2 f_up[11 - 2j]: u[2p] from x[p - 3 + j]
  float down[kTaps];
};

// u at an up-sampled index mc in [0, 2T), from the staged x (index of x
// sample i: i - base)
__device__ __forceinline__ float up_at(const float* xs, int base, int mc, const Filters& f) {
  const int p = mc >> 1;
  float u = 0.f;
  if (mc & 1) {
#pragma unroll
    for (int j = 0; j < 6; ++j) u = fmaf(f.up_odd[j], xs[padded(p - 2 + j - base)], u);
  } else {
#pragma unroll
    for (int j = 0; j < 6; ++j) u = fmaf(f.up_even[j], xs[padded(p - 3 + j - base)], u);
  }
  return u;
}

// Outputs qa .. qa + kPerThread - 1 of the tile into ys (tile-relative).
// A pair of up-sampled values (2p + 1, 2p + 2) comes from the register
// window x[p - 2 .. p + 3] (the staged x is already clamped to the row).
// EDGE: some of the snake values the outputs read lie past a row end,
// where the replicate padding of s repeats s[0] or s[2T - 1]: those
// positions take u[0] (`u_first`) or u[2T - 1] (`u_last`) instead.
template <bool EDGE>
__device__ __forceinline__ void walk(const float* xs, float* ys, int base, int qa, int q0,
                                     int len, const Filters& f, float alpha, float inv_beta,
                                     float u_first, float u_last) {
  float xw[6];
  float sw[kTaps];
#pragma unroll
  for (int j = 1; j < 6; ++j) xw[j] = xs[padded(qa - 6 + j - base)];
#pragma unroll
  for (int step = 0; step < kPerThread + 5; ++step) {
    const int p = qa - 3 + step;  // the pair (2p + 1, 2p + 2)
#pragma unroll
    for (int j = 0; j < 5; ++j) xw[j] = xw[j + 1];
    xw[5] = xs[padded(p + 3 - base)];
    float uo = 0.f, ue = 0.f;
#pragma unroll
    for (int j = 0; j < 6; ++j) {
      uo = fmaf(f.up_odd[j], xw[j], uo);
      ue = fmaf(f.up_even[j], xw[j], ue);
    }
    if (EDGE) {
      const int last = 2 * len - 1;
      uo = 2 * p + 1 < 0 ? u_first : (2 * p + 1 > last ? u_last : uo);
      ue = 2 * p + 2 < 0 ? u_first : (2 * p + 2 > last ? u_last : ue);
    }
#pragma unroll
    for (int j = 0; j < kTaps - 2; ++j) sw[j] = sw[j + 2];
    sw[kTaps - 2] = snake(uo, alpha, inv_beta);
    sw[kTaps - 1] = snake(ue, alpha, inv_beta);
    if (step >= 5) {  // sw holds s[2q - 5 .. 2q + 6] for q = qa + step - 5
      float y0 = 0.f, y1 = 0.f;  // two chains of multiply-adds, not one of twelve
#pragma unroll
      for (int k = 0; k < kTaps; k += 2) {
        y0 = fmaf(f.down[k], sw[k], y0);
        y1 = fmaf(f.down[k + 1], sw[k + 1], y1);
      }
      ys[padded(qa + step - 5 - q0)] = y0 + y1;
    }
  }
}

// x, y: rows x len, row-major (row = b * C + c); alpha_log, beta_log: (C,)
// f32; up, down: (kTaps,) f32.
template <typename T>
__global__ void __launch_bounds__(kThreads)
aa_snake_kernel(const T* __restrict__ x, const float* __restrict__ alpha_log,
                const float* __restrict__ beta_log, const float* __restrict__ up,
                const float* __restrict__ down, T* __restrict__ y, int C, int len, int tiles) {
  __shared__ float xs[padded(kStaged) + 1];
  __shared__ float ys[padded(kTile) + 1];
  const int row = blockIdx.x / tiles;
  const int q0 = (blockIdx.x - row * tiles) * kTile;
  const int base = q0 - kHalo;
  const T* xr = x + (int64_t)row * len;
  // all of a thread's loads in flight at once, then their stores
  constexpr int kLoads = (kStaged + kThreads - 1) / kThreads;
  float staged[kLoads];
#pragma unroll
  for (int j = 0; j < kLoads; ++j) {
    const int n = threadIdx.x + j * kThreads;
    staged[j] = n < kStaged ? to_f32(xr[min(max(base + n, 0), len - 1)]) : 0.f;
  }
#pragma unroll
  for (int j = 0; j < kLoads; ++j) {
    const int n = threadIdx.x + j * kThreads;
    if (n < kStaged) xs[padded(n)] = staged[j];
  }
  Filters f;
#pragma unroll
  for (int j = 0; j < 6; ++j) {
    f.up_odd[j] = 2.f * __ldg(up + 10 - 2 * j);
    f.up_even[j] = 2.f * __ldg(up + 11 - 2 * j);
  }
#pragma unroll
  for (int k = 0; k < kTaps; ++k) f.down[k] = __ldg(down + k);
  const int c = row % C;
  const float alpha = expf(__ldg(alpha_log + c));
  const float inv_beta = 1.f / (expf(__ldg(beta_log + c)) + 1e-9f);
  __syncthreads();
  // u at the row's ends, for the pairs that reach past them: the tiles with
  // outputs within three samples of an end (the same for a whole block)
  const float u_first = q0 == 0 ? up_at(xs, base, 0, f) : 0.f;
  const float u_last = q0 + kTile + 3 > len ? up_at(xs, base, 2 * len - 1, f) : 0.f;
  const int qa = q0 + threadIdx.x * kPerThread;
  // a warp that holds a thread near a row end walks with the end's fix-ups
  const bool edge = __any_sync(0xffffffffu, qa < 3 || qa + kPerThread + 3 > len);
  if (qa < len) {
    if (edge)
      walk<true>(xs, ys, base, qa, q0, len, f, alpha, inv_beta, u_first, u_last);
    else
      walk<false>(xs, ys, base, qa, q0, len, f, alpha, inv_beta, u_first, u_last);
  }
  __syncthreads();
  T* yr = y + (int64_t)row * len + q0;
  const int n_out = min(kTile, len - q0);
  for (int n = threadIdx.x; n < n_out; n += kThreads) store(yr + n, ys[padded(n)]);
}

template <typename T>
int launch(const void* x, const void* alpha_log, const void* beta_log, const void* up,
           const void* down, void* y, int rows, int C, int len, cudaStream_t stream) {
  if (rows < 1 || C < 1 || len < 1 || rows % C) return (int)cudaErrorInvalidValue;
  const int tiles = (len + kTile - 1) / kTile;
  const int64_t blocks = (int64_t)rows * tiles;
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  aa_snake_kernel<T><<<(unsigned)blocks, kThreads, 0, stream>>>(
      (const T*)x, (const float*)alpha_log, (const float*)beta_log, (const float*)up,
      (const float*)down, (T*)y, C, len, tiles);
  return (int)cudaGetLastError();
}

}  // namespace aa
}  // namespace evt

// Plain C entry points (loaded with ctypes); each returns cudaGetLastError()
// after the launch, or cudaErrorInvalidValue for an unsupported argument.
// x and y hold `rows` = B * C rows of `len` samples (the (B, C, T) memory of
// a time-major (B, T, C) tensor).
extern "C" int evt_aa_snake_bf16(const void* x, const void* alpha_log, const void* beta_log,
                                 const void* up, const void* down, void* y, int rows, int C,
                                 int len, void* stream) {
  return evt::aa::launch<__nv_bfloat16>(x, alpha_log, beta_log, up, down, y, rows, C, len,
                                        (cudaStream_t)stream);
}

extern "C" int evt_aa_snake_f32(const void* x, const void* alpha_log, const void* beta_log,
                                const void* up, const void* down, void* y, int rows, int C,
                                int len, void* stream) {
  return evt::aa::launch<float>(x, alpha_log, beta_log, up, down, y, rows, C, len,
                                (cudaStream_t)stream);
}
