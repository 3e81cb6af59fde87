// Fused HiFi-GAN ResBlock1 residual unit for Hopper (sm_90a).
//
// Replaces the TPU kernel emotivoice_tpu/ops/pallas/resblock.py
// (fused_residual_unit, body _residual_unit_kernel):
//
//   y = x + conv_{k,1}( lrelu( conv_{k,d}( lrelu(x) ) + b1 ) ) + b2
//
// with zero 'same' padding, leaky-ReLU slope 0.1 and f32 accumulation.
//
// Bound on the H100: operations. One unit does 4*K*C*C FLOP per row, 0.2 to
// 2.9 MFLOP at C = 128..256, against 2*C*sizeof(T) bytes of activation read
// and written: hundreds of FLOP per byte or more, far above the card's ~20 (f32
// CUDA cores) or ~295 (bf16 tensor cores) FLOP/byte balance points.
//
// Design: each block owns one (batch row, time tile). It reads the tile plus
// a halo of (k-1)/2*(d+1) rows per side into shared memory once, computes
// conv1 over tile + 2*(k-1)/2 rows into a shared-memory intermediate, zeroes
// the intermediate rows that lie outside [0, T) (a haloed row there would
// otherwise be lrelu(b1); the JAX kernel's trap at resblock.py:69-79), then
// runs conv2, adds b2 and the un-activated centre of x, and writes the tile
// to device memory once. The intermediate never leaves the SM. Weights are
// read from L2 through shared memory (one unit's weights, 2.9 MB bf16 at
// C=256 k=11, do not fit on an SM).
//
// bf16: both convs run on the tensor cores through mma_conv() (mma_conv.cuh:
// mma.sync m16n8k16, ldmatrix from swizzled bf16 tiles, weights through a
// 2-stage cp.async ring of 64 (C=256) or 128 (C=128) rows of W, streaming on
// from conv1 into conv2). x and the intermediate are bf16 in shared memory;
// the intermediate is stored as lrelu(round(round(conv1) + b1)), so conv2
// reads it as it is. conv1 covers one pass of the core's rows, and the
// wrapper's tile (unit_tile) is at least 64 rows at C=256 and 128 at C=128,
// so a block reuses each weight byte from L2 for that many rows; among such
// tiles it takes the one that fills the card's waves best (96 rows at
// C=256, 246-254 at C=128 for the bench bucket).
//
// f32: the CUDA-core loop conv_rows() (conv_tile.cuh), one f32 FMA per
// product. The tensor cores take f32 only as TF32, whose 10-bit mantissa
// would break the f32 path's 2e-4 agreement with its plain version.

#include <type_traits>

#include "conv_tile.cuh"
#include "mma_conv.cuh"

namespace evt {

template <int C>
__device__ __forceinline__ void unit_cuda_cores(
    const float* __restrict__ x, const float* __restrict__ w1, const float* __restrict__ b1,
    const float* __restrict__ w2, const float* __restrict__ b2, float* __restrict__ y, int T_len,
    int K, int d, int tile) {
  using T = float;
  extern __shared__ float smem[];
  const int h1 = (K - 1) / 2 * d;
  const int h2 = (K - 1) / 2;
  const int n_x = tile + 2 * (h1 + h2);
  const int n_mid = tile + 2 * h2;
  float* xs = smem;               // raw x, global row t0 - h1 - h2 + i
  float* mid = xs + n_x * C;      // lrelu(conv1 + b1), global row t0 - h2 + i
  float* wsm = mid + n_mid * C;   // weight chunk

  const int b = blockIdx.y;
  const int t0 = blockIdx.x * tile;
  const T* xb = x + (size_t)b * T_len * C;
  T* yb = y + (size_t)b * T_len * C;

  load_rows<C>(xs, xb, t0 - h1 - h2, n_x, T_len);

  conv_rows<C, true>(xs, n_mid, w1, K, d, wsm, [&](int m, int co, float acc) {
    const int g = t0 - h2 + m;
    const float v = round_to<T>(acc + to_f(b1[co]));
    mid[m * C + co] = (g >= 0 && g < T_len) ? lrelu(v) : 0.f;
  });

  conv_rows<C, false>(mid, tile, w2, K, 1, wsm, [&](int r, int co, float acc) {
    const int g = t0 + r;
    if (g < T_len) {
      const float v = round_to<T>(acc + to_f(b2[co]));
      yb[(size_t)g * C + co] = from_f<T>(xs[(r + h1 + h2) * C + co] + v);
    }
  });
}

template <int C>
__device__ __forceinline__ void unit_tensor_cores(
    const bf16* __restrict__ x, const bf16* __restrict__ w1, const bf16* __restrict__ b1,
    const bf16* __restrict__ w2, const bf16* __restrict__ b2, bf16* __restrict__ y, int T_len,
    int K, int d, int tile) {
  extern __shared__ float smem[];
  const int h1 = (K - 1) / 2 * d;
  const int h2 = (K - 1) / 2;
  const int n_x = tile + 2 * (h1 + h2);
  const int n_mid = tile + 2 * h2;
  bf16* xs = reinterpret_cast<bf16*>(smem);  // raw x, global row t0 - h1 - h2 + i
  bf16* mid = xs + n_x * C;                  // lrelu(conv1 + b1), global row t0 - h2 + i
  WeightRing ring{mid + n_mid * C, 0, false};  // MmaTile<C>::kRingElems

  const int b = blockIdx.y;
  const int t0 = blockIdx.x * tile;
  const bf16* xb = x + (size_t)b * T_len * C;
  bf16* yb = y + (size_t)b * T_len * C;

  // The x rows land before conv1's first chunk: theirs is the oldest group.
  load_rows_bf16<C>(xs, 0, xb, t0 - h1 - h2, n_x, T_len);

  mma_conv<C, true>(xs, 0, n_mid, w1, b1, K, d, ring, w2, K, [&](int m, int co, bf16x2 v) {
    const int g = t0 - h2 + m;
    pair_at(mid + elem_at<C>(m, co)) =
        (g >= 0 && g < T_len) ? lrelu2(v) : __float2bfloat162_rn(0.f);
  });

  mma_conv<C, false>(mid, 0, tile, w2, b2, K, 1, ring, nullptr, 0, [&](int r, int co, bf16x2 v) {
    const int g = t0 + r;
    if (g < T_len)
      pair_at(yb + (size_t)g * C + co) = __hadd2(pair_at(xs + elem_at<C>(r + h1 + h2, co)), v);
  });
}

template <int C, typename T>
__global__ void __launch_bounds__(kThreads)
residual_unit_kernel(const T* __restrict__ x, const T* __restrict__ w1,
                     const T* __restrict__ b1, const T* __restrict__ w2,
                     const T* __restrict__ b2, T* __restrict__ y, int T_len,
                     int K, int d, int tile) {
  if constexpr (std::is_same<T, float>::value)
    unit_cuda_cores<C>(x, w1, b1, w2, b2, y, T_len, K, d, tile);
  else
    unit_tensor_cores<C>(x, w1, b1, w2, b2, y, T_len, K, d, tile);
}

template <int C, typename T>
static int launch(const void* x, const void* w1, const void* b1, const void* w2,
                  const void* b2, void* y, int B, int T_len, int K, int d,
                  int tile, int kc, cudaStream_t stream) {
  const int h1 = (K - 1) / 2 * d, h2 = (K - 1) / 2;
  const size_t rows = (size_t)(tile + 2 * (h1 + h2)) + (tile + 2 * h2);
  size_t smem;
  if constexpr (std::is_same<T, float>::value) {
    smem = sizeof(float) * C * (rows + kCiChunk);
  } else {
    if (kc != MmaCfg<C>::kKC) return (int)cudaErrorInvalidValue;
    smem = sizeof(bf16) * (C * rows + MmaTile<C>::kRingElems);
  }
  auto kern = residual_unit_kernel<C, T>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((T_len + tile - 1) / tile, B);
  kern<<<grid, kThreads, smem, stream>>>(
      (const T*)x, (const T*)w1, (const T*)b1, (const T*)w2, (const T*)b2, (T*)y,
      T_len, K, d, tile);
  return (int)cudaGetLastError();
}

template <typename T>
static int dispatch_c(int C, const void* x, const void* w1, const void* b1,
                      const void* w2, const void* b2, void* y, int B, int T_len,
                      int K, int d, int tile, int kc, cudaStream_t s) {
  switch (C) {
    case 32: return launch<32, T>(x, w1, b1, w2, b2, y, B, T_len, K, d, tile, kc, s);
    case 64: return launch<64, T>(x, w1, b1, w2, b2, y, B, T_len, K, d, tile, kc, s);
    case 128: return launch<128, T>(x, w1, b1, w2, b2, y, B, T_len, K, d, tile, kc, s);
    case 256: return launch<256, T>(x, w1, b1, w2, b2, y, B, T_len, K, d, tile, kc, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace evt

// Name of a CUDA error code, for the Python wrappers' messages.
extern "C" const char* evt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// Plain C entry point (loaded with ctypes). `kc` is the wrapper's weight rows
// per ring stage of the bf16 path, which must be the MmaCfg<C>::kKC the
// kernel was built with (ignored for f32). Returns cudaGetLastError() after
// the launch, or cudaErrorInvalidValue for an unsupported C or kc.
extern "C" int evt_residual_unit(const void* x, const void* w1, const void* b1,
                                 const void* w2, const void* b2, void* y, int B,
                                 int T_len, int C, int K, int d, int tile, int kc,
                                 int is_bf16, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16)
    return evt::dispatch_c<__nv_bfloat16>(C, x, w1, b1, w2, b2, y, B, T_len, K, d, tile, kc, s);
  return evt::dispatch_c<float>(C, x, w1, b1, w2, b2, y, B, T_len, K, d, tile, kc, s);
}
