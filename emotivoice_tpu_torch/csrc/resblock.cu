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
// read from L2 through a shared-memory chunk (one unit's weights, 5.8 MB f32
// at C=256 k=11, do not fit on an SM). The convs run on the f32 CUDA cores
// in both storage types; moving them to wgmma is a later step.

#include "conv_tile.cuh"

namespace evt {

template <int C, typename T>
__global__ void __launch_bounds__(kThreads)
residual_unit_kernel(const T* __restrict__ x, const T* __restrict__ w1,
                     const T* __restrict__ b1, const T* __restrict__ w2,
                     const T* __restrict__ b2, T* __restrict__ y, int T_len,
                     int K, int d, int tile) {
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

template <int C, typename T>
static int launch(const void* x, const void* w1, const void* b1, const void* w2,
                  const void* b2, void* y, int B, int T_len, int K, int d,
                  int tile, cudaStream_t stream) {
  const int h1 = (K - 1) / 2 * d, h2 = (K - 1) / 2;
  const size_t smem =
      sizeof(float) * C * ((size_t)(tile + 2 * (h1 + h2)) + (tile + 2 * h2) + kCiChunk);
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
                      int K, int d, int tile, cudaStream_t s) {
  switch (C) {
    case 32: return launch<32, T>(x, w1, b1, w2, b2, y, B, T_len, K, d, tile, s);
    case 64: return launch<64, T>(x, w1, b1, w2, b2, y, B, T_len, K, d, tile, s);
    case 128: return launch<128, T>(x, w1, b1, w2, b2, y, B, T_len, K, d, tile, s);
    case 256: return launch<256, T>(x, w1, b1, w2, b2, y, B, T_len, K, d, tile, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace evt

// Name of a CUDA error code, for the Python wrappers' messages.
extern "C" const char* evt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// Plain C entry point (loaded with ctypes). Returns cudaGetLastError() after
// the launch, or cudaErrorInvalidValue for an unsupported C.
extern "C" int evt_residual_unit(const void* x, const void* w1, const void* b1,
                                 const void* w2, const void* b2, void* y, int B,
                                 int T_len, int C, int K, int d, int tile,
                                 int is_bf16, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16)
    return evt::dispatch_c<__nv_bfloat16>(C, x, w1, b1, w2, b2, y, B, T_len, K, d, tile, s);
  return evt::dispatch_c<float>(C, x, w1, b1, w2, b2, y, B, T_len, K, d, tile, s);
}
