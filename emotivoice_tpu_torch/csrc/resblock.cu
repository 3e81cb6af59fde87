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
// and written: hundreds of FLOP per byte or more, far above the card's
// balance points of ~295 FLOP/byte (bf16 tensor cores) and ~49 (f32 as 3xTF32
// on the tensor cores: 495 / 3 TFLOP/s over 3.35 TB/s).
//
// Design: each block owns one (batch row, time tile). It reads the tile plus
// a halo of (k-1)/2*(d+1) rows per side into shared memory once, computes
// conv1 over tile + 2*(k-1)/2 rows into a shared-memory intermediate, zeroes
// the intermediate rows that lie outside [0, T) (a haloed row there would
// otherwise be lrelu(b1); the JAX kernel's trap at resblock.py:69-79), then
// runs conv2, adds b2 and the un-activated centre of x, and writes the tile
// to device memory once. The intermediate never leaves the SM. Weights are
// read from L2 through shared memory (one unit's weights, 2.9 MB in bf16 and
// 5.8 MB in f32 at C=256 k=11, do not fit on an SM).
//
// Both convs run on the tensor cores through mma_conv(): ldmatrix from
// swizzled tiles of x and of the intermediate in shared memory, weights
// through a cp.async ring that streams on from conv1 into conv2. The
// intermediate is stored as lrelu(conv1 + b1), so conv2 reads it as it is.
// conv1 covers one pass of the core's rows, and the wrapper's tile
// (unit_tile) is chosen per storage type so that a block reuses each weight
// byte it streams from L2 for as many rows as shared memory allows, and among
// such tiles the one that fills the card's waves best.
//
// bf16 (mma_conv.cuh): mma.sync m16n8k16, a 2-stage ring of 64 (C=256) or 128
// (C=128) rows of W; sums are rounded to bf16 where the JAX reference rounds
// (after each conv, after its bias add, after the residual add). Tiles of at
// least 64 rows at C=256 and 128 at C=128 (96 and 246-254 for the bench
// bucket).
//
// f32 (mma_conv_f32.cuh): mma.sync m16n8k8 on TF32 heads and tails, three
// products per f32 product (3xTF32), which keeps the f32 path's 2e-4
// agreement with its plain version where one TF32 product (10-bit mantissa)
// would break it. Rows are twice as wide, so tiles are 54-94 rows at C=256
// beside a 2-stage ring of 16 rows of W, and 166-190 at C=128 beside a 3-stage
// ring of 16 rows (the bench bucket's tiles).

#include "conv_tile.cuh"
#include "mma_conv.cuh"
#include "mma_conv_f32.cuh"

namespace evt {

template <int C, typename T>
__global__ void __launch_bounds__(kThreads)
residual_unit_kernel(const T* __restrict__ x, const T* __restrict__ w1,
                     const T* __restrict__ b1, const T* __restrict__ w2,
                     const T* __restrict__ b2, T* __restrict__ y, int T_len,
                     int K, int d, int tile) {
  using Pair = typename PairOf<T>::type;
  extern __shared__ float smem[];
  const int h1 = (K - 1) / 2 * d;
  const int h2 = (K - 1) / 2;
  const int n_x = tile + 2 * (h1 + h2);
  const int n_mid = tile + 2 * h2;
  T* xs = reinterpret_cast<T*>(smem);  // raw x, global row t0 - h1 - h2 + i
  T* mid = xs + n_x * C;               // lrelu(conv1 + b1), global row t0 - h2 + i
  WeightRing<T> ring{mid + n_mid * C, 0, false};  // MmaTile<C, T>::kRingElems

  const int b = blockIdx.y;
  const int t0 = blockIdx.x * tile;
  const T* xb = x + (size_t)b * T_len * C;
  T* yb = y + (size_t)b * T_len * C;

  // The x rows land before conv1's first chunk: theirs is the oldest group.
  load_rows_async<C>(xs, 0, xb, t0 - h1 - h2, n_x, T_len);

  mma_conv<C, true>(xs, 0, n_mid, w1, b1, K, d, ring, w2, K, [&](int m, int co, Pair v) {
    const int g = t0 - h2 + m;
    pair_at(mid + elem_at<C, T>(m, co)) = (g >= 0 && g < T_len) ? lrelu2(v) : zero2<T>();
  });

  const T* none = nullptr;
  mma_conv<C, false>(mid, 0, tile, w2, b2, K, 1, ring, none, 0, [&](int r, int co, Pair v) {
    const int g = t0 + r;
    if (g < T_len)
      pair_at(yb + (size_t)g * C + co) = add2(pair_at(xs + elem_at<C, T>(r + h1 + h2, co)), v);
  });
}

template <int C, typename T>
static int launch(const void* x, const void* w1, const void* b1, const void* w2,
                  const void* b2, void* y, int B, int T_len, int K, int d,
                  int tile, int kc, cudaStream_t stream) {
  const int h1 = (K - 1) / 2 * d, h2 = (K - 1) / 2;
  const size_t rows = (size_t)(tile + 2 * (h1 + h2)) + (tile + 2 * h2);
  if (kc != MmaCfg<C, T>::kKC) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(T) * (C * rows + MmaTile<C, T>::kRingElems);
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
// per ring stage, which must be the MmaCfg<C, T>::kKC the kernel was built
// with. Returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for an unsupported C or kc.
extern "C" int evt_residual_unit(const void* x, const void* w1, const void* b1,
                                 const void* w2, const void* b2, void* y, int B,
                                 int T_len, int C, int K, int d, int tile, int kc,
                                 int is_bf16, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16)
    return evt::dispatch_c<__nv_bfloat16>(C, x, w1, b1, w2, b2, y, B, T_len, K, d, tile, kc, s);
  return evt::dispatch_c<float>(C, x, w1, b1, w2, b2, y, B, T_len, K, d, tile, kc, s);
}
