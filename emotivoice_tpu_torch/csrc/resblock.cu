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
// bf16 (mma_conv.cuh): mma.sync m16n8k16 from swizzled tiles, weights
// through a 2-stage cp.async ring of 64 (C=256) or 128 (C=128) rows of W
// that streams on from conv1 into conv2; sums are rounded to bf16 where the
// JAX reference rounds (after each conv, after its bias add, after the
// residual add). The wrapper's tile (unit_tile) reuses each weight byte a
// block streams from L2 for as many rows as shared memory allows, and among
// such tiles fills the card's waves best: at least 64 rows at C=256 and 128
// at C=128 (96 and 246-254 for the bench bucket).
//
// f32 (wgmma_conv_f32.cuh): wgmma on a 3xTF32 split, three products per f32
// product, which keeps the f32 path's 2e-4 agreement with its plain version.
// The x tile and its halo arrive by TMA from a 3D map over (B, T, C), whose
// zero fill is the 'same' padding at the sequence ends; weights stream by
// TMA through the producer's ring, (2K, C_out, C_in) K-major from the
// wrapper, from conv1 on into conv2. Shared memory bounds this path at
// C=256: rows are 1 KB, so a tile beside a ring of 16 KB stages holds at most
// ~180 rows. Two things stretch it: the intermediate overwrites the x tile
// once conv1 has read it, pass by pass (the residual add reads x again from
// device memory, 1 KB a row against 5.8 MB of weights a block), and the tile
// is planned in whole 64-row wgmma tiles against the card's waves
// (unit_tile): 118-126 rows at C=256 and at C=128, each weight byte
// a block streams from L2 serving about twice the rows of the mma.sync
// tiles (54-94). The L2 stream, ~1/192 byte per tensor-core FLOP, stays
// below 2.6 TB/s at the full TF32 rate, under what the L2 delivers, so no
// cluster multicasts the weights.

#include "conv_tile.cuh"
#include "mma_conv.cuh"
#include "wgmma_conv_f32.cuh"

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
  void (*kern)(const T*, const T*, const T*, const T*, const T*, T*, int, int, int, int) =
      residual_unit_kernel<C, T>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((T_len + tile - 1) / tile, B);
  kern<<<grid, kThreads, smem, stream>>>(
      (const T*)x, (const T*)w1, (const T*)b1, (const T*)w2, (const T*)b2, (T*)y,
      T_len, K, d, tile);
  return (int)cudaGetLastError();
}

// f32: the kernel above on the wgmma core, two consumer warpgroups and a
// producer warpgroup. x arrives by TMA (x_map) as rows t0 - h1 - h2 .. of the
// tile; W is (2K, C_out, C_in), conv1's taps first (w_map).
template <int C, typename T>
__global__ void __launch_bounds__(kWgBlock, 1)
residual_unit_kernel(const __grid_constant__ CUtensorMap x_map,
                     const __grid_constant__ CUtensorMap w_map, const float* __restrict__ x,
                     const float* __restrict__ b1, const float* __restrict__ b2,
                     float* __restrict__ y, int T_len, int K, int d, int tile, int box_rows,
                     int n_box, int stages) {
  static_assert(std::is_same<T, float>::value, "the wgmma core is the f32 path");
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const int h1 = (K - 1) / 2 * d;
  const int h2 = (K - 1) / 2;
  const int rows = n_box * box_rows;
  // 1024-byte aligned for the 128-byte swizzle
  unsigned char* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  // x, global row t0 - h1 - h2 + i; after conv1: lrelu(conv1 + b1), global row t0 - h2 + i
  const ActTile xs{smem_u32(base), reinterpret_cast<char*>(base), rows};
  WgRing<C> ring;
  ring.base = xs.addr + (C / kSlab) * rows * 128;
  ring.bars = ring.base + stages * 2 * WgTile<C>::kStageBytes;
  ring.stages = stages;
  const uint32_t x_bar = ring.bars + 8 * 3 * stages;

  const int b = blockIdx.y;
  const int t0 = blockIdx.x * tile;
  if (threadIdx.x == 0) {
    ring.init();
    sm90::mbar_init(x_bar, 1);
    sm90::mbar_fence_init();
  }
  __syncthreads();

  const int n_mid = tile + 2 * h2;
  if (threadIdx.x >= kConsumers) {  // the producer warpgroup
    const int i = threadIdx.x - kConsumers;
    if (i == 0) {
      ring.produce(&w_map, 0, K, n_mid);
      ring.produce(&w_map, K, K, tile);
    } else if (i >= 32) {
      ring.make_tails(conv_chunks<C>(K, n_mid) + conv_chunks<C>(K, tile), i - 32);
    }
  } else {  // the consumer warpgroups
    if (threadIdx.x == 0) load_act_tile<C>(xs, &x_map, x_bar, b, t0 - h1 - h2, box_rows, n_box);
    sm90::mbar_wait(x_bar, 0);

    wg_conv<C, true, true>(xs, 0, n_mid, K, d, b1, ring, [&](int m, int co, float2 v) {
      const int g = t0 - h2 + m;
      xs.pair(m, co) = (g >= 0 && g < T_len) ? lrelu2(v) : make_float2(0.f, 0.f);
    });

    const float* xb = x + (size_t)b * T_len * C;
    float* yb = y + (size_t)b * T_len * C;
    wg_conv<C, false, false>(xs, 0, tile, K, 1, b2, ring, [&](int r, int co, float2 v) {
      const int g = t0 + r;
      if (g < T_len) {
        const float2 xv = *reinterpret_cast<const float2*>(xb + (size_t)g * C + co);
        *reinterpret_cast<float2*>(yb + (size_t)g * C + co) = add2(xv, v);
      }
    });
  }
}

// Shared memory of the f32 kernel: the x tile (rows per slab, reused for the
// intermediate), the ring, its barriers and x's, and the alignment slack.
template <int C> size_t unit_smem_f32(int rows, int stages) {
  return 1024 + (size_t)C * 4 * rows + ring_bytes<C>(stages) + 8;
}

template <int C>
static int launch_f32(const void* x, const void* w, const void* b1, const void* b2, void* y,
                      int B, int T_len, int K, int d, int tile, int box_rows, int n_box,
                      int stages, int kmt, int kc, cudaStream_t stream) {
  const int h1 = (K - 1) / 2 * d, h2 = (K - 1) / 2;
  if (kmt != WgCfg<C>::kMT || kc != WgCfg<C>::kKC || stages < 2 ||
      stages > WgCfg<C>::kStages || box_rows % 8 || box_rows > 256 ||
      n_box * box_rows < tile + 2 * (h1 + h2))
    return (int)cudaErrorInvalidValue;
  CUtensorMap w_map, x_map;
  cudaError_t err = encode_maps<C>(&w_map, w, 2 * K, &x_map, x, B, T_len, box_rows);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = unit_smem_f32<C>(n_box * box_rows, stages);
  void (*kern)(const CUtensorMap, const CUtensorMap, const float*, const float*, const float*,
               float*, int, int, int, int, int, int, int) = residual_unit_kernel<C, float>;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((T_len + tile - 1) / tile, B);
  kern<<<grid, kWgBlock, smem, stream>>>(x_map, w_map, (const float*)x, (const float*)b1,
                                         (const float*)b2, (float*)y, T_len, K, d, tile,
                                         box_rows, n_box, stages);
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

// Plain C entry points (loaded with ctypes); each returns cudaGetLastError()
// after the launch, or cudaErrorInvalidValue for an unsupported argument.
// bf16: `kc` is the wrapper's weight rows per ring stage, which must be the
// MmaCfg<C, bf16>::kKC the kernel was built with.
extern "C" int evt_residual_unit_bf16(const void* x, const void* w1, const void* b1,
                                      const void* w2, const void* b2, void* y, int B,
                                      int T_len, int C, int K, int d, int tile, int kc,
                                      void* stream) {
  return evt::dispatch_c<__nv_bfloat16>(C, x, w1, b1, w2, b2, y, B, T_len, K, d, tile, kc,
                                        (cudaStream_t)stream);
}

// f32: w is (2K, C, C) K-major, conv1's taps then conv2's; x's tile arrives
// in n_box boxes of box_rows rows; `stages` ring stages; kmt and kc must be
// the WgCfg<C> the kernel was built with.
extern "C" int evt_residual_unit_f32(const void* x, const void* w, const void* b1,
                                     const void* b2, void* y, int B, int T_len, int C, int K,
                                     int d, int tile, int box_rows, int n_box, int stages,
                                     int kmt, int kc, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (C) {
#define EVT_CASE(c) \
  case c: return evt::launch_f32<c>(x, w, b1, b2, y, B, T_len, K, d, tile, box_rows, n_box, stages, kmt, kc, s);
    EVT_CASE(32) EVT_CASE(64) EVT_CASE(128) EVT_CASE(256)
#undef EVT_CASE
    default: return (int)cudaErrorInvalidValue;
  }
}
