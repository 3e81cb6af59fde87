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
// Both dtypes run the same block: two consumer warpgroups run both convs
// with wgmma, a producer thread streams the weights by TMA through an
// mbarrier ring from conv1 on into conv2, and the x tile and its halo arrive
// by TMA from a 3D map over (B, T, C), whose zero fill is the 'same' padding
// at the sequence ends. The intermediate overwrites the x tile once conv1
// has read it, pass by pass (the residual add reads x again from device
// memory, C * sizeof(T) bytes a row against up to 5.8 MB of weights a
// block), and the tile is planned in whole 64-row wgmma tiles against the
// card's waves (unit_tile).
//
// bf16 (wgmma_conv_bf16.cuh): wgmma m64nNk16, one product per bf16 product;
// each conv's HIO weights are read MN-major through their own map, as they
// are; sums are rounded to bf16 where the JAX reference rounds (after each
// conv, after its bias add, after the residual add). Rows are 512 bytes at
// C=256, so a tile beside a ring of 16 KB stages holds up to ~300 rows, and
// conv1 takes up to three passes of 128 rows (unit_tile). conv2's output
// overwrites the intermediate pass by pass too, and the block then writes y
// = x + out in 16-byte chunks, coalesced: adding x in the epilogue, 4 bytes
// a thread at 8 rows a warp, cost 0.7 ms of 6.3 per generator call on an
// H100 (PERF.md).
//
// f32 (wgmma_conv_f32.cuh): wgmma on a 3xTF32 split, three products per f32
// product, which keeps the f32 path's 2e-4 agreement with its plain version;
// weights (2K, C_out, C_in) K-major from the wrapper, tf32 B being K-major
// only. Shared memory bounds this path at C=256: rows are 1 KB, so a tile
// beside a ring of 16 KB stages holds at most ~180 rows: 118-126 rows at
// C=256 and at C=128. The L2 weight stream, ~1/192 byte per tensor-core
// FLOP, stays below 2.6 TB/s at the full TF32 rate, under what the L2
// delivers, so no cluster multicasts the weights.

#include "conv_tile.cuh"
#include "wgmma_conv_bf16.cuh"
#include "wgmma_conv_f32.cuh"

namespace evt {

// Consumer threads: v = load(i), then store(i, v), for every 16-byte chunk
// i < n of a tile, kBatch chunks a thread at a time: the device-memory loads
// of a batch are in flight together, where a plain loop waits for each (its
// stores may alias the next load). For the bf16 unit's residual add that
// took 5.58 ms to 5.21 per generator call on an H100 (PERF.md); the MRF
// stage's chain sum, with more registers live, was fastest unbatched.
template <int kBatch, typename Load, typename Store>
__device__ __forceinline__ void batched_chunks(int n, Load load, Store store) {
  for (int i0 = threadIdx.x; i0 < n; i0 += kBatch * kConsumers) {
    uint4 v[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u)
      if (i0 + u * kConsumers < n) v[u] = load(i0 + u * kConsumers);
#pragma unroll
    for (int u = 0; u < kBatch; ++u)
      if (i0 + u * kConsumers < n) store(i0 + u * kConsumers, v[u]);
  }
}

// bf16: two consumer warpgroups and a producer warpgroup. x arrives by TMA
// (x_map) as rows t0 - h1 - h2 .. of the tile; conv1's and conv2's HIO
// weights each have their own map (w1_map, w2_map).
template <int C, typename T>
__global__ void __launch_bounds__(kWgBlock, 1)
residual_unit_kernel(const __grid_constant__ CUtensorMap x_map,
                     const __grid_constant__ CUtensorMap w1_map,
                     const __grid_constant__ CUtensorMap w2_map, const bf16* __restrict__ x,
                     const bf16* __restrict__ b1, const bf16* __restrict__ b2,
                     bf16* __restrict__ y, int T_len, int K, int d, int tile, int box_rows,
                     int n_box, int stages) {
  static_assert(std::is_same<T, bf16>::value, "the bf16 core's kernel");
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const int h1 = (K - 1) / 2 * d;
  const int h2 = (K - 1) / 2;
  const int rows = n_box * box_rows;
  // 1024-byte aligned for the swizzle
  unsigned char* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  // x, global row t0 - h1 - h2 + i; after conv1: lrelu(conv1 + b1), global row t0 - h2 + i
  const ActTileBf16<C> xs{smem_u32(base), reinterpret_cast<char*>(base), rows};
  RingBf16<C> ring;
  ring.base = xs.addr + 2 * C * rows;
  ring.bars = ring.base + stages * WgTileBf16<C>::kStageBytes;
  ring.stages = stages;
  const uint32_t x_bar = ring.bars + 16 * stages;

  const int b = blockIdx.y;
  const int t0 = blockIdx.x * tile;
  if (threadIdx.x == 0) {
    ring.init();
    sm90::mbar_init(x_bar, 1);
    sm90::mbar_fence_init();
  }
  __syncthreads();

  const int n_mid = tile + 2 * h2;
  if (threadIdx.x >= kConsumers) {  // the producer warpgroup: one thread
    if (threadIdx.x == kConsumers) {
      ring.produce(&w1_map, K, n_mid);
      ring.produce(&w2_map, K, tile);
    }
  } else {  // the consumer warpgroups
    if (threadIdx.x == 0) load_act_tile_bf16<C>(xs, &x_map, x_bar, b, t0 - h1 - h2, box_rows, n_box);
    sm90::mbar_wait(x_bar, 0);

    // lrelu(conv1 + b1), zero at rows outside [0, T)
    wg_conv_bf16<C, true, true>(xs, 0, n_mid, K, d, b1, ring,
                                EpiBf16<C, true, false, true>{xs, 0, t0 - h2, T_len});

    // conv2's output overwrites the intermediate pass by pass as conv1's did
    // x; then y = x + out in 16-byte chunks, read and written coalesced
    wg_conv_bf16<C, false, true>(xs, 0, tile, K, 1, b2, ring,
                                 EpiBf16<C, false, false, false>{xs, 0, t0, T_len});
    constexpr int kChunks = C / 8;  // 16-byte chunks of a row
    const bf16* xb = x + (size_t)b * T_len * C + (size_t)t0 * C;
    bf16* yb = y + (size_t)b * T_len * C + (size_t)t0 * C;
    const int n_rows = min(tile, T_len - t0);
    batched_chunks<8>(
        n_rows * kChunks, [&](int i) { return *reinterpret_cast<const uint4*>(xb + i * 8); },
        [&](int i, uint4 xv) {
          const uint4 out =
              *reinterpret_cast<const uint4*>(xs.ptr + xs.off(i / kChunks, i % kChunks));
          *reinterpret_cast<uint4*>(yb + i * 8) = add_chunk(xv, out);
        });
  }
}

// Shared memory of the bf16 kernel: the x tile (rows per slab, reused for
// the intermediate), the ring, its barriers and x's, and the alignment slack.
template <int C> size_t unit_smem_bf16(int rows, int stages) {
  return 1024 + (size_t)C * 2 * rows + ring_bytes_bf16<C>(stages) + 8;
}

template <int C>
static int launch_bf16(const void* x, const void* w1, const void* b1, const void* w2,
                       const void* b2, void* y, int B, int T_len, int K, int d, int tile,
                       int box_rows, int n_box, int stages, int kmt, int kc,
                       cudaStream_t stream) {
  const int h1 = (K - 1) / 2 * d, h2 = (K - 1) / 2;
  if (kmt != WgCfgBf16<C>::kMT || kc != WgCfgBf16<C>::kKC || stages < 2 ||
      stages > WgCfgBf16<C>::kStages || box_rows % 8 || box_rows > 256 ||
      n_box * box_rows < tile + 2 * (h1 + h2))
    return (int)cudaErrorInvalidValue;
  CUtensorMap x_map, w1_map, w2_map;
  cudaError_t err = encode_act_map_bf16<C>(&x_map, x, B, T_len, box_rows);
  if (err == cudaSuccess) err = encode_weight_map_bf16<C>(&w1_map, w1, K);
  if (err == cudaSuccess) err = encode_weight_map_bf16<C>(&w2_map, w2, K);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = unit_smem_bf16<C>(n_box * box_rows, stages);
  void (*kern)(const CUtensorMap, const CUtensorMap, const CUtensorMap, const bf16*, const bf16*,
               const bf16*, bf16*, int, int, int, int, int, int, int) = residual_unit_kernel<C, bf16>;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((T_len + tile - 1) / tile, B);
  kern<<<grid, kWgBlock, smem, stream>>>(x_map, w1_map, w2_map, (const bf16*)x, (const bf16*)b1,
                                         (const bf16*)b2, (bf16*)y, T_len, K, d, tile, box_rows,
                                         n_box, stages);
  return (int)cudaGetLastError();
}

// f32: the same block on the 3xTF32 core. x arrives by TMA (x_map) as rows
// t0 - h1 - h2 .. of the tile; W is (2K, C_out, C_in), conv1's taps first
// (w_map).
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

}  // namespace evt

// Name of a CUDA error code, for the Python wrappers' messages.
extern "C" const char* evt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// Plain C entry points (loaded with ctypes); each returns cudaGetLastError()
// after the launch, or cudaErrorInvalidValue for an unsupported argument.
// bf16: w1 and w2 are HIO (K, C, C) as they are; x's tile arrives in n_box
// boxes of box_rows rows; `stages` ring stages; kmt and kc must be the
// WgCfgBf16<C> the kernel was built with.
extern "C" int evt_residual_unit_bf16(const void* x, const void* w1, const void* b1,
                                      const void* w2, const void* b2, void* y, int B,
                                      int T_len, int C, int K, int d, int tile, int box_rows,
                                      int n_box, int stages, int kmt, int kc, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (C) {
#define EVT_CASE(c) \
  case c: return evt::launch_bf16<c>(x, w1, b1, w2, b2, y, B, T_len, K, d, tile, box_rows, n_box, stages, kmt, kc, s);
    EVT_CASE(32) EVT_CASE(64) EVT_CASE(128) EVT_CASE(256)
#undef EVT_CASE
    default: return (int)cudaErrorInvalidValue;
  }
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
