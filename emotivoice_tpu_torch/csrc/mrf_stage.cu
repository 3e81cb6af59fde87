// Fused HiFi-GAN multi-receptive-field (MRF) stage for Hopper (sm_90a).
//
// Replaces the TPU kernel emotivoice_tpu/ops/pallas/packed_stage.py
// (fused_mrf_stage, body _mrf_stage_kernel): the ResBlock1 chains of one
// upsample stage (k = 3/7/11, each d = 1/3/5 in the V1 topology) run over
// the same input, and their outputs are summed and divided by the number
// of chains. Each residual unit of a chain is
//
//   x = x + conv_{k,1}( lrelu( conv_{k,d}( lrelu(x) ) + b1 ) ) + b2
//
// The TPU kernel packs s = 128/C time steps into its 128 lanes and plans
// chunked gathers for that layout; none of that is carried over. This
// kernel takes the plain (B, T, C) activation.
//
// Bound on the H100: operations. A V1 stage does 252*C*C FLOP per row
// (18 convs of 2*K*C*C) against 2*C*sizeof(T) bytes read and written.
//
// Design: each block owns one (batch row, time tile) and runs every chain
// on it in shared memory. A chain's tile is read with that chain's halo,
// sum over its units of (k-1)/2*(d+1) rows per side (12 / 36 / 60 for
// k = 3 / 7 / 11), and shrinks by one unit's reach after each unit, so the
// last unit lands exactly on the tile. Rows outside [0, T) are held at zero
// in every conv input (the zero padding of each conv; the JAX validity mask
// at packed_stage.py:225-239). The 18 intermediates never leave the SM.
//
// Both dtypes run the same block: two consumer warpgroups run every conv
// with wgmma on the chain activation and the intermediate in shared memory,
// each chain's tile arrives by TMA from a 3D map over (B, T, C) (its zero
// fill is the padding at the sequence ends), and a producer thread streams
// the 18 convs' weights by TMA through an mbarrier ring across units and
// chains with no gap (a unit's weights, 180 KB in bf16 at k=11 C=64, do not
// fit beside the tile). N = C_out = 64 or 32 per wgmma. The chain sum stays
// in y, in device memory, each element with the one thread that adds to it:
// y = c0, y += c1, ..., the last sum divided by the number of chains; that
// leaves shared memory to the tiles, planned in whole 64-row wgmma tiles
// (stage_tile) so that the k=11 chain's first conv, tile + 110 rows, fills
// most of its last m64 tile.
//
// bf16 (wgmma_conv_bf16.cuh): wgmma m64nNk16; each conv's HIO weights are
// read MN-major through its own map (StageArgsBf16 holds the 18 maps), as
// they are. The chain sum rounds as the plain version does: bf16 adds, then
// the division in f32, rounded to bf16.
//
// f32 (wgmma_conv_f32.cuh): wgmma on a 3xTF32 split, three products per f32
// product, which keeps the f32 path's 2e-4 agreement with its plain version.
// The 18 convs' weights are one buffer, (taps, C_out, C_in) K-major, packed
// by the wrapper in the order the block runs them, with one 2D map;
// StageArgsF32 holds each conv's first tap. The chain sum is summed in f32
// and multiplied by 1 / n.

#include "conv_tile.cuh"
#include "wgmma_conv_bf16.cuh"
#include "wgmma_conv_f32.cuh"

namespace evt {

constexpr int kMaxChains = 4;
constexpr int kMaxUnits = 4;

constexpr int kMaxConvs = 2 * kMaxChains * kMaxUnits;

// The bf16 kernel's arguments: per conv, in the order the block runs them
// (chains, units, w1 before w2), the map over its HIO weight and its bias.
struct StageArgsBf16 {
  CUtensorMap w[kMaxConvs];
  const bf16* b[kMaxConvs];
  int k[kMaxChains];
  int d[kMaxChains][kMaxUnits];
  int n_units[kMaxChains];
  int n_chains;
};

// Per-side halo of chain j: sum over its units of (k-1)/2*(d+1). A is
// StageArgsBf16 or StageArgsF32.
template <typename A> __host__ __device__ inline int chain_halo(const A& a, int j) {
  int h = 0;
  for (int u = 0; u < a.n_units[j]; ++u) h += (a.k[j] - 1) / 2 * (a.d[j][u] + 1);
  return h;
}

// Host: the largest chain halo, the tile's halo.
template <typename A> inline int stage_halo(const A& a) {
  int halo = 0;
  for (int j = 0; j < a.n_chains; ++j) {
    const int h = chain_halo(a, j);
    if (h > halo) halo = h;
  }
  return halo;
}

// The stage's convs in the order the block runs them: f(q, K, n_out) with q
// the conv's index in that order (unit u's conv1 and conv2 at 2u, 2u + 1,
// counting units across chains).
template <typename F>
__device__ void for_each_conv(const StageArgsBf16& a, int tile, F f) {
  int q = 0;
  for (int j = 0; j < a.n_chains; ++j) {
    const int K = a.k[j];
    int ext = tile + 2 * chain_halo(a, j);
    for (int u = 0; u < a.n_units[j]; ++u) {
      const int h1 = (K - 1) / 2 * a.d[j][u], h2 = (K - 1) / 2;
      f(q++, K, ext - 2 * h1);
      f(q++, K, ext - 2 * h1 - 2 * h2);
      ext -= 2 * (h1 + h2);
    }
  }
}

// bf16 y = a / n for the 8 values of a 16-byte chunk: the division in f32,
// rounded to bf16 (as PyTorch divides a bf16 tensor).
__device__ __forceinline__ uint4 div_chunk(uint4 a, float n) {
  bf16x2* p = reinterpret_cast<bf16x2*>(&a);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(p[i]);
    p[i] = __floats2bfloat162_rn(f.x / n, f.y / n);
  }
  return a;
}

// bf16: two consumer warpgroups and a producer warpgroup. Each chain's tile
// arrives by TMA (x_map) as global rows t0 - halo ..; each conv's weights
// stream through its own map (a.w).
template <int C, typename T>
__global__ void __launch_bounds__(kWgBlock, 1)
mrf_stage_kernel(const __grid_constant__ CUtensorMap x_map, bf16* __restrict__ y,
                 const __grid_constant__ StageArgsBf16 a, int T_len, int tile, int halo,
                 int box_rows, int n_box, int stages) {
  static_assert(std::is_same<T, bf16>::value, "the bf16 core's kernel");
  constexpr int kChunks = C / 8;  // 16-byte chunks of a row
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const int rows = n_box * box_rows;
  unsigned char* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const int tile_bytes = C * 2 * rows;
  const ActTileBf16<C> xs{smem_u32(base), reinterpret_cast<char*>(base), rows};  // chain activation
  const ActTileBf16<C> mid{xs.addr + tile_bytes, xs.ptr + tile_bytes, rows};    // lrelu(conv1 + b1)
  RingBf16<C> ring;
  ring.base = mid.addr + tile_bytes;
  ring.bars = ring.base + stages * WgTileBf16<C>::kStageBytes;
  ring.stages = stages;
  const uint32_t x_bar = ring.bars + 16 * stages;

  const int b = blockIdx.y;
  const int t0 = blockIdx.x * tile;
  const int g_base = t0 - halo;  // global row of xs and mid row 0
  if (threadIdx.x == 0) {
    ring.init();
    sm90::mbar_init(x_bar, 1);
    sm90::mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {  // the producer warpgroup: one thread
    if (threadIdx.x == kConsumers)
      for_each_conv(a, tile, [&](int q, int K, int n) { ring.produce(&a.w[q], K, n); });
  } else {  // the consumer warpgroups
    bf16* yb = y + (size_t)b * T_len * C;
    int q = 0;  // conv index
    for (int j = 0; j < a.n_chains; ++j) {
      const int K = a.k[j];
      const int hj = chain_halo(a, j);
      int lo = halo - hj;       // first live row of the chain in xs
      int ext = tile + 2 * hj;  // live rows
      // the previous chain's reads and in-place writes of xs are over before
      // TMA writes it again
      sm90::fence_proxy_async();
      sm90::bar_sync(kConsumerBar, kConsumers);
      if (threadIdx.x == 0) load_act_tile_bf16<C>(xs, &x_map, x_bar, b, g_base, box_rows, n_box);
      sm90::mbar_wait(x_bar, j & 1);
      for (int u = 0; u < a.n_units[j]; ++u, q += 2) {
        const int d = a.d[j][u];
        const int h1 = (K - 1) / 2 * d, h2 = (K - 1) / 2;
        const int m0 = lo + h1;  // first conv1 output row
        // mid = lrelu(conv1 + b1), then x += conv2 + b2 in place; both zero
        // at rows outside [0, T)
        wg_conv_bf16<C, true, false>(xs, lo, ext - 2 * h1, K, d, a.b[q], ring,
                                     EpiBf16<C, true, false, true>{mid, m0, g_base + m0, T_len});
        const int r0 = m0 + h2;  // first conv2 output row
        wg_conv_bf16<C, false, false>(mid, m0, ext - 2 * h1 - 2 * h2, K, 1, a.b[q + 1], ring,
                                      EpiBf16<C, false, true, true>{xs, r0, g_base + r0, T_len});
        lo += h1 + h2;
        ext -= 2 * (h1 + h2);
      }
      // lo == halo and ext == tile: the chain output is the tile; the last
      // wg_conv_bf16 ended with a consumer barrier. The chain sum stays in y.
      const bool last = j + 1 == a.n_chains;
      for (int i = threadIdx.x; i < tile * kChunks; i += kConsumers) {
        const int r = i / kChunks, ch = i % kChunks;
        const int g = t0 + r;
        if (g >= T_len) continue;
        uint4 v = *reinterpret_cast<const uint4*>(xs.ptr + xs.off(halo + r, ch));
        uint4* dst = reinterpret_cast<uint4*>(yb + (size_t)g * C + ch * 8);
        if (j > 0) v = add_chunk(*dst, v);
        *dst = last ? div_chunk(v, (float)a.n_chains) : v;
      }
    }
  }
}

// Shared memory of the bf16 kernel: chain activation and intermediate (rows
// per slab each), the ring, its barriers and x's, and the alignment slack.
template <int C> size_t stage_smem_bf16(int rows, int stages) {
  return 1024 + (size_t)C * 2 * 2 * rows + ring_bytes_bf16<C>(stages) + 8;
}

// w: each conv's HIO weight, in a's order; a.w is filled here.
template <int C>
static int launch_bf16(const void* x, void* y, const void* const* w, StageArgsBf16& a, int B,
                       int T_len, int tile, int box_rows, int n_box, int stages, int kmt, int kc,
                       cudaStream_t stream) {
  const int halo = stage_halo(a);
  if (kmt != WgCfgBf16<C>::kMT || kc != WgCfgBf16<C>::kKC || stages < 2 ||
      stages > WgCfgBf16<C>::kStages || tile % 8 || box_rows % 8 || box_rows > 256 ||
      n_box * box_rows < tile + 2 * halo)
    return (int)cudaErrorInvalidValue;
  CUtensorMap x_map;
  cudaError_t err = encode_act_map_bf16<C>(&x_map, x, B, T_len, box_rows);
  int q = 0;
  for (int j = 0; j < a.n_chains; ++j)
    for (int u = 0; u < a.n_units[j]; ++u)
      for (int i = 0; i < 2 && err == cudaSuccess; ++i, ++q)
        err = encode_weight_map_bf16<C>(&a.w[q], w[q], a.k[j]);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = stage_smem_bf16<C>(n_box * box_rows, stages);
  void (*kern)(const CUtensorMap, bf16*, const StageArgsBf16, int, int, int, int, int, int) =
      mrf_stage_kernel<C, bf16>;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((T_len + tile - 1) / tile, B);
  kern<<<grid, kWgBlock, smem, stream>>>(x_map, (bf16*)y, a, T_len, tile, halo, box_rows, n_box,
                                         stages);
  return (int)cudaGetLastError();
}

// The f32 kernel's arguments: per chain and unit, the first tap of w1 and of
// w2 in the packed K-major weight buffer, and the bias pointers.
struct StageArgsF32 {
  const float* b1[kMaxChains][kMaxUnits];
  const float* b2[kMaxChains][kMaxUnits];
  int tap1[kMaxChains][kMaxUnits];
  int tap2[kMaxChains][kMaxUnits];
  int k[kMaxChains];
  int d[kMaxChains][kMaxUnits];
  int n_units[kMaxChains];
  int n_chains;
};

// The stage's convs in the order the block runs them: f(tap0, K, n_out).
template <typename F>
__device__ void for_each_conv(const StageArgsF32& a, int tile, F f) {
  for (int j = 0; j < a.n_chains; ++j) {
    const int K = a.k[j];
    int ext = tile + 2 * chain_halo(a, j);
    for (int u = 0; u < a.n_units[j]; ++u) {
      const int h1 = (K - 1) / 2 * a.d[j][u], h2 = (K - 1) / 2;
      f(a.tap1[j][u], K, ext - 2 * h1);
      f(a.tap2[j][u], K, ext - 2 * h1 - 2 * h2);
      ext -= 2 * (h1 + h2);
    }
  }
}

// f32: the same block on the 3xTF32 core. Each chain's tile arrives by TMA
// (x_map) as global rows t0 - halo ..; the weights stream from the packed
// buffer (w_map).
template <int C, typename T>
__global__ void __launch_bounds__(kWgBlock, 1)
mrf_stage_kernel(const __grid_constant__ CUtensorMap x_map,
                 const __grid_constant__ CUtensorMap w_map, float* __restrict__ y,
                 const StageArgsF32 a, int T_len, int tile, int halo, int box_rows, int n_box,
                 int stages) {
  static_assert(std::is_same<T, float>::value, "the wgmma core is the f32 path");
  constexpr int kChunks = C / 4;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const int rows = n_box * box_rows;
  unsigned char* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const int tile_bytes = C * 4 * rows;
  const ActTile xs{smem_u32(base), reinterpret_cast<char*>(base), rows};  // chain activation
  const ActTile mid{xs.addr + tile_bytes, xs.ptr + tile_bytes, rows};    // lrelu(conv1 + b1)
  WgRing<C> ring;
  ring.base = mid.addr + tile_bytes;
  ring.bars = ring.base + stages * 2 * WgTile<C>::kStageBytes;
  ring.stages = stages;
  const uint32_t x_bar = ring.bars + 8 * 3 * stages;

  const int b = blockIdx.y;
  const int t0 = blockIdx.x * tile;
  const int g_base = t0 - halo;  // global row of xs and mid row 0
  if (threadIdx.x == 0) {
    ring.init();
    sm90::mbar_init(x_bar, 1);
    sm90::mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {  // the producer warpgroup
    const int i = threadIdx.x - kConsumers;
    if (i == 0) {
      for_each_conv(a, tile, [&](int tap0, int K, int n) { ring.produce(&w_map, tap0, K, n); });
    } else if (i >= 32) {
      int n_chunks = 0;
      for_each_conv(a, tile, [&](int, int K, int n) { n_chunks += conv_chunks<C>(K, n); });
      ring.make_tails(n_chunks, i - 32);
    }
  } else {  // the consumer warpgroups
    const float inv = 1.f / (float)a.n_chains;
    float* yb = y + (size_t)b * T_len * C;
    for (int j = 0; j < a.n_chains; ++j) {
      const int K = a.k[j];
      const int hj = chain_halo(a, j);
      int lo = halo - hj;       // first live row of the chain in xs
      int ext = tile + 2 * hj;  // live rows
      // the previous chain's reads and in-place writes of xs are over before
      // TMA writes it again
      sm90::fence_proxy_async();
      sm90::bar_sync(kConsumerBar, kConsumers);
      if (threadIdx.x == 0) load_act_tile<C>(xs, &x_map, x_bar, b, g_base, box_rows, n_box);
      sm90::mbar_wait(x_bar, j & 1);
      for (int u = 0; u < a.n_units[j]; ++u) {
        const int d = a.d[j][u];
        const int h1 = (K - 1) / 2 * d, h2 = (K - 1) / 2;
        const int m0 = lo + h1;  // first conv1 output row
        wg_conv<C, true, false>(xs, lo, ext - 2 * h1, K, d, a.b1[j][u], ring,
                                [&](int m, int co, float2 v) {
          const int row = m0 + m;
          const int g = g_base + row;
          mid.pair(row, co) = (g >= 0 && g < T_len) ? lrelu2(v) : make_float2(0.f, 0.f);
        });
        const int r0 = m0 + h2;  // first conv2 output row
        wg_conv<C, false, false>(mid, m0, ext - 2 * h1 - 2 * h2, K, 1, a.b2[j][u], ring,
                                 [&](int r, int co, float2 v) {
          const int row = r0 + r;
          const int g = g_base + row;
          float2& xv = xs.pair(row, co);
          xv = (g >= 0 && g < T_len) ? add2(xv, v) : make_float2(0.f, 0.f);
        });
        lo += h1 + h2;
        ext -= 2 * (h1 + h2);
      }
      // lo == halo and ext == tile: the chain output is the tile; the last
      // wg_conv ended with a consumer barrier. The chain sum stays in y, in
      // device memory, each element with the one thread that adds to it:
      // y = c0, y += c1, ..., the last sum times 1 / n_chains.
      const bool last = j + 1 == a.n_chains;
      for (int i = threadIdx.x; i < tile * kChunks; i += kConsumers) {
        const int r = i / kChunks, ch = i % kChunks;
        const int g = t0 + r;
        if (g >= T_len) continue;
        float4 v = *reinterpret_cast<const float4*>(xs.ptr + xs.off(halo + r, ch));
        float4* dst = reinterpret_cast<float4*>(yb + (size_t)g * C + ch * 4);
        if (j > 0) {
          const float4 s = *dst;
          v = make_float4(s.x + v.x, s.y + v.y, s.z + v.z, s.w + v.w);
        }
        *dst = last ? make_float4(v.x * inv, v.y * inv, v.z * inv, v.w * inv) : v;
      }
    }
  }
}

// Shared memory of the f32 kernel: chain activation and intermediate (rows
// per slab each), the ring, its barriers and x's, and the alignment slack.
template <int C> size_t stage_smem_f32(int rows, int stages) {
  return 1024 + (size_t)C * 4 * 2 * rows + ring_bytes<C>(stages) + 8;
}

template <int C>
static int launch_f32(const void* x, void* y, const void* w, int taps, const StageArgsF32& a,
                      int B, int T_len, int tile, int box_rows, int n_box, int stages, int kmt,
                      int kc, cudaStream_t stream) {
  const int halo = stage_halo(a);
  if (kmt != WgCfg<C>::kMT || kc != WgCfg<C>::kKC || stages < 2 ||
      stages > WgCfg<C>::kStages || tile % 8 || box_rows % 8 || box_rows > 256 ||
      n_box * box_rows < tile + 2 * halo)
    return (int)cudaErrorInvalidValue;
  CUtensorMap w_map, x_map;
  cudaError_t err = encode_maps<C>(&w_map, w, taps, &x_map, x, B, T_len, box_rows);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = stage_smem_f32<C>(n_box * box_rows, stages);
  void (*kern)(const CUtensorMap, const CUtensorMap, float*, const StageArgsF32, int, int, int,
               int, int, int) = mrf_stage_kernel<C, float>;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((T_len + tile - 1) / tile, B);
  kern<<<grid, kWgBlock, smem, stream>>>(x_map, w_map, (float*)y, a, T_len, tile, halo,
                                         box_rows, n_box, stages);
  return (int)cudaGetLastError();
}

}  // namespace evt

// Plain C entry points (loaded with ctypes); each returns cudaGetLastError()
// after the launch, or cudaErrorInvalidValue.
//   ks:      kernel size per chain
//   n_units: residual units per chain
//   dils:    dilation per unit, chains one after another
//   box_rows, n_box: the chain tile's TMA boxes; stages: ring stages;
//   kmt, kc: the tiling the kernel was built with (WgCfgBf16<C>, WgCfg<C>)
// bf16:
//   ptrs:    per chain, per unit: w1, b1, w2, b2 (host array of device
//            pointers; the weights HIO (K, C, C) as they are)
extern "C" int evt_mrf_stage_bf16(const void* x, void* y, const void* const* ptrs,
                                  const int* ks, const int* n_units, const int* dils,
                                  int n_chains, int B, int T_len, int C, int tile, int box_rows,
                                  int n_box, int stages, int kmt, int kc, void* stream) {
  if (n_chains < 1 || n_chains > evt::kMaxChains) return (int)cudaErrorInvalidValue;
  evt::StageArgsBf16 a = {};
  const void* w[evt::kMaxConvs];
  a.n_chains = n_chains;
  int p = 0, q = 0, u_all = 0;
  for (int j = 0; j < n_chains; ++j) {
    if (n_units[j] < 1 || n_units[j] > evt::kMaxUnits) return (int)cudaErrorInvalidValue;
    a.k[j] = ks[j];
    a.n_units[j] = n_units[j];
    for (int u = 0; u < n_units[j]; ++u, q += 2) {
      a.d[j][u] = dils[u_all++];
      w[q] = ptrs[p++];
      a.b[q] = (const evt::bf16*)ptrs[p++];
      w[q + 1] = ptrs[p++];
      a.b[q + 1] = (const evt::bf16*)ptrs[p++];
    }
  }
  cudaStream_t s = (cudaStream_t)stream;
  switch (C) {
#define EVT_CASE(c) \
  case c: return evt::launch_bf16<c>(x, y, w, a, B, T_len, tile, box_rows, n_box, stages, kmt, kc, s);
    EVT_CASE(32) EVT_CASE(64) EVT_CASE(128) EVT_CASE(256)
#undef EVT_CASE
    default: return (int)cudaErrorInvalidValue;
  }
}

// f32:
//   w:       (taps, C, C) K-major, every conv's taps in the order the block
//            runs them; taps1 / taps2: per unit, chains one after another,
//            the first tap of w1 / w2
//   biases:  per unit, chains one after another: b1, b2 (device pointers)
extern "C" int evt_mrf_stage_f32(const void* x, void* y, const void* w, int taps,
                                 const void* const* biases, const int* taps1, const int* taps2,
                                 const int* ks, const int* n_units, const int* dils,
                                 int n_chains, int B, int T_len, int C, int tile, int box_rows,
                                 int n_box, int stages, int kmt, int kc, void* stream) {
  if (n_chains < 1 || n_chains > evt::kMaxChains) return (int)cudaErrorInvalidValue;
  evt::StageArgsF32 a = {};
  a.n_chains = n_chains;
  int q = 0;
  for (int j = 0; j < n_chains; ++j) {
    if (n_units[j] < 1 || n_units[j] > evt::kMaxUnits) return (int)cudaErrorInvalidValue;
    a.k[j] = ks[j];
    a.n_units[j] = n_units[j];
    for (int u = 0; u < n_units[j]; ++u, ++q) {
      a.d[j][u] = dils[q];
      a.tap1[j][u] = taps1[q];
      a.tap2[j][u] = taps2[q];
      a.b1[j][u] = (const float*)biases[2 * q];
      a.b2[j][u] = (const float*)biases[2 * q + 1];
    }
  }
  cudaStream_t s = (cudaStream_t)stream;
  switch (C) {
#define EVT_CASE(c) \
  case c: return evt::launch_f32<c>(x, y, w, taps, a, B, T_len, tile, box_rows, n_box, stages, kmt, kc, s);
    EVT_CASE(32) EVT_CASE(64) EVT_CASE(128) EVT_CASE(256)
#undef EVT_CASE
    default: return (int)cudaErrorInvalidValue;
  }
}
