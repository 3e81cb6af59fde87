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
// at packed_stage.py:225-239). The chain outputs sum into an f32
// accumulator in shared memory; the tile is written to device memory once.
// The 18 intermediates never leave the SM.
//
// Every conv runs on the tensor cores through mma_conv(): ldmatrix from
// swizzled tiles of the chain activation and of the intermediate in shared
// memory, weights through a 2-stage cp.async ring (a unit's weights, 180 KB
// in bf16 at k=11 C=64, do not fit beside the tile). The ring streams on from
// each conv into the next, across units and chains.
//
// bf16 (mma_conv.cuh): mma.sync m16n8k16, ring stages of 128 rows of W (two
// taps at C=64, four at C=32). The tile is 320 rows at C=64 and 768 at C=32
// (the k=11 chain's first conv covers 1.34x / 1.14x the tile's rows).
//
// f32 (mma_conv_f32.cuh): mma.sync m16n8k8 on TF32 heads and tails, three
// products per f32 product (3xTF32), which keeps the f32 path's 2e-4
// agreement with its plain version where one TF32 product (10-bit mantissa)
// would break it. Ring stages of 32 (C=64) or 64 (C=32) rows; the tile is
// 192 rows at C=64 and 448 at C=32, and each conv is one pass of the core's
// rows (384 / 640), so the weights stream once per conv.

#include "conv_tile.cuh"
#include "mma_conv.cuh"
#include "mma_conv_f32.cuh"

namespace evt {

constexpr int kMaxChains = 4;
constexpr int kMaxUnits = 4;

struct StageArgs {
  const void* w1[kMaxChains][kMaxUnits];
  const void* b1[kMaxChains][kMaxUnits];
  const void* w2[kMaxChains][kMaxUnits];
  const void* b2[kMaxChains][kMaxUnits];
  int k[kMaxChains];
  int d[kMaxChains][kMaxUnits];
  int n_units[kMaxChains];
  int n_chains;
};

__host__ __device__ inline int chain_halo(const StageArgs& a, int j) {
  int h = 0;
  for (int u = 0; u < a.n_units[j]; ++u) h += (a.k[j] - 1) / 2 * (a.d[j][u] + 1);
  return h;
}

template <int C, typename T>
__global__ void __launch_bounds__(kThreads)
mrf_stage_kernel(const T* __restrict__ x, T* __restrict__ y, const StageArgs a,
                 int T_len, int tile, int halo) {
  using Pair = typename PairOf<T>::type;
  constexpr int P = Chunk<T>::kElems;
  constexpr int kChunks = C / P;
  extern __shared__ float smem[];
  const int n_x = tile + 2 * halo;
  T* xs = reinterpret_cast<T*>(smem);  // chain activation, global row t0 - halo + i
  T* mid = xs + n_x * C;               // lrelu(conv1 + b1), same row indexing
  float* acc = reinterpret_cast<float*>(mid + n_x * C);  // sum of chain outputs, [tile][C]
  WeightRing<T> ring{reinterpret_cast<T*>(acc + tile * C), 0, false};  // kRingElems

  const int b = blockIdx.y;
  const int t0 = blockIdx.x * tile;
  const int g_base = t0 - halo;  // global row of xs[0] and mid[0]
  const T* xb = x + (size_t)b * T_len * C;
  T* yb = y + (size_t)b * T_len * C;

  for (int i = threadIdx.x; i < tile * C / 4; i += kThreads)
    reinterpret_cast<float4*>(acc)[i] = make_float4(0.f, 0.f, 0.f, 0.f);

  for (int j = 0; j < a.n_chains; ++j) {
    const int K = a.k[j];
    const int hj = chain_halo(a, j);
    int lo = halo - hj;           // first live row of the chain in xs
    int ext = tile + 2 * hj;      // live rows
    __syncthreads();              // previous chain's accumulate has finished
    load_rows_async<C>(xs, lo, xb, g_base + lo, ext, T_len);
    cp_async_wait<0>();           // x rows (and the primed weight chunks) have landed
    for (int u = 0; u < a.n_units[j]; ++u) {
      const int d = a.d[j][u];
      const int h1 = (K - 1) / 2 * d, h2 = (K - 1) / 2;
      const T* w1 = (const T*)a.w1[j][u];
      const T* b1 = (const T*)a.b1[j][u];
      const T* w2 = (const T*)a.w2[j][u];
      const T* b2 = (const T*)a.b2[j][u];
      // the conv after this unit's conv2: the next unit's or chain's conv1
      const bool last_unit = u + 1 == a.n_units[j];
      const bool last_chain = j + 1 == a.n_chains;
      const T* w_next = (const T*)(!last_unit   ? a.w1[j][u + 1]
                                   : !last_chain ? a.w1[j + 1][0]
                                                 : nullptr);
      const int k_next = !last_unit ? K : !last_chain ? a.k[j + 1] : 0;
      const int m0 = lo + h1;     // first conv1 output row
      mma_conv<C, true>(xs, lo, ext - 2 * h1, w1, b1, K, d, ring, w2, K,
                        [&](int m, int co, Pair v) {
        const int row = m0 + m;
        const int g = g_base + row;
        pair_at(mid + elem_at<C, T>(row, co)) = (g >= 0 && g < T_len) ? lrelu2(v) : zero2<T>();
      });
      const int r0 = m0 + h2;     // first conv2 output row
      mma_conv<C, false>(mid, m0, ext - 2 * h1 - 2 * h2, w2, b2, K, 1, ring, w_next, k_next,
                         [&](int r, int co, Pair v) {
        const int row = r0 + r;
        const int g = g_base + row;
        Pair& xv = pair_at(xs + elem_at<C, T>(row, co));
        xv = (g >= 0 && g < T_len) ? add2(xv, v) : zero2<T>();
      });
      lo += h1 + h2;
      ext -= 2 * (h1 + h2);
    }
    // lo == halo and ext == tile here: the chain output is the tile; the
    // last mma_conv ended with a barrier.
    for (int i = threadIdx.x; i < tile * kChunks; i += kThreads) {
      const int r = i / kChunks, ch = i % kChunks;
      float f[P];
      unpack_chunk(*reinterpret_cast<const uint4*>(xs + P * chunk_at<C, T>(halo + r, ch)), f, T());
      float* dst = acc + r * C + ch * P;
#pragma unroll
      for (int q = 0; q < P; ++q) dst[q] += f[q];
    }
  }
  __syncthreads();
  const float inv = 1.f / (float)a.n_chains;
  for (int i = threadIdx.x; i < tile * kChunks; i += kThreads) {
    const int r = i / kChunks, ch = i % kChunks;
    const int g = t0 + r;
    if (g >= T_len) continue;
    const float* src = acc + r * C + ch * P;
    float f[P];
#pragma unroll
    for (int q = 0; q < P; ++q) f[q] = src[q] * inv;
    *reinterpret_cast<uint4*>(yb + (size_t)g * C + ch * P) = pack_chunk(f, T());
  }
}

template <int C, typename T>
static int launch(const void* x, void* y, const StageArgs& a, int B, int T_len,
                  int tile, int kc, cudaStream_t stream) {
  int halo = 0;
  for (int j = 0; j < a.n_chains; ++j) {
    const int h = chain_halo(a, j);
    if (h > halo) halo = h;
  }
  const size_t n_x = (size_t)tile + 2 * halo;
  if (kc != MmaCfg<C, T>::kKC) return (int)cudaErrorInvalidValue;
  const size_t smem =
      sizeof(T) * (C * 2 * n_x + MmaTile<C, T>::kRingElems) + sizeof(float) * C * tile;
  auto kern = mrf_stage_kernel<C, T>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((T_len + tile - 1) / tile, B);
  kern<<<grid, kThreads, smem, stream>>>((const T*)x, (T*)y, a, T_len, tile, halo);
  return (int)cudaGetLastError();
}

template <typename T>
static int dispatch_c(int C, const void* x, void* y, const StageArgs& a, int B,
                      int T_len, int tile, int kc, cudaStream_t s) {
  switch (C) {
    case 32: return launch<32, T>(x, y, a, B, T_len, tile, kc, s);
    case 64: return launch<64, T>(x, y, a, B, T_len, tile, kc, s);
    case 128: return launch<128, T>(x, y, a, B, T_len, tile, kc, s);
    case 256: return launch<256, T>(x, y, a, B, T_len, tile, kc, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace evt

// Plain C entry point (loaded with ctypes).
//   ptrs:    per chain, per unit: w1, b1, w2, b2 (host array of device pointers)
//   ks:      kernel size per chain
//   n_units: residual units per chain
//   dils:    dilation per unit, chains one after another
//   kc:      weight rows per ring stage, MmaCfg<C, T>::kKC
// Returns cudaGetLastError() after the launch, or cudaErrorInvalidValue.
extern "C" int evt_mrf_stage(const void* x, void* y, const void* const* ptrs,
                             const int* ks, const int* n_units, const int* dils,
                             int n_chains, int B, int T_len, int C, int tile, int kc,
                             int is_bf16, void* stream) {
  if (n_chains < 1 || n_chains > evt::kMaxChains) return (int)cudaErrorInvalidValue;
  evt::StageArgs a = {};
  a.n_chains = n_chains;
  int p = 0, q = 0;
  for (int j = 0; j < n_chains; ++j) {
    if (n_units[j] < 1 || n_units[j] > evt::kMaxUnits) return (int)cudaErrorInvalidValue;
    a.k[j] = ks[j];
    a.n_units[j] = n_units[j];
    for (int u = 0; u < n_units[j]; ++u) {
      a.d[j][u] = dils[q++];
      a.w1[j][u] = ptrs[p++];
      a.b1[j][u] = ptrs[p++];
      a.w2[j][u] = ptrs[p++];
      a.b2[j][u] = ptrs[p++];
    }
  }
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16) return evt::dispatch_c<__nv_bfloat16>(C, x, y, a, B, T_len, tile, kc, s);
  return evt::dispatch_c<float>(C, x, y, a, B, T_len, tile, kc, s);
}
