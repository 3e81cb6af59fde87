// Fused masked attention of the port's transformer for Hopper (sm_90a):
// models/transformer.py `attend`, for inference on a card (the encoder's and
// the decoder's 4 layers each).
//
// Replaces no TPU kernel: the JAX package leaves this attention to XLA
// (emotivoice_tpu/models/transformer.py, MultiHeadedAttention: two einsums
// around a masked softmax). It is added because the port's unfused chain
// wrote f32 scores (B, H, T, T) to device memory and passed over them some
// seven times (divide, mask, softmax, mask, cast, the head split and merge
// copies): at the decoder's mel lengths, 16 rows x 8 heads x T = 1536-2048,
// over a gigabyte a layer and a third of a bf16 bulk call's device time
// (PERF.md).
//
//   out[b, t, h] = sum_k p[b, h, t, k] v[b, k, h],  p = softmax_k(s) with
//   s = (q[b, t, h] . k[b, k, h]) / sqrt(d_k), masked keys at NEG_INF before
//   the softmax and exactly 0 after it.
//
// Bound on the H100: operations, once the T x T intermediates stay on chip.
// A (row, head) does 4 T L d_k FLOP (L its visited keys) against d_k (2 T + 2
// L) values read or written once: with d_k = 48, at T = 1536 and L ~ T / 4,
// about 300 FLOP a byte in bf16, at the bf16 tensor cores' balance point
// (~295), and far above the f32 CUDA cores' (~20).
//
// Design: one block per (query tile of kQueryTile rows, head, batch row): a
// consumer warpgroup (128 threads, warp w owns rows 16w..16w+15 of the tile)
// and a producer warp. The block reads Q, K and V where the linears left
// them, (B, T, H d_k) with the head at column h d_k, and writes O into the
// same layout: no head split or merge copies.
//  - Key tiles skipped: every query row is computed (padded frames too: the
//    decoder's k=3 FFN convs carry them into the valid ones), but the key
//    loop ends after the last key tile that holds a valid key of the row.
//    All threads scan the row's valid mask once on the device (no host
//    sync: it works inside a CUDA graph); a row with no valid key visits no
//    tile and writes exactly 0, as the double masked_fill gives.
//  - K and V tiles of kKeyTile keys come by TMA from 3D maps over (B, T, H
//    d_k), whose zero fill covers keys past T, through a ring of mbarrier
//    stages that the producer warp's first thread keeps full.
//  - The online softmax runs in registers, row max and row sum in f32 with
//    the scale 1 / sqrt(d_k) applied in f32; keys masked in a partly masked
//    tile get NEG_INF for the max and p = 0, so a tile skipped whole and a
//    tile of masked keys give the same sums. Per row, each thread holds the
//    scores of keys 8j + 2t, 8j + 2t + 1 (j < 8, t = lane % 4) of rows g and
//    g + 8 (g = lane / 4): wgmma's accumulator layout; the quad of a row
//    shares max and sum by shuffles.
//  - bf16: S = Q K^T and O += P V on wgmma with f32 accumulators. Q stays in
//    registers as wgmma A fragments for the whole loop; K is B K-major and V
//    B MN-major, each one 128-byte swizzled box of 64 columns (the head's 48
//    and 16 unused: the next head's, or zeros past the last), so S takes 3
//    k16 steps and P V 4 of N = 64, of which 48 columns are kept. P is
//    rounded to bf16 before P V, as the plain version rounds the weights
//    before its matmul; the scores stay f32 (the plain version rounds them to
//    bf16 first).
//  - f32 (TF32 off, f32 accuracy): both products on the CUDA cores (FFMA).
//    Q is staged transposed in shared memory once, each K tile transposed
//    (d-major, two buffers, one consumer barrier a tile), so a thread's 16
//    keys at a d are 8 conflict-free float2 loads; P goes to shared memory
//    per warp and meets V's rows as they arrived.

#include "conv_tile.cuh"
#include "hopper.cuh"

namespace evt {
namespace attn {

constexpr int kHeadDim = 48;       // d_k the kernel is built for
constexpr int kQueryTile = 64;     // query rows of a block: one wgmma m64 tile
constexpr int kKeyTile = 64;       // keys of a ring stage
constexpr int kStagesBf16 = 3;     // ring stages, bf16
constexpr int kStagesF32 = 2;      // ring stages, f32
constexpr int kThreads = 160;      // a consumer warpgroup and a producer warp
constexpr int kWarps = kThreads / 32;
constexpr int kConsumerThreads = 128;
constexpr int kBar = 1;            // named barrier of the consumers
constexpr float kNegInf = -1e30f;  // NEG_INF of utils/masks.py
constexpr float kLog2e = 1.4426950408889634f;

// bf16: one 128-byte swizzled box of 64 columns x kKeyTile keys each for K
// and V
constexpr int kBoxCols = 64;
constexpr int kBoxBytesBf16 = kBoxCols * 2 * kKeyTile;  // 8192
// f32: K and V boxes of the head's columns, unswizzled
constexpr int kBoxBytesF32 = kHeadDim * 4 * kKeyTile;  // 12288
constexpr int kTStride = kQueryTile + 2;  // floats of a transposed Q or K row (d-major)
constexpr int kPStride = kKeyTile + 4;    // floats of a row of P

static_assert(kHeadDim % 16 == 0 && kHeadDim <= kBoxCols, "whole k16 steps inside one box");
static_assert(kQueryTile == 64 && kKeyTile == 64, "one wgmma m64 tile; 8 n8 blocks of keys");

template <typename T> struct Layout;

template <> struct Layout<bf16> {
  static constexpr int kStages = kStagesBf16;
  static constexpr int kStageBytes = 2 * kBoxBytesBf16;
  static constexpr int kOut = kBoxCols / 2;  // accumulator registers of O (N = 64)
  static constexpr int kTiles = kStages * kStageBytes;
  static constexpr size_t kSmem = 1024 + kTiles + 16 * kStages;
};

template <> struct Layout<float> {
  static constexpr int kStages = kStagesF32;
  static constexpr int kStageBytes = 2 * kBoxBytesF32;
  static constexpr int kOut = kHeadDim / 2;  // O registers: 6 n8 blocks
  static constexpr int kQt = kStages * kStageBytes;          // Q^T (d_k x kTStride)
  static constexpr int kKt = kQt + kHeadDim * kTStride * 4;  // two K^T buffers
  static constexpr int kP = kKt + 2 * kHeadDim * kTStride * 4;
  static constexpr int kTiles = kP + kQueryTile * kPStride * 4;
  static constexpr size_t kSmem = 1024 + kTiles + 16 * kStages;
};

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// Rows g (r = 0) and g + 8 (r = 1) of this thread: running max (in the
// exponent's units) and this thread's share of the running sum.
struct RowState {
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};
};

// One key tile's scores s (wgmma's accumulator layout: s[4j + 2r + e] is
// row g + 8r, key key0 + 8j + 2t + e) become p in place: the scale, the
// mask, the running max and sum; alpha[r] rescales the row's O. kExp2: the
// scale holds log2(e) and the exponent is exp2 (bf16); else expf (f32).
template <bool kExp2>
__device__ __forceinline__ void softmax_tile(float (&s)[32], RowState& st, float (&alpha)[2],
                                             const unsigned char* __restrict__ mrow, int key0,
                                             int T_len, int t, float scale) {
  uint32_t valid = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int c = key0 + 8 * j + 2 * t + e;
      if (c < T_len && (mrow == nullptr || mrow[c])) valid |= 1u << (2 * j + e);
    }
  float mx[2] = {kNegInf, kNegInf};
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float& v = s[4 * j + 2 * r + e];
        v = (valid >> (2 * j + e)) & 1u ? v * scale : kNegInf;
        mx[r] = fmaxf(mx[r], v);
      }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float mn = fmaxf(st.m[r], quad_max(mx[r]));
    alpha[r] = kExp2 ? exp2f(st.m[r] - mn) : expf(st.m[r] - mn);
    st.m[r] = mn;
    st.l[r] *= alpha[r];
  }
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float& v = s[4 * j + 2 * r + e];
        v = (valid >> (2 * j + e)) & 1u ? (kExp2 ? exp2f(v - st.m[r]) : expf(v - st.m[r])) : 0.f;
        st.l[r] += v;
      }
}

template <int N> __device__ __forceinline__ void rescale(float (&o)[N], const float (&alpha)[2]) {
#pragma unroll
  for (int i = 0; i < N; ++i) o[i] *= alpha[(i >> 1) & 1];
}

__device__ __forceinline__ void store_pair(bf16* p, float a, float b) {
  *reinterpret_cast<bf16x2*>(p) = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ void store_pair(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

// O / l for rows g and g + 8 of warp w into out (B, T, D) at the head's
// columns; a row with no valid key (l = 0) writes 0.
template <typename T, int N>
__device__ __forceinline__ void store_rows(const float (&o)[N], const RowState& st, T* out,
                                           int row0, int T_len, int D, int t) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float l = quad_sum(st.l[r]);
    const float inv = l > 0.f ? 1.f / l : 0.f;
    const int row = row0 + 8 * r;
    if (row < T_len) {
      T* p = out + (size_t)row * D + 2 * t;
#pragma unroll
      for (int j = 0; j < kHeadDim / 8; ++j)
        store_pair(p + 8 * j, o[4 * j + 2 * r] * inv, o[4 * j + 2 * r + 1] * inv);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
attention_kernel(const __grid_constant__ CUtensorMap k_map, const __grid_constant__ CUtensorMap v_map,
                 const T* __restrict__ q, const unsigned char* __restrict__ mask,
                 T* __restrict__ out, int T_len, int D, float scale) {
  using L = Layout<T>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  __shared__ int last_valid[kWarps];
  unsigned char* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t tiles = smem_u32(base);
  const uint32_t full = tiles + L::kTiles, empty = full + 8 * L::kStages;
  const int q0 = blockIdx.x * kQueryTile, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const unsigned char* mrow = mask == nullptr ? nullptr : mask + (size_t)b * T_len;

  // the last valid key of the row, from its mask
  int last = mask == nullptr ? T_len - 1 : -1;
  if (mask != nullptr)
    for (int i = threadIdx.x; i < T_len; i += kThreads)
      if (mrow[i]) last = i;
  last = __reduce_max_sync(0xffffffffu, last);
  if (lane == 0) last_valid[warp] = last;
  if (threadIdx.x == 0) {
    for (int s = 0; s < L::kStages; ++s) {
      sm90::mbar_init(full + 8 * s, 1);
      sm90::mbar_init(empty + 8 * s, kConsumerThreads / 32);
    }
    sm90::mbar_fence_init();
  }
  __syncthreads();
#pragma unroll
  for (int w = 0; w < kWarps; ++w) last = max(last, last_valid[w]);
  const int n_tiles = cdiv(last + 1, kKeyTile);

  if (warp == kWarps - 1) {  // the producer warp: one thread
    if (lane == 0) {
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % L::kStages;
        const uint32_t stage = tiles + s * L::kStageBytes;
        sm90::mbar_wait(empty + 8 * s, ((i / L::kStages) & 1) ^ 1);
        sm90::mbar_arrive_expect_tx(full + 8 * s, L::kStageBytes);
        sm90::tma_load_3d(stage, &k_map, full + 8 * s, h * kHeadDim, i * kKeyTile, b);
        sm90::tma_load_3d(stage + L::kStageBytes / 2, &v_map, full + 8 * s, h * kHeadDim,
                          i * kKeyTile, b);
      }
    }
    return;
  }

  // the consumer warpgroup
  const int g = lane / 4, t = lane % 4;
  const int row0 = q0 + 16 * warp + g;  // this thread's rows: row0 and row0 + 8
  const T* qb = q + (size_t)b * T_len * D + h * kHeadDim;
  T* ob = out + (size_t)b * T_len * D + h * kHeadDim;
  RowState st;
  float alpha[2];
  float o[L::kOut];
#pragma unroll
  for (int i = 0; i < L::kOut; ++i) o[i] = 0.f;

  if constexpr (std::is_same<T, bf16>::value) {
    // Q as wgmma A fragments, k16 step ks: (row0, 16ks + 2t), (row0 + 8, ..),
    // (row0, 16ks + 8 + 2t), (row0 + 8, ..), two bf16 a word
    uint32_t qf[kHeadDim / 16][4];
#pragma unroll
    for (int ks = 0; ks < kHeadDim / 16; ++ks)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = row0 + 8 * (i & 1);
        const int col = 16 * ks + 8 * (i >> 1) + 2 * t;
        qf[ks][i] = row < T_len ? *reinterpret_cast<const uint32_t*>(qb + (size_t)row * D + col) : 0u;
      }
#pragma unroll
    for (int ks = 0; ks < kHeadDim / 16; ++ks) sm90::fence_regs(qf[ks]);
    const float scale2 = scale * kLog2e;
    for (int i = 0; i < n_tiles; ++i) {
      const int s = i % L::kStages;
      const uint32_t k_tile = tiles + s * L::kStageBytes, v_tile = k_tile + kBoxBytesBf16;
      sm90::mbar_wait(full + 8 * s, (i / L::kStages) & 1);
      float sc[32];
#pragma unroll
      for (int r = 0; r < 32; ++r) sc[r] = 0.f;
      sm90::fence_regs(sc);
      sm90::wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < kHeadDim / 16; ++ks)  // B K-major: a k16 step is 32 bytes of a row
        sm90::WgmmaBf16KMajor64::run(sc, qf[ks], sm90::smem_desc_kmajor(k_tile + 32 * ks, 128));
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_regs(sc);
      softmax_tile<true>(sc, st, alpha, mrow, i * kKeyTile, T_len, t, scale2);
      rescale(o, alpha);
      // P as A fragments, k16 step ks = n8 blocks 2ks (keys 16ks + 2t..) and
      // 2ks + 1 (keys 16ks + 8 + 2t..)
      uint32_t pf[kKeyTile / 16][4];
#pragma unroll
      for (int ks = 0; ks < kKeyTile / 16; ++ks) {
#pragma unroll
        for (int i2 = 0; i2 < 4; ++i2) {
          const bf16x2 v = __floats2bfloat162_rn(sc[8 * ks + 2 * i2], sc[8 * ks + 2 * i2 + 1]);
          pf[ks][i2] = *reinterpret_cast<const uint32_t*>(&v);
        }
        sm90::fence_regs(pf[ks]);
      }
      sm90::fence_regs(o);
      sm90::wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < kKeyTile / 16; ++ks)  // B MN-major: a k16 step is 16 rows of 128 bytes
        sm90::WgmmaBf16<kBoxCols>::run(o, pf[ks],
                                       sm90::smem_desc_mnmajor(v_tile + 16 * 128 * ks, 128,
                                                               kBoxBytesBf16));
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_regs(o);
      __syncwarp();
      if (lane == 0) sm90::mbar_arrive(empty + 8 * s);
    }
  } else {
    float* qt = reinterpret_cast<float*>(base + L::kQt);  // Q^T: qt[d * kTStride + row]
    float* pt = reinterpret_cast<float*>(base + L::kP) + (16 * warp) * kPStride;  // the warp's P rows
    for (int e = threadIdx.x; e < kQueryTile * kHeadDim; e += kConsumerThreads) {
      const int row = e / kHeadDim, d = e % kHeadDim;
      qt[d * kTStride + row] = q0 + row < T_len ? qb[(size_t)(q0 + row) * D + d] : 0.f;
    }
    const int r0 = 16 * warp + g;
    for (int i = 0; i < n_tiles; ++i) {
      const int s = i % L::kStages;
      const float* ks_ = reinterpret_cast<const float*>(base + s * L::kStageBytes);  // K[key][d]
      const float* vs = ks_ + kKeyTile * kHeadDim;                                  // V[key][d]
      float* kt = reinterpret_cast<float*>(base + L::kKt) + (i & 1) * kHeadDim * kTStride;
      sm90::mbar_wait(full + 8 * s, (i / L::kStages) & 1);
      for (int e = threadIdx.x; e < kKeyTile * kHeadDim; e += kConsumerThreads)
        kt[(e % kHeadDim) * kTStride + e / kHeadDim] = ks_[e];
      // K^T written (and, at i == 0, Q^T); a buffer is written again two
      // tiles on, after every consumer has passed this barrier once more
      sm90::bar_sync(kBar, kConsumerThreads);
      float sc[32];
#pragma unroll
      for (int r = 0; r < 32; ++r) sc[r] = 0.f;
#pragma unroll 4
      for (int d = 0; d < kHeadDim; ++d) {
        const float a0 = qt[d * kTStride + r0], a1 = qt[d * kTStride + r0 + 8];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float2 kk = *reinterpret_cast<const float2*>(kt + d * kTStride + 8 * j + 2 * t);
          sc[4 * j] = fmaf(a0, kk.x, sc[4 * j]);
          sc[4 * j + 1] = fmaf(a0, kk.y, sc[4 * j + 1]);
          sc[4 * j + 2] = fmaf(a1, kk.x, sc[4 * j + 2]);
          sc[4 * j + 3] = fmaf(a1, kk.y, sc[4 * j + 3]);
        }
      }
      softmax_tile<false>(sc, st, alpha, mrow, i * kKeyTile, T_len, t, scale);
      rescale(o, alpha);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        *reinterpret_cast<float2*>(pt + g * kPStride + 8 * j + 2 * t) =
            make_float2(sc[4 * j], sc[4 * j + 1]);
        *reinterpret_cast<float2*>(pt + (g + 8) * kPStride + 8 * j + 2 * t) =
            make_float2(sc[4 * j + 2], sc[4 * j + 3]);
      }
      __syncwarp();
#pragma unroll 4
      for (int key = 0; key < kKeyTile; ++key) {
        const float p0 = pt[g * kPStride + key], p1 = pt[(g + 8) * kPStride + key];
#pragma unroll
        for (int j = 0; j < kHeadDim / 8; ++j) {
          const float2 vv = *reinterpret_cast<const float2*>(vs + key * kHeadDim + 8 * j + 2 * t);
          o[4 * j] = fmaf(p0, vv.x, o[4 * j]);
          o[4 * j + 1] = fmaf(p0, vv.y, o[4 * j + 1]);
          o[4 * j + 2] = fmaf(p1, vv.x, o[4 * j + 2]);
          o[4 * j + 3] = fmaf(p1, vv.y, o[4 * j + 3]);
        }
      }
      __syncwarp();  // P read before the next tile writes it; the stage's K and V read
      if (lane == 0) sm90::mbar_arrive(empty + 8 * s);
    }
  }
  store_rows(o, st, ob, row0, T_len, D, t);
}

// Host: a 3D map over x (B, T, D) with boxes of `cols` columns x kKeyTile keys
// of one row: bf16 128-byte swizzled (cols 64), f32 unswizzled (cols d_k).
inline cudaError_t encode_kv_map(CUtensorMap* map, const void* x, bool is_bf16, int B, int T_len,
                                 int D) {
  sm90::EncodeTiledFn fn = sm90::encode_tiled();
  if (fn == nullptr) return cudaErrorNotSupported;
  const int elem = is_bf16 ? 2 : 4;
  const cuuint64_t gdim[3] = {(cuuint64_t)D, (cuuint64_t)T_len, (cuuint64_t)B};
  const cuuint64_t gstride[2] = {(cuuint64_t)D * elem, (cuuint64_t)T_len * D * elem};
  const cuuint32_t box[3] = {(cuuint32_t)(is_bf16 ? kBoxCols : kHeadDim), (cuuint32_t)kKeyTile, 1};
  const cuuint32_t estride[3] = {1, 1, 1};
  const CUresult r = fn(map, is_bf16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
                        3, const_cast<void*>(x), gdim, gstride, box, estride,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        is_bf16 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_NONE,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* mask, void* out, int B,
           int T_len, int H, int d_k, float scale, cudaStream_t stream) {
  const int D = H * d_k;
  if (d_k != kHeadDim || B < 1 || T_len < 1 || H < 1) return (int)cudaErrorInvalidValue;
  CUtensorMap k_map, v_map;
  const bool is_bf16 = std::is_same<T, bf16>::value;
  cudaError_t err = encode_kv_map(&k_map, k, is_bf16, B, T_len, D);
  if (err == cudaSuccess) err = encode_kv_map(&v_map, v, is_bf16, B, T_len, D);
  if (err != cudaSuccess) return (int)err;
  void (*kern)(const CUtensorMap, const CUtensorMap, const T*, const unsigned char*, T*, int, int,
               float) = attention_kernel<T>;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)Layout<T>::kSmem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(cdiv(T_len, kQueryTile), H, B);
  kern<<<grid, kThreads, Layout<T>::kSmem, stream>>>(k_map, v_map, (const T*)q,
                                                     (const unsigned char*)mask, (T*)out, T_len,
                                                     D, scale);
  return (int)cudaGetLastError();
}

}  // namespace attn
}  // namespace evt

// Plain C entry points (loaded with ctypes); each returns cudaGetLastError()
// after the launch, or cudaErrorInvalidValue for an unsupported argument.
// q, k, v and out are (B, T, H * d_k) contiguous; mask is the (B, T) bool
// valid mask, or null for all keys valid; scale is 1 / sqrt(d_k).
extern "C" int evt_attention_bf16(const void* q, const void* k, const void* v, const void* mask,
                                  void* out, int B, int T_len, int H, int d_k, float scale,
                                  void* stream) {
  return evt::attn::launch<evt::bf16>(q, k, v, mask, out, B, T_len, H, d_k, scale,
                                      (cudaStream_t)stream);
}

extern "C" int evt_attention_f32(const void* q, const void* k, const void* v, const void* mask,
                                 void* out, int B, int T_len, int H, int d_k, float scale,
                                 void* stream) {
  return evt::attn::launch<float>(q, k, v, mask, out, B, T_len, H, d_k, scale,
                                  (cudaStream_t)stream);
}
