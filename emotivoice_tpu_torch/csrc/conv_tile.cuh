// Shared pieces of the HiFi-GAN MRF kernels (resblock.cu, mrf_stage.cu),
// which replace the TPU kernels emotivoice_tpu/ops/pallas/resblock.py
// (fused_residual_unit) and emotivoice_tpu/ops/pallas/packed_stage.py
// (fused_mrf_stage).
//
// Layout: activations are feature-last (B, T, C) rows of C contiguous values;
// conv weights are HIO (K, C_in, C_out) with weight norm already folded;
// biases are (C,). Storage type T is float or __nv_bfloat16; every product
// is summed in f32, and results are rounded back to T where the JAX
// reference rounds (after each conv, after its bias add, after each
// residual add; no rounding at all when T is float).
//
// Both storage types run their convs on the tensor cores, through one
// implicit-GEMM core each with the same contract: mma_conv() on bf16
// (mma_conv.cuh, mma.sync m16n8k16) and mma_conv() on float
// (mma_conv_f32.cuh, mma.sync m16n8k8 on a 3xTF32 split, which keeps f32
// accuracy). The overload is chosen at compile time by the storage type;
// there is no other conv loop.
//
// This header holds what the two cores and the two kernels share: the block
// shape, the activation tile's layout in shared memory (rows of 16-byte
// chunks, XOR-swizzled), pairs of adjacent channels as the epilogues see
// them, the cp.async / ldmatrix wrappers, the weight ring's state and the
// count dispatch of the chunk loops.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace evt {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr float kSlope = 0.1f;

using bf16 = __nv_bfloat16;
using bf16x2 = __nv_bfloat162;

// Tiling of a conv core per channel count and storage type: kWN warps across
// C_out, each with kNT n8 tiles (kWN * kNT * 8 == C), and kMT m16 tiles per
// warp; the weight ring has kStages stages of kKC rows of W flattened to
// (K*C_in, C_out). Specialised beside each core.
template <int C, typename T> struct MmaCfg;

template <int C, typename T> struct MmaTile : MmaCfg<C, T> {
  using Cfg = MmaCfg<C, T>;
  // Depth of one mma.sync: k16 on bf16, k8 on tf32.
  static constexpr int kStep = 32 / sizeof(T);
  // Row stride of a ring stage in values of T. bf16 rows are XOR-swizzled for
  // ldmatrix.trans; f32 rows are padded by 8 words, so the 4 rows x 8 columns
  // that a warp's 32-bit B loads touch fall in 32 different banks.
  static constexpr int kLd = std::is_same<T, float>::value ? C + 8 : C;
  static_assert(Cfg::kWN * Cfg::kNT * 8 == C, "warps must tile C_out");
  static_assert(Cfg::kKC % kStep == 0 && Cfg::kStages >= 2, "ring of whole mma steps");
  static constexpr int kWM = kWarps / Cfg::kWN;
  static constexpr int kPassRows = kWM * Cfg::kMT * 16;
  static constexpr int kRingElems = Cfg::kStages * Cfg::kKC * kLd;
};

// Values of type T in one 16-byte chunk, the unit of cp.async, of ldmatrix
// rows and of the tile's swizzle.
template <typename T> struct Chunk { static constexpr int kElems = 16 / sizeof(T); };

// Index of the 16-byte chunk ch of row r in a [rows][C] buffer of T.
// XOR-swizzled so that any 8 consecutive rows at one chunk fall in 8
// different bank groups.
template <int C, typename T> __device__ __forceinline__ int chunk_at(int r, int ch) {
  constexpr int kChunks = C / Chunk<T>::kElems;
  const int sw = kChunks >= 8 ? (r & 7) : ((r >> 1) & (kChunks - 1));
  return r * kChunks + (ch ^ sw);
}

// Element index of (row r, channel c) in such a buffer.
template <int C, typename T> __device__ __forceinline__ int elem_at(int r, int c) {
  constexpr int P = Chunk<T>::kElems;
  return chunk_at<C, T>(r, c / P) * P + (c % P);
}

// Channels (co, co + 1), co even, as the cores hand them to an epilogue.
template <typename T> struct PairOf;
template <> struct PairOf<bf16> { using type = bf16x2; };
template <> struct PairOf<float> { using type = float2; };

// The pair at p (aligned to the pair's size).
__device__ __forceinline__ bf16x2& pair_at(bf16* p) { return *reinterpret_cast<bf16x2*>(p); }
__device__ __forceinline__ float2& pair_at(float* p) { return *reinterpret_cast<float2*>(p); }

template <typename T> __device__ __forceinline__ typename PairOf<T>::type zero2();
template <> __device__ __forceinline__ bf16x2 zero2<bf16>() { return __float2bfloat162_rn(0.f); }
template <> __device__ __forceinline__ float2 zero2<float>() { return make_float2(0.f, 0.f); }

__device__ __forceinline__ float lrelu(float v) { return fmaxf(v, v * kSlope); }

// lrelu of two bf16 values as JAX rounds max(v, v * 0.1) in bf16: the
// slope is bf16(0.1), the product is rounded once. bf16 arithmetic on the
// card (add.bf16x2, mul.bf16x2) rounds the exact result once, as the CPU's
// f32 arithmetic on bf16 operands followed by one rounding does.
__device__ __forceinline__ bf16x2 lrelu2(bf16x2 v) {
  return __hmax2(v, __hmul2(v, __float2bfloat162_rn(kSlope)));
}
__device__ __forceinline__ float2 lrelu2(float2 v) { return make_float2(lrelu(v.x), lrelu(v.y)); }

__device__ __forceinline__ bf16x2 add2(bf16x2 a, bf16x2 b) { return __hadd2(a, b); }
__device__ __forceinline__ float2 add2(float2 a, float2 b) {
  return make_float2(a.x + b.x, a.y + b.y);
}

// The values of one 16-byte chunk as f32, and back (rounded to T).
__device__ __forceinline__ void unpack_chunk(const uint4& v, float (&f)[8], bf16) {
  const bf16x2* h = reinterpret_cast<const bf16x2*>(&v);
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const float2 p = __bfloat1622float2(h[q]);
    f[2 * q] = p.x;
    f[2 * q + 1] = p.y;
  }
}
__device__ __forceinline__ void unpack_chunk(const uint4& v, float (&f)[4], float) {
  const float* p = reinterpret_cast<const float*>(&v);
#pragma unroll
  for (int q = 0; q < 4; ++q) f[q] = p[q];
}
__device__ __forceinline__ uint4 pack_chunk(const float (&f)[8], bf16) {
  uint4 v;
  bf16x2* h = reinterpret_cast<bf16x2*>(&v);
#pragma unroll
  for (int q = 0; q < 4; ++q) h[q] = __floats2bfloat162_rn(f[2 * q], f[2 * q + 1]);
  return v;
}
__device__ __forceinline__ uint4 pack_chunk(const float (&f)[4], float) {
  return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]), __float_as_uint(f[2]),
                    __float_as_uint(f[3]));
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Four 8-row x 16-byte matrices; lane l gives the address of row l % 8 of
// matrix l / 8 and receives the 32-bit word l % 4 of row l / 4 of each.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Start copying global rows [g0, g0 + n) of one batch row into rows
// [row0, row0 + n) of a swizzled tile with cp.async, as one commit group;
// rows outside [0, T) are set to zero (the convs' zero padding). The rows
// are there after a cp_async_wait that covers the group and a barrier.
template <int C, typename T>
__device__ void load_rows_async(T* dst, int row0, const T* __restrict__ xb, int g0, int n,
                                int T_len) {
  constexpr int P = Chunk<T>::kElems;
  constexpr int kChunks = C / P;
  for (int i = threadIdx.x; i < n * kChunks; i += kThreads) {
    const int r = i / kChunks, ch = i % kChunks;
    const int g = g0 + r;
    T* p = dst + P * chunk_at<C, T>(row0 + r, ch);
    if (g >= 0 && g < T_len)
      cp_async16(smem_u32(p), xb + (size_t)g * C + ch * P);
    else
      *reinterpret_cast<uint4*>(p) = make_uint4(0u, 0u, 0u, 0u);
  }
  cp_async_commit();
}

// f(std::integral_constant<int, n>{}) for a runtime n in [0, N]: lets a loop
// over n m16 tiles unroll without a branch per tile.
template <int N, typename F> __device__ __forceinline__ void with_count(int n, F&& f) {
  if constexpr (N == 0) {
    f(std::integral_constant<int, 0>{});
  } else {
    if (n == N)
      f(std::integral_constant<int, N>{});
    else
      with_count<N - 1>(n, f);
  }
}

// The weight ring of a block: kStages stages of kKC rows of W
// (MmaTile<C, T>::kRingElems values of T). The convs a block runs stream
// through it without a gap: while one conv multiplies its last chunks, the
// first kStages-1 chunks of the next one are already in flight.
template <typename T> struct WeightRing {
  T* stages;
  int head;     // stage of the next chunk to consume
  bool primed;  // the next conv's first kStages-1 chunks are in flight
};

}  // namespace evt
