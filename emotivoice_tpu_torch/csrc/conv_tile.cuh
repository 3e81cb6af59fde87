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
// Both storage types run their convs on the tensor cores through one Hopper
// implicit-GEMM core each, of one block shape and one epilogue contract:
// wg_conv_bf16() (wgmma_conv_bf16.cuh, wgmma m64nNk16 with the HIO weights
// read MN-major) and wg_conv() on float (wgmma_conv_f32.cuh, wgmma on a
// 3xTF32 split, which keeps f32 accuracy). Both take the weights by TMA
// through a producer's mbarrier ring and A from registers. There is no other
// conv loop.
//
// This header holds what the kernels share: the block shape (two consumer
// warpgroups and a producer warpgroup), pairs of adjacent channels as the
// epilogues see them (lrelu2 and add2 serve both types), the ldmatrix and
// stmatrix wrappers and the count dispatch of the chunk loops.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace evt {

constexpr float kSlope = 0.1f;

constexpr int kConsumerWGs = 2;
constexpr int kConsumers = 128 * kConsumerWGs;  // threads 0..255
constexpr int kWgBlock = kConsumers + 128;      // + the producer warpgroup
constexpr int kConsumerBar = 1;                 // named barrier of the consumers

using bf16 = __nv_bfloat16;
using bf16x2 = __nv_bfloat162;

__host__ __device__ __forceinline__ int cdiv(int a, int b) { return (a + b - 1) / b; }

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

// The same four matrices stored: lane l gives the address of row l % 8 of
// matrix l / 8 and holds word l % 4 of row l / 4 of each.
__device__ __forceinline__ void stsm_x4(uint32_t addr, const uint32_t (&r)[4]) {
  asm volatile("stmatrix.sync.aligned.m8n8.x4.shared.b16 [%0], {%1, %2, %3, %4};\n"
               ::"r"(addr), "r"(r[0]), "r"(r[1]), "r"(r[2]), "r"(r[3])
               : "memory");
}

// f(std::integral_constant<int, n>{}) for a runtime n in [0, N]: lets a loop
// over n m64 tiles unroll without a branch per tile.
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

}  // namespace evt
