// Shared pieces of the HiFi-GAN MRF kernels (resblock.cu, mrf_stage.cu),
// which replace the TPU kernels emotivoice_tpu/ops/pallas/resblock.py
// (fused_residual_unit) and emotivoice_tpu/ops/pallas/packed_stage.py
// (fused_mrf_stage).
//
// Layout: activations are feature-last (B, T, C) rows of C contiguous values;
// conv weights are HIO (K, C_in, C_out) with weight norm already folded;
// biases are (C,). Storage type T is float or __nv_bfloat16; every product
// and sum is taken in f32, and results are rounded back to T where the JAX
// reference rounds (after each conv, after its bias add, after each
// residual add).
//
// This header holds the f32 instantiation's compute loop. The bf16
// instantiation runs on the tensor cores through mma_conv() (mma_conv.cuh),
// chosen at compile time by storage type.
//
// conv_rows() is the f32 loop both kernels use: a block of kThreads threads
// computes an (n_out x C) conv output from a haloed tile of f32 activations
// held in shared memory, one f32 FMA per product on the CUDA cores. Bound on
// the H100: operations, against the 67 TFLOP/s of the f32 CUDA cores (the
// tensor cores take f32 only as TF32, whose 10-bit mantissa would break the
// 2e-4 agreement with the plain version). Each warp owns kRowsPerThread rows
// of a kRowsPerPass-row pass and each lane C/32 output channels, strided by
// 32 so the shared-memory weight reads of a warp are conflict-free and its
// activation reads are one broadcast. Weights stream through shared memory
// in chunks of kCiChunk input channels of one tap; L2 holds the whole
// weight tensor (at most 11*256*256*4 = 2.9 MB) across blocks.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace evt {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRowsPerThread = 8;
constexpr int kRowsPerPass = kWarps * kRowsPerThread;  // 64
constexpr int kCiChunk = 16;
constexpr float kSlope = 0.1f;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// Round an f32 value to storage type T and back (identity for float).
template <typename T> __device__ __forceinline__ float round_to(float v) {
  return to_f(from_f<T>(v));
}

__device__ __forceinline__ float lrelu(float v) { return fmaxf(v, v * kSlope); }

// out[r][co] = sum_{kk<K} sum_{ci<C} act(in[(r + kk*d)*C + ci]) * W[kk][ci][co]
// for r in [0, n_out); act is leaky ReLU when LRELU_IN, else the identity.
// `in` points at the first input row in shared memory; `wsm` is kCiChunk*C
// floats of shared scratch. epi(r, co, acc) consumes each output exactly
// once. Every thread of the block must call this (it synchronises).
template <int C, bool LRELU_IN, typename T, typename Epi>
__device__ void conv_rows(const float* in, int n_out, const T* __restrict__ W,
                          int K, int d, float* wsm, Epi epi) {
  static_assert(C % 32 == 0 && C % kCiChunk == 0, "C must be a multiple of 32");
  constexpr int CT = C / 32;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int base = 0; base < n_out; base += kRowsPerPass) {
    const int r0 = base + warp * kRowsPerThread;
    const bool active = r0 < n_out;
    float acc[kRowsPerThread][CT];
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i)
#pragma unroll
      for (int j = 0; j < CT; ++j) acc[i][j] = 0.f;
    // Rows past n_out read the last valid row; their sums are never stored.
    int row_off[kRowsPerThread];
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i) row_off[i] = min(r0 + i, n_out - 1) * C;

    for (int kk = 0; kk < K; ++kk) {
      const float* tap = in + kk * d * C;
      for (int c0 = 0; c0 < C; c0 += kCiChunk) {
        __syncthreads();
        const T* wsrc = W + ((size_t)kk * C + c0) * C;
        for (int i = threadIdx.x; i < kCiChunk * C; i += kThreads) wsm[i] = to_f(wsrc[i]);
        __syncthreads();
        if (!active) continue;
#pragma unroll 4
        for (int ci = 0; ci < kCiChunk; ++ci) {
          float w[CT];
#pragma unroll
          for (int j = 0; j < CT; ++j) w[j] = wsm[ci * C + lane + 32 * j];
#pragma unroll
          for (int i = 0; i < kRowsPerThread; ++i) {
            float a = tap[row_off[i] + c0 + ci];
            if (LRELU_IN) a = lrelu(a);
#pragma unroll
            for (int j = 0; j < CT; ++j) acc[i][j] = fmaf(a, w[j], acc[i][j]);
          }
        }
      }
    }
    if (active) {
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i) {
        if (r0 + i < n_out) {
#pragma unroll
          for (int j = 0; j < CT; ++j) epi(r0 + i, lane + 32 * j, acc[i][j]);
        }
      }
    }
  }
  __syncthreads();
}

// Load global rows [g0, g0 + n) of one batch row into shared memory as f32,
// with rows outside [0, T) set to zero (the convs' zero padding).
template <int C, typename T>
__device__ void load_rows(float* dst, const T* __restrict__ xb, int g0, int n, int T_len) {
  for (int i = threadIdx.x; i < n * C; i += kThreads) {
    const int r = i / C, c = i % C;
    const int g = g0 + r;
    dst[i] = (g >= 0 && g < T_len) ? to_f(xb[(size_t)g * C + c]) : 0.f;
  }
}

}  // namespace evt
