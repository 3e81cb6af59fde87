// Tensor-core conv core of the HiFi-GAN MRF kernels' f32 instantiation
// (resblock.cu, mrf_stage.cu), for Hopper (sm_90a): the counterpart of
// mma_conv.cuh, with the same contract, on float storage.
//
// Takes the place of the TPU kernels' MXU matmuls at f32 precision
// (emotivoice_tpu/ops/pallas/resblock.py, _residual_unit_kernel, and
// emotivoice_tpu/ops/pallas/packed_stage.py, _mrf_stage_kernel, under
// jax_default_matmul_precision "highest").
//
// Bound on the H100: operations. The tensor cores take f32 only as TF32 (a
// 10-bit mantissa), and one TF32 product per f32 product misses the f32
// path's 2e-4 agreement with its plain version. Three do not: each operand is
// split in registers into a TF32 head and a TF32 tail,
//   head = rna_tf32(v),  tail = rna_tf32(v - head)   (v - head is exact),
// and a*b is taken as a_tail*b_head + a_head*b_tail + a_head*b_head, summed
// in f32 (the tail*tail term, ~2^-22 of the product, is dropped). So the
// least time for f32-accurate work is 3 * FLOP / 495 TFLOP/s (dense TF32),
// 2.5x less than on the f32 CUDA cores (67 TFLOP/s).
//
// Design: the implicit GEMM of mma_conv.cuh (tap kk = the activation tile
// shifted by kk*d rows, times W[kk]; no im2col):
//  - Products: mma.sync.m16n8k8 tf32 with f32 accumulators in registers,
//    three per k8 step and output tile. The products into one accumulator are
//    issued kNT apart (the tail terms of all n8 tiles, then the head terms),
//    so none waits on the one before it. A warp owns kMT m16 x kNT n8 tiles,
//    so one A fragment (4 values a lane: loaded, passed through lrelu and
//    split once, ~25 ALU instructions) feeds 3*kNT products and one B
//    fragment (2 values a lane, split once) 3*kMT: shared-memory loads, lrelu
//    and the split are amortised over the tile, not paid per product.
//  - A (activations): ldmatrix.x4 on the f32 tile. Its 8x8 "b16" matrices are
//    8 rows x 16 bytes, i.e. 4 floats, and lane (g = lane/4, t = lane%4)
//    receives the words (g, t), (g+8, t), (g, t+4), (g+8, t+4): the a0-a3 of
//    m16n8k8. Each lane gives its own row address, so the tap's row shift is
//    free; the tile keeps the XOR swizzle of 16-byte chunks (conv_tile.cuh).
//  - B (weights): ldmatrix.trans transposes 16-bit values only, so the HIO
//    rows (k major, C_out contiguous) are read as they are with two 32-bit
//    shared loads a fragment, (k = t, n = g) and (k = t+4, n = g). Ring rows
//    are padded to C + 8 words, so a warp's 4 rows x 8 columns hit 32 banks;
//    rows stay multiples of 32 bytes, so the cp.async copies stay 16-byte
//    aligned. No relayout per call and no pre-split copy of the weights (it
//    would double the ring and the L2 stream): the split is 8 ALU
//    instructions a fragment.
//  - The weight ring: kStages stages of kKC rows (4-16 KB of weights a
//    stage), filled with cp.async, chunk j+kStages-1 in flight while chunk j
//    is multiplied, one barrier per chunk, streaming on across the convs of a
//    block. kKC divides C, so a chunk lies within one tap, and is at least two
//    k8 steps: with one step per barrier (8 rows at C=256, which would leave
//    room for larger tiles) the kernel was 8-12% slower at equal tiles.
//  - Rows per pass: kPassRows = (8 / kWN) * kMT * 16 (128 at C=256, 256 at
//    C=128, 384 at C=64, 640 at C=32); the wrappers' tiles put every conv in
//    one pass, so its weights stream from L2 once.
//  - Epilogue: v = sum + bias in f32 for columns co, co+1 (a float2), no
//    rounding; the kernel's functor applies lrelu or the residual add.
//  - One accumulator takes all three products. The worst error against an
//    f32 conv, ~2e-5 of max at C=256 k=11, comes from the tensor cores' own
//    adds into it (3 * K*C/8 per output), not from the split; tail products
//    in a second accumulator cut it 2.4x but do not fit the registers.

#pragma once

#include "conv_tile.cuh"

namespace evt {

template <> struct MmaCfg<32, float> { static constexpr int kWN = 1, kNT = 4, kMT = 5, kKC = 32, kStages = 3; };
template <> struct MmaCfg<64, float> { static constexpr int kWN = 1, kNT = 8, kMT = 3, kKC = 32, kStages = 2; };
template <> struct MmaCfg<128, float> { static constexpr int kWN = 2, kNT = 8, kMT = 4, kKC = 16, kStages = 3; };
template <> struct MmaCfg<256, float> { static constexpr int kWN = 4, kNT = 8, kMT = 4, kKC = 16, kStages = 2; };

__device__ __forceinline__ void mma_1688(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float lds_f32(uint32_t addr) {
  float v;
  asm volatile("ld.shared.f32 %0, [%1];\n" : "=f"(v) : "r"(addr));
  return v;
}

// v = head + tail + (at most 2^-22 |v|): head is v rounded to TF32 (nearest,
// ties away from zero), tail the exact remainder rounded the same way. This
// is cvt.rna.tf32.f32 for every finite v, in integer arithmetic on the
// magnitude bits: half a TF32 ulp is added and the low 13 bits are dropped.
// (sm_90a has no instruction for that cvt; ptxas expands it to about ten,
// with a guard for NaN and infinity.) The tail keeps its low bits: the tensor
// cores ignore the low 13 bits of a TF32 operand.
__device__ __forceinline__ void split_tf32(float v, uint32_t& head, uint32_t& tail) {
  head = (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
  tail = __float_as_uint(v - __uint_as_float(head)) + 0x1000u;
}

// Copy weight rows [row0, row0 + kKC) of W, flattened to (K*C_in, C_out),
// into one ring stage of rows padded to MmaTile<C, float>::kLd words, with
// cp.async: a fixed number of 16-byte copies per thread.
template <int C>
__device__ __forceinline__ void load_w_chunk(float* stage, const float* __restrict__ W, int row0) {
  using Cfg = MmaTile<C, float>;
  constexpr int kChunks = C / 4;
  constexpr int kCopies = Cfg::kKC * kChunks / kThreads;
  static_assert(Cfg::kKC * kChunks % kThreads == 0 && kThreads % kChunks == 0,
                "whole copies per thread, at one column");
  constexpr int kStride = kThreads / kChunks;  // rows between a thread's copies
  const int r = threadIdx.x / kChunks, ch = threadIdx.x % kChunks;
  const uint32_t dst = smem_u32(stage + r * Cfg::kLd + ch * 4);
  const float* src = W + (size_t)(row0 + r) * C + ch * 4;
#pragma unroll
  for (int k = 0; k < kCopies; ++k)
    cp_async16(dst + 4 * k * kStride * Cfg::kLd, src + k * kStride * C);
}

// out[r][co] = sum_{kk<K} sum_{ci<C} act(in[in_row0 + r + kk*d][ci]) * W[kk][ci][co]
// for r in [0, n_out); act is lrelu when LRELU_IN, else the identity. `in`
// is a swizzled [rows][C] f32 tile holding rows in_row0 .. in_row0 + n_out
// + (K-1)*d - 1. W_next (K_next taps) is the weight of the conv the block
// runs next, or nullptr; its first chunks are fetched during this one.
// epi(r, co, v) consumes columns co, co+1 of row r exactly once:
// v = sum + bias in f32. Every thread of the block must call this; it
// returns after a barrier, with every epilogue write visible.
template <int C, bool LRELU_IN, typename Epi>
__device__ void mma_conv(const float* in, int in_row0, int n_out, const float* __restrict__ W,
                         const float* __restrict__ bias, int K, int d, WeightRing<float>& ring,
                         const float* __restrict__ W_next, int K_next, Epi epi) {
  using Cfg = MmaTile<C, float>;
  constexpr int MT = Cfg::kMT, NT = Cfg::kNT, WM = Cfg::kWM, KC = Cfg::kKC, LD = Cfg::kLd;
  constexpr int S = Cfg::kStages;
  static_assert(C % KC == 0, "a chunk lies within one tap");
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int wm = warp / Cfg::kWN, wn = warp % Cfg::kWN;
  const int g = lane >> 2, t = lane & 3;
  const int n_chunks = K * (C / KC);
  const int n_pass = (n_out + Cfg::kPassRows - 1) / Cfg::kPassRows;
  const int total = n_pass * n_chunks;
  // Prime the next conv only if all kStages-1 chunks it expects exist.
  const bool prime_next = W_next != nullptr && K_next * (C / KC) >= S - 1;

  // Chunk j of this conv's stream; j >= total runs into the next conv.
  auto issue = [&](int j) {
    float* dst = ring.stages + ((ring.head + j) % S) * KC * LD;
    if (j < total)
      load_w_chunk<C>(dst, W, (j % n_chunks) * KC);
    else if (prime_next && j - total < S - 1)
      load_w_chunk<C>(dst, W_next, (j - total) * KC);
    cp_async_commit();
  };
  if (!ring.primed) {
#pragma unroll
    for (int s = 0; s < S - 1; ++s) issue(s);
  }

  const uint32_t in_base = smem_u32(in);
  // B: row t (and t + 4) of a k8 step, column g of this warp's first n8 tile.
  const uint32_t b_lane = smem_u32(ring.stages + t * LD + wn * NT * 8 + g);

  int j = 0;
  for (int pass = 0; pass < n_pass; ++pass) {
    // m tile of slot i; slots spread over warps first, so a short last pass
    // keeps every warp scheduler busy. Slot i is active while its tile has
    // rows below n_out, so the active slots are the first n_act.
    int arow[MT];
    bool act[MT];
    int n_act = 0;
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      const int mt = (pass * MT + i) * WM + wm;
      act[i] = mt * 16 < n_out;
      n_act += act[i];
      arow[i] = in_row0 + min(mt * 16 + (lane & 15), n_out - 1);
    }
    float acc[MT][NT][4];
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[i][n][q] = 0.f;

    with_count<MT>(n_act, [&](auto na) {
      constexpr int NA = decltype(na)::value;
      for (int c = 0; c < n_chunks; ++c, ++j) {
        cp_async_wait<S - 2>();
        __syncthreads();  // chunk j landed for all; stage of chunk j-1 is free
        issue(j + S - 1);
        if constexpr (NA > 0) {
          const uint32_t b_stage = b_lane + 4 * ((ring.head + j) % S) * KC * LD;
          const int jr = c * KC;  // first row of the chunk in (K*C_in, C_out)
          const int shift = (jr / C) * d;
          const int ch0 = (jr % C) >> 2;
          // One k8 step: rows [s, s + 8) of the chunk, input channels
          // jr % C + s .. + 7 of its tap.
#pragma unroll
          for (int s = 0; s < KC; s += 8) {
            uint32_t bh[NT][2], bl[NT][2];
#pragma unroll
            for (int n = 0; n < NT; ++n) {
              split_tf32(lds_f32(b_stage + 4 * (s * LD + n * 8)), bh[n][0], bl[n][0]);
              split_tf32(lds_f32(b_stage + 4 * ((s + 4) * LD + n * 8)), bh[n][1], bl[n][1]);
            }
#pragma unroll
            for (int i = 0; i < NA; ++i) {
              uint32_t a[4], ah[4], al[4];
              ldsm_x4(a, in_base + 16 * chunk_at<C, float>(arow[i] + shift,
                                                           ch0 + (s >> 2) + (lane >> 4)));
#pragma unroll
              for (int q = 0; q < 4; ++q) {
                const float v = __uint_as_float(a[q]);
                split_tf32(LRELU_IN ? lrelu(v) : v, ah[q], al[q]);
              }
              // Tail terms first; products into one accumulator lie kNT apart.
#pragma unroll
              for (int n = 0; n < NT; ++n) mma_1688(acc[i][n], al, bh[n][0], bh[n][1]);
#pragma unroll
              for (int n = 0; n < NT; ++n) mma_1688(acc[i][n], ah, bl[n][0], bl[n][1]);
#pragma unroll
              for (int n = 0; n < NT; ++n) mma_1688(acc[i][n], ah, bh[n][0], bh[n][1]);
            }
          }
        }
      }
    });

    float2 bb[NT];
#pragma unroll
    for (int n = 0; n < NT; ++n)
      bb[n] = *reinterpret_cast<const float2*>(bias + (wn * NT + n) * 8 + 2 * t);
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      if (!act[i]) continue;
      const int r0 = ((pass * MT + i) * WM + wm) * 16;
      const int r = r0 + g;
      auto out = [&](int n, bool lo, bool hi) {
        const int co = (wn * NT + n) * 8 + 2 * t;
        if (lo) epi(r, co, make_float2(acc[i][n][0] + bb[n].x, acc[i][n][1] + bb[n].y));
        if (hi) epi(r + 8, co, make_float2(acc[i][n][2] + bb[n].x, acc[i][n][3] + bb[n].y));
      };
      if (r0 + 16 <= n_out) {  // the whole m16 tile: no check per row
#pragma unroll
        for (int n = 0; n < NT; ++n) out(n, true, true);
      } else {
#pragma unroll
        for (int n = 0; n < NT; ++n) out(n, r < n_out, r + 8 < n_out);
      }
    }
  }
  ring.head = (ring.head + total) % S;
  ring.primed = prime_next;
  __syncthreads();
}

}  // namespace evt
