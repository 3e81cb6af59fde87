// Tensor-core conv core of the HiFi-GAN MRF kernels' bf16 instantiation
// (resblock.cu, mrf_stage.cu), for Hopper (sm_90a).
//
// Takes the place of the TPU kernels' MXU matmuls:
// emotivoice_tpu/ops/pallas/resblock.py (_residual_unit_kernel) and
// emotivoice_tpu/ops/pallas/packed_stage.py (_mrf_stage_kernel) each run a
// dilated conv as K shifted (rows x C_in) @ (C_in x C_out) products.
//
// Bound on the H100: operations. A conv does 2*K*C*C FLOP per row against
// 2*C bytes of bf16 activation in and out, so it is far above the card's
// ~295 FLOP/byte balance point of the bf16 tensor cores (989 TFLOP/s).
//
// Design: an implicit GEMM. For tap kk the conv is the activation tile
// shifted by kk*d rows times W[kk] (C_in x C_out); no im2col is built.
//  - Products: mma.sync.m16n8k16 with bf16 operands and f32 accumulators in
//    registers. Each warp owns kMT m16 row tiles x kNT n8 column tiles of the
//    output, so every A fragment feeds kNT products and every B fragment kMT.
//    How many of its m16 tiles hold rows below n_out is a compile-time count
//    per pass (with_count), so a chunk's steps are straight-line code with
//    no branch per tile.
//  - A (activations): ldmatrix.x4 from a bf16 tile in shared memory. Each
//    lane hands ldmatrix its own row address, so the tap's row shift costs
//    nothing. Rows are XOR-swizzled in 16-byte chunks (chunk_at) so the
//    8-row reads are free of bank conflicts at any shift.
//  - lrelu on the input is applied to the A fragment in registers as
//    max(a, a * bf16(0.1)) in bf16, the JAX reference's bf16 rounding.
//  - B (weights): ldmatrix.x4.trans reads the HIO (K, C_in, C_out) layout
//    as it is, so no relayout per call. W is walked as (K*C_in, C_out) rows
//    in chunks of kKC rows through a ring of kStages shared-memory stages
//    filled with cp.async (16 bytes a thread): chunk j+kStages-1 is in flight
//    while chunk j is multiplied, one barrier per chunk. The stream runs on
//    across the convs of a block (WeightRing): the next conv's first chunks
//    load during this conv's last ones. kKC is fixed per C so a chunk's k16
//    steps unroll and their fragment loads overlap the products.
//  - Epilogue: the core rounds each pair of f32 sums (columns co, co+1) to
//    bf16 and adds the bias in bf16x2, rounding where the JAX reference
//    rounds; a per-kernel functor epi(row, co, v) then applies lrelu or the
//    residual add in bf16x2 and writes shared or device memory. Only the
//    last m16 tile of a conv checks rows against n_out.
// The output rows are covered in passes of kPassRows (all warps' m tiles);
// the weights stream from L2 once per pass.
//
// Storage is bf16 only. The f32 instantiation has a core of the same shape
// and contract in mma_conv_f32.cuh: one TF32 product (10-bit mantissa) would
// break the f32 path's 2e-4 agreement with its plain version, a 3xTF32 split
// does not.

#pragma once

#include "conv_tile.cuh"

namespace evt {

template <> struct MmaCfg<32, bf16> { static constexpr int kWN = 1, kNT = 4, kMT = 8, kKC = 128, kStages = 2; };
template <> struct MmaCfg<64, bf16> { static constexpr int kWN = 1, kNT = 8, kMT = 4, kKC = 128, kStages = 2; };
template <> struct MmaCfg<128, bf16> { static constexpr int kWN = 2, kNT = 8, kMT = 4, kKC = 128, kStages = 2; };
template <> struct MmaCfg<256, bf16> { static constexpr int kWN = 4, kNT = 8, kMT = 4, kKC = 64, kStages = 2; };

__device__ __forceinline__ void ldsm_x4_trans(uint32_t& r0, uint32_t& r1, uint32_t& r2,
                                              uint32_t& r3, uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
               : "r"(addr));
}

__device__ __forceinline__ void mma_16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                          uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t lrelu_bf16x2(uint32_t v) {
  bf16x2 a = lrelu2(*reinterpret_cast<bf16x2*>(&v));
  return *reinterpret_cast<uint32_t*>(&a);
}

// Copy weight rows [row0, row0 + rows) of W, flattened to (K*C_in, C_out),
// into one swizzled ring stage with cp.async. A full stage of kKC rows takes
// a fixed number of copies per thread at fixed strides: a thread's chunk
// column and swizzle stay the same, since kThreads / (C/8) rows, its stride,
// is a multiple of the swizzle's 8-row period.
template <int C>
__device__ __forceinline__ void load_w_chunk(bf16* stage, const bf16* __restrict__ W, int row0,
                                             int rows) {
  constexpr int kChunks = C / 8;
  constexpr int KC = MmaCfg<C, bf16>::kKC;
  const uint32_t base = smem_u32(stage);
  if (rows == KC) {
    constexpr int kStride = kThreads / kChunks;
    static_assert(kStride % 8 == 0 && KC % kStride == 0, "copies at a fixed swizzle");
    const int r = threadIdx.x / kChunks, ch = threadIdx.x % kChunks;
    const uint32_t dst = base + 16 * chunk_at<C, bf16>(r, ch);
    const bf16* src = W + (size_t)(row0 + r) * C + ch * 8;
#pragma unroll
    for (int k = 0; k < KC / kStride; ++k)
      cp_async16(dst + 16 * k * kStride * kChunks, src + k * kStride * C);
    return;
  }
  for (int i = threadIdx.x; i < rows * kChunks; i += kThreads) {
    const int r = i / kChunks, ch = i % kChunks;
    cp_async16(base + 16 * chunk_at<C, bf16>(r, ch), W + (size_t)(row0 + r) * C + ch * 8);
  }
}

// out[r][co] = sum_{kk<K} sum_{ci<C} act(in[in_row0 + r + kk*d][ci]) * W[kk][ci][co]
// for r in [0, n_out); act is lrelu when LRELU_IN, else the identity. `in`
// is a swizzled [rows][C] bf16 tile holding rows in_row0 .. in_row0 + n_out
// + (K-1)*d - 1. W_next (K_next taps) is the weight of the conv the block
// runs next, or nullptr; its first chunks are fetched during this one.
// epi(r, co, v) consumes columns co, co+1 of row r exactly once, as JAX
// rounds them in bf16: v = round(round(sum) + bias). Every thread of the
// block must call this; it returns after a barrier, with every epilogue
// write visible.
template <int C, bool LRELU_IN, typename Epi>
__device__ void mma_conv(const bf16* in, int in_row0, int n_out, const bf16* __restrict__ W,
                         const bf16* __restrict__ bias, int K, int d, WeightRing<bf16>& ring,
                         const bf16* __restrict__ W_next, int K_next, Epi epi) {
  using Cfg = MmaTile<C, bf16>;
  static_assert(Cfg::kNT % 2 == 0, "B fragments load in n8 pairs");
  constexpr int MT = Cfg::kMT, NT = Cfg::kNT, WM = Cfg::kWM, KC = Cfg::kKC;
  constexpr int S = Cfg::kStages;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int wm = warp / Cfg::kWN, wn = warp % Cfg::kWN;
  const int n_rows = K * C;
  const int n_chunks = (n_rows + KC - 1) / KC;
  const int n_pass = (n_out + Cfg::kPassRows - 1) / Cfg::kPassRows;
  const int total = n_pass * n_chunks;
  const int next_rows = W_next ? K_next * C : 0;
  // Prime the next conv only if all kStages-1 chunks it expects exist.
  const bool prime_next = (next_rows + KC - 1) / KC >= S - 1;

  // Chunk j of this conv's stream; j >= total runs into the next conv.
  auto issue = [&](int j) {
    bf16* dst = ring.stages + ((ring.head + j) % S) * KC * C;
    if (j < total) {
      const int c = j % n_chunks;
      load_w_chunk<C>(dst, W, c * KC, min(KC, n_rows - c * KC));
    } else if (prime_next && j - total < S - 1) {
      const int c = j - total;
      load_w_chunk<C>(dst, W_next, c * KC, min(KC, next_rows - c * KC));
    }
    cp_async_commit();
  };
  if (!ring.primed) {
#pragma unroll
    for (int s = 0; s < S - 1; ++s) issue(s);
  }

  const uint32_t in_base = smem_u32(in);
  const uint32_t ring_base = smem_u32(ring.stages);
  // B addresses: row (lane & 15) of a k16 step, n8 pair p of this warp. The
  // swizzle of row 16*s + (lane & 15) equals that of (lane & 15).
  uint32_t b_off[NT / 2];
#pragma unroll
  for (int p = 0; p < NT / 2; ++p)
    b_off[p] = 16 * chunk_at<C, bf16>(lane & 15, wn * NT + 2 * p + (lane >> 4));

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
        const uint32_t stage = ring_base + 2 * ((ring.head + j) % S) * KC * C;
        // One k16 step: rows [s, s + 16) of the chunk, i.e. tap jr / C,
        // input channels jr % C .. + 15.
        auto k_step = [&](int s) {
          const int jr = c * KC + s;
          const int tap = jr / C;
          const int ch = (jr % C) >> 3;
          uint32_t b[NT][2];
#pragma unroll
          for (int p = 0; p < NT / 2; ++p)
            ldsm_x4_trans(b[2 * p][0], b[2 * p][1], b[2 * p + 1][0], b[2 * p + 1][1],
                          stage + 2 * s * C + b_off[p]);
#pragma unroll
          for (int i = 0; i < NA; ++i) {
            uint32_t a[4];
            ldsm_x4(a, in_base + 16 * chunk_at<C, bf16>(arow[i] + tap * d, ch + (lane >> 4)));
            if (LRELU_IN) {
#pragma unroll
              for (int q = 0; q < 4; ++q) a[q] = lrelu_bf16x2(a[q]);
            }
#pragma unroll
            for (int n = 0; n < NT; ++n) mma_16816(acc[i][n], a, b[n][0], b[n][1]);
          }
        };
        const int rows = min(KC, n_rows - c * KC);
        if constexpr (NA > 0) {
          if (rows == KC) {
#pragma unroll
            for (int s = 0; s < KC; s += 16) k_step(s);
          } else {  // last chunk of a K*C that KC does not divide
            for (int s = 0; s < rows; s += 16) k_step(s);
          }
        }
      }
    });

    const int g = lane >> 2, t = lane & 3;
    bf16x2 bb[NT];
#pragma unroll
    for (int n = 0; n < NT; ++n)
      bb[n] = *reinterpret_cast<const bf16x2*>(bias + (wn * NT + n) * 8 + 2 * t);
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      if (!act[i]) continue;
      const int r0 = ((pass * MT + i) * WM + wm) * 16;
      const int r = r0 + g;
      auto out = [&](int n, bool lo, bool hi) {
        const int co = (wn * NT + n) * 8 + 2 * t;
        const bf16x2 lo_v = __floats2bfloat162_rn(acc[i][n][0], acc[i][n][1]);
        const bf16x2 hi_v = __floats2bfloat162_rn(acc[i][n][2], acc[i][n][3]);
        if (lo) epi(r, co, __hadd2(lo_v, bb[n]));
        if (hi) epi(r + 8, co, __hadd2(hi_v, bb[n]));
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
