// Hopper conv core of the HiFi-GAN MRF kernels' bf16 instantiation
// (resblock.cu, mrf_stage.cu): wgmma m64nNk16 with A from registers and the
// HIO weights read MN-major from an mbarrier ring that a producer thread
// fills by TMA. The f32 instantiation has a core of the same shape on a
// 3xTF32 split (wgmma_conv_f32.cuh).
//
// Takes the place of the TPU kernels' MXU matmuls in bf16
// (emotivoice_tpu/ops/pallas/resblock.py, _residual_unit_kernel, and
// emotivoice_tpu/ops/pallas/packed_stage.py, _mrf_stage_kernel, each a
// dilated conv as K shifted (rows x C_in) @ (C_in x C_out) products).
//
// Bound on the H100: operations. A conv does 2*K*C*C FLOP per row against
// 2*C bytes of bf16 activation in and out, far above the card's ~295
// FLOP/byte balance point of the bf16 tensor cores (989 TFLOP/s), and only
// wgmma reaches that rate (mma.sync, the core this one replaced, does not).
//
// Design: an implicit GEMM per conv (tap kk = the activation tile shifted by
// kk*d rows, times W[kk]; no im2col), in the f32 core's block of three
// warpgroups:
//  - A producer thread (thread 0 of warpgroup 2) keeps TMA loads of weight
//    tiles in flight into a ring of `stages` stages, one full and one empty
//    mbarrier per stage. A stage is kKC rows of one conv's W flattened to
//    (K*C_in, C_out): one tap, kKC input channels, every output channel, as
//    C / 64 boxes of 64 columns (one box of 32 at C = 32), each one swizzle
//    atom column of 128 bytes (64 at C = 32). bf16 wgmma reads B MN-major
//    (imm-trans-b), so the HIO weights are read as they are: no relayout, no
//    tail, one map per conv over its own tensor.
//  - Two consumer warpgroups split the rows: m64 tile i of a pass belongs to
//    warpgroup i % 2, and each holds kMT m64 x C accumulators (kMT * C / 2
//    registers a thread, within the 168 ptxas gives every thread of 384).
//  - A comes from registers: each warp loads its 16 rows of the shifted tap
//    with ldmatrix.x4 from the swizzled bf16 tile, which for a bf16 m16 x k16
//    fragment is wgmma's register layout, and applies lrelu in bf16x2 there
//    (max(a, a * bf16(0.1)), the JAX reference's rounding). A from a
//    descriptor would have to start at the swizzle atoms; from registers the
//    tap's row shift is free.
//  - Per k16 step a warpgroup issues one wgmma per active m64 tile, as one
//    group. With kWait = 1 it keeps that group in flight while it loads the
//    next step's A fragments (two register sets, for even and odd steps),
//    then waits for the group before it, and releases a stage once its last
//    step has retired, across stages and convs; kWait = 0 drains every step.
//    A group per step, not per stage, keeps the A fragments in flight to
//    2 * kMT * 4 registers: with a stage's worth of them beside the
//    accumulators, ptxas serialized the wgmmas for want of registers.
//  - Activation tiles: slab-major, 64 channels (128 bytes; 32 channels, 64
//    bytes at C = 32) a slab row, 16-byte chunk c of row r at c ^ (r & 7)
//    (c ^ ((r >> 1) & 3) at 64 bytes): what a TMA load with that swizzle
//    writes, and conflict-free for ldmatrix.
//  - Epilogue (EpiBf16): v = round(round(sum) + bias) in bf16x2, where the
//    JAX reference rounds, then the kernel's residual add, lrelu and zero
//    rows, written to a swizzled tile in shared memory. A warp whose 16 rows
//    are all outputs writes 4 n8 blocks of them with one stmatrix.x4 (and
//    reads the residual with one ldmatrix.x4), the registers of the
//    accumulators being stmatrix's layout: with a 32-bit store and an
//    address per pair the MRF stage took 4.92 ms a generator call, 4.29
//    with these, on an H100 (chip_smoke.py; PERF.md).

#pragma once

#include "conv_tile.cuh"
#include "hopper.cuh"

namespace evt {

// Tiling of the core per C: kMT m64 tiles per consumer warpgroup and pass,
// kKC input channels per ring stage (a multiple of 16 dividing C), kStages
// the deepest ring a launch takes (fewer where shared memory is short; at
// least 2), kWait the wgmma groups left in flight at each k16 step (0 or 1).
// At C = 32 ptxas serializes the wgmmas of kWait = 1 (C7513) whenever kMT >
// 2, and draining each step of six m64 tiles was the fastest (PERF.md).
template <int C> struct WgCfgBf16;
template <> struct WgCfgBf16<32> { static constexpr int kMT = 6, kKC = 32, kStages = 8, kWait = 0; };
template <> struct WgCfgBf16<64> { static constexpr int kMT = 2, kKC = 64, kStages = 6, kWait = 1; };
template <> struct WgCfgBf16<128> { static constexpr int kMT = 1, kKC = 64, kStages = 4, kWait = 1; };
template <> struct WgCfgBf16<256> { static constexpr int kMT = 1, kKC = 32, kStages = 4, kWait = 1; };

template <int C> struct WgTileBf16 : WgCfgBf16<C> {
  using Cfg = WgCfgBf16<C>;
  static constexpr int kSlabCh = C < 64 ? C : 64;         // channels of a swizzle row
  static constexpr int kSwizzle = 2 * kSlabCh;            // its bytes: 128, or 64 at C = 32
  static constexpr int kSteps = Cfg::kKC / 16;            // k16 wgmma steps per stage
  static constexpr int kAtomBytes = Cfg::kKC * kSwizzle;  // one box of a stage
  static constexpr int kStageBytes = C * Cfg::kKC * 2;
  static constexpr int kPassRows = kConsumerWGs * Cfg::kMT * 64;
  static_assert(C % Cfg::kKC == 0 && Cfg::kKC % 16 == 0, "a stage is whole k16 steps of one tap");
  static_assert(Cfg::kMT * C / 2 <= 128, "accumulators fit the registers");
  static_assert(Cfg::kStages >= 2 && (Cfg::kWait == 0 || Cfg::kWait == 1), "ring and wait depth");
  static_assert(kAtomBytes % 1024 == 0, "boxes stay aligned to the swizzle atoms");
};

// A slab-major swizzled bf16 activation tile in shared memory.
template <int C> struct ActTileBf16 {
  static constexpr int kRow = WgTileBf16<C>::kSwizzle;  // bytes of a slab row
  uint32_t addr;  // shared address of slab 0, row 0 (1024-byte aligned)
  char* ptr;      // the same as a generic pointer
  int rows;       // rows per slab (a multiple of 8)

  // Byte offset of 16-byte chunk ch (channels 8ch..8ch+7) of row r.
  __device__ __forceinline__ int off(int r, int ch) const {
    constexpr int kChunks = kRow / 16;
    const int sw = kRow == 128 ? (r & 7) : ((r >> 1) & 3);
    return ((ch / kChunks) * rows + r) * kRow + (((ch % kChunks) ^ sw) << 4);
  }
  __device__ __forceinline__ bf16x2& pair(int r, int co) const {
    return *reinterpret_cast<bf16x2*>(ptr + off(r, co >> 3) + (co & 7) * 2);
  }
};

// bf16 a + b for the 8 values of a 16-byte chunk, each rounded once.
__device__ __forceinline__ uint4 add_chunk(uint4 a, uint4 b) {
  bf16x2* p = reinterpret_cast<bf16x2*>(&a);
  const bf16x2* q = reinterpret_cast<const bf16x2*>(&b);
#pragma unroll
  for (int i = 0; i < 4; ++i) p[i] = __hadd2(p[i], q[i]);
  return a;
}

__device__ __forceinline__ uint32_t lrelu_bits(uint32_t v) {
  bf16x2 a = lrelu2(*reinterpret_cast<bf16x2*>(&v));
  return *reinterpret_cast<uint32_t*>(&a);
}

// The weight ring in shared memory: kStageBytes per stage, then the full and
// empty mbarriers of every stage. Producer and consumers walk the same
// sequence of stages, so each keeps its own (stage, phase) position.
template <int C> struct RingBf16 {
  uint32_t base;  // stage 0; stage s at base + s * kStageBytes
  uint32_t bars;  // full[s] = bars + 8s, empty[s] = full[stages + s]
  int stages;
  int s = 0;
  uint32_t phase = 0;

  __device__ __forceinline__ uint32_t stage() const { return base + s * WgTileBf16<C>::kStageBytes; }
  __device__ __forceinline__ uint32_t full() const { return bars + 8 * s; }
  __device__ __forceinline__ uint32_t empty() const { return bars + 8 * (stages + s); }
  __device__ __forceinline__ void advance() {
    if (++s == stages) {
      s = 0;
      phase ^= 1;
    }
  }

  // One thread: barrier counts (full: the producer's arrive with its bytes;
  // empty: the consumer warps).
  __device__ void init() {
    for (int i = 0; i < stages; ++i) {
      sm90::mbar_init(bars + 8 * i, 1);
      sm90::mbar_init(bars + 8 * (stages + i), kConsumers / 32);
    }
  }

  // Producer thread: the stages of one conv of K taps over the (K * C, C)
  // map of its weight, once per pass over n_out rows.
  __device__ void produce(const CUtensorMap* w_map, int K, int n_out) {
    using Cfg = WgTileBf16<C>;
    constexpr int KC = Cfg::kKC;
    const int n_pass = cdiv(n_out, Cfg::kPassRows);
    for (int p = 0; p < n_pass; ++p)
      for (int kk = 0; kk < K; ++kk)
        for (int cc = 0; cc < C / KC; ++cc) {
          sm90::mbar_wait(empty(), phase ^ 1);
          sm90::mbar_arrive_expect_tx(full(), Cfg::kStageBytes);
#pragma unroll
          for (int a = 0; a < C / Cfg::kSlabCh; ++a)
            sm90::tma_load_2d(stage() + a * Cfg::kAtomBytes, w_map, full(), a * Cfg::kSlabCh,
                              kk * C + cc * KC);
          advance();
        }
  }
};

// What the core writes for output row r of a conv: out row off + r = v (plus
// its old value if kResidual), then lrelu if kLrelu, and zero if kMask and
// the global row g0 + r lies outside [0, T_len) (each conv's zero padding).
template <int C, bool kLrelu, bool kResidual_, bool kMask> struct EpiBf16 {
  static constexpr bool kResidual = kResidual_;
  ActTileBf16<C> out;
  int off;  // out's row of output row 0
  int g0;   // global row of output row 0
  int T_len;

  __device__ __forceinline__ bool ok(int r) const {
    return !kMask || (g0 + r >= 0 && g0 + r < T_len);
  }
  __device__ __forceinline__ bf16x2 apply(bf16x2 v, bf16x2 old, bool row_ok) const {
    if (kResidual) v = add2(old, v);
    if (kLrelu) v = lrelu2(v);
    return row_ok ? v : __float2bfloat162_rn(0.f);
  }
};

// out[r][co] = sum_{kk<K} sum_{ci<C} act(in[in_row0 + r + kk*d][ci]) * W[kk][ci][co]
// for r in [0, n_out), act lrelu when LRELU_IN, else the identity; the
// weights are the ring's next stages, as the producer streams them; epi
// (EpiBf16) writes the rows. Called by the 256 consumer threads; returns
// after a consumer barrier, with every epilogue write visible. SYNC_EPI: the
// epilogue writes output row r over input row in_row0 + r, so every pass
// waits for all reads of the pass before its epilogue; later passes read
// only rows past it.
template <int C, bool LRELU_IN, bool SYNC_EPI, typename Epi>
__device__ __forceinline__ void wg_conv_bf16(const ActTileBf16<C>& in, int in_row0, int n_out,
                                             int K, int d, const bf16* __restrict__ bias,
                                             RingBf16<C>& ring, const Epi& epi) {
  using Cfg = WgTileBf16<C>;
  constexpr int MT = Cfg::kMT, KC = Cfg::kKC, KS = Cfg::kSteps, NACC = C / 2;
  const int wg = threadIdx.x >> 7;
  const int warp = (threadIdx.x >> 5) & 3;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int n_pass = cdiv(n_out, Cfg::kPassRows);
  const int n_stages = K * (C / KC);

  for (int pass = 0; pass < n_pass; ++pass) {
    // m64 tile of slot i; slot i is active while its tile has rows below
    // n_out, so the active slots are the first n_act.
    int arow[MT];
    int n_act = 0;
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      const int mt = (pass * MT + i) * kConsumerWGs + wg;
      n_act += mt * 64 < n_out;
      arow[i] = in_row0 + min(mt * 64 + warp * 16 + (lane & 15), n_out - 1);
    }
    float acc[MT][NACC];
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int q = 0; q < NACC; ++q) acc[i][q] = 0.f;

    with_count<MT>(n_act, [&](auto na) {
      constexpr int NA = decltype(na)::value;
      uint32_t frag[2][NA > 0 ? NA : 1][4];  // A of even and odd k16 steps
      bool held = false;  // the last stage's final wgmmas are in flight (kWait 1)
      uint32_t held_empty = 0;
      // Stage c; `pair` is 0 or 1 for the even or odd stage of a pair. Stages
      // run in unrolled pairs: with one stage a loop iteration ptxas
      // serialized the wgmmas at C = 64 and 128 (C7513).
      auto run_stage = [&](int c, auto pair) {
        sm90::mbar_wait(ring.full(), ring.phase);
        if constexpr (NA > 0) {
          constexpr int P = decltype(pair)::value;
          const int shift = c / (C / KC) * d;
          const int ch0 = c % (C / KC) * (KC / 8);  // first 16-byte chunk of its input channels
#pragma unroll
          for (int s = 0; s < KS; ++s) {
            uint32_t (&a)[NA][4] = frag[(P * KS + s) & 1];
#pragma unroll
            for (int i = 0; i < NA; ++i) {
              ldsm_x4(a[i], in.addr + in.off(arow[i] + shift, ch0 + 2 * s + (lane >> 4)));
              if (LRELU_IN) {
#pragma unroll
                for (int q = 0; q < 4; ++q) a[i][q] = lrelu_bits(a[i][q]);
              }
              sm90::fence_regs(a[i]);
            }
            const uint64_t desc = sm90::smem_desc_mnmajor(ring.stage() + s * 16 * Cfg::kSwizzle,
                                                          Cfg::kSwizzle, Cfg::kAtomBytes);
            sm90::wgmma_fence();
#pragma unroll
            for (int i = 0; i < NA; ++i) sm90::WgmmaBf16<C>::run(acc[i], a[i], desc);
            sm90::wgmma_commit();
            sm90::wgmma_wait<Cfg::kWait>();
            if (Cfg::kWait > 0 && s == 0 && held) {  // the last stage's wgmmas have retired
              __syncwarp();
              if (lane == 0) sm90::mbar_arrive(held_empty);
              held = false;
            }
          }
        }
        __syncwarp();
        if (Cfg::kWait == 0 || NA == 0) {
          if (lane == 0) sm90::mbar_arrive(ring.empty());
        } else {
          held = true;
          held_empty = ring.empty();
        }
        ring.advance();
      };
      int c = 0;
      for (; c + 1 < n_stages; c += 2) {
        run_stage(c, std::integral_constant<int, 0>{});
        run_stage(c + 1, std::integral_constant<int, 1>{});
      }
      if (c < n_stages) run_stage(c, std::integral_constant<int, 0>{});
      if constexpr (NA > 0 && Cfg::kWait > 0) {
        sm90::wgmma_wait<0>();
        __syncwarp();
        if (held && lane == 0) sm90::mbar_arrive(held_empty);
      }
#pragma unroll
      for (int i = 0; i < NA; ++i) sm90::fence_regs(acc[i]);
    });

    if (SYNC_EPI) sm90::bar_sync(kConsumerBar, kConsumers);
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      const int rw = ((pass * MT + i) * kConsumerWGs + wg) * 64 + warp * 16;  // the warp's rows
      if (rw >= n_out) continue;
      const bool ok_lo = epi.ok(rw + g), ok_hi = epi.ok(rw + g + 8);
      // the pair of columns co, co+1 in rows g and g+8 of n8 block j, bias added
      auto pair = [&](int j, int h) {
        const bf16x2 bb = *reinterpret_cast<const bf16x2*>(bias + 8 * j + 2 * t);
        return __hadd2(__floats2bfloat162_rn(acc[i][4 * j + 2 * h], acc[i][4 * j + 2 * h + 1]), bb);
      };
      if (rw + 16 <= n_out) {
        // stmatrix.x4 q: rows 8 (q & 1) .. + 7 of n8 block 2jj + (q >> 1); lane
        // l gives the address of row l & 7 of matrix l >> 3
        const int lrow = epi.off + rw + ((lane >> 3) & 1) * 8 + (lane & 7);
#pragma unroll
        for (int jj = 0; jj < C / 16; ++jj) {
          const uint32_t addr = epi.out.addr + epi.out.off(lrow, 2 * jj + (lane >> 4));
          bf16x2 v[4] = {pair(2 * jj, 0), pair(2 * jj, 1), pair(2 * jj + 1, 0), pair(2 * jj + 1, 1)};
          uint32_t old[4] = {0, 0, 0, 0};
          if (Epi::kResidual) ldsm_x4(old, addr);
#pragma unroll
          for (int q = 0; q < 4; ++q)
            v[q] = epi.apply(v[q], *reinterpret_cast<bf16x2*>(&old[q]), q & 1 ? ok_hi : ok_lo);
          stsm_x4(addr, *reinterpret_cast<uint32_t(*)[4]>(v));
        }
      } else {  // the last rows of the conv: pair by pair, rows below n_out only
#pragma unroll
        for (int j = 0; j < C / 8; ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int r = rw + g + 8 * h;
            if (r >= n_out) continue;
            bf16x2& o = epi.out.pair(epi.off + r, 8 * j + 2 * t);
            o = epi.apply(pair(j, h), o, h ? ok_hi : ok_lo);
          }
      }
    }
  }
  sm90::bar_sync(kConsumerBar, kConsumers);
}

// Consumer thread 0: expect and issue the TMA loads of one activation tile,
// rows [g0, g0 + n_box * box_rows) of batch row b, every slab, from a 3D map
// over (B, T, C) with boxes of (kSlabCh, box_rows, 1); rows outside [0, T)
// land as zeros.
template <int C>
__device__ void load_act_tile_bf16(const ActTileBf16<C>& dst, const CUtensorMap* x_map,
                                   uint32_t bar, int b, int g0, int box_rows, int n_box) {
  using Cfg = WgTileBf16<C>;
  sm90::mbar_arrive_expect_tx(bar, (uint32_t)(C / Cfg::kSlabCh) * n_box * box_rows * Cfg::kSwizzle);
  for (int sl = 0; sl < C / Cfg::kSlabCh; ++sl)
    for (int i = 0; i < n_box; ++i)
      sm90::tma_load_3d(dst.addr + (sl * dst.rows + i * box_rows) * Cfg::kSwizzle, x_map, bar,
                        sl * Cfg::kSlabCh, g0 + i * box_rows, b);
}

// Host: smem bytes of the ring with `stages` stages (tiles and barriers).
template <int C> constexpr size_t ring_bytes_bf16(int stages) {
  return (size_t)stages * (WgTileBf16<C>::kStageBytes + 16);
}

// Host: the map over one conv's weight, W (K, C_in, C_out) as (K * C, C)
// rows with boxes of (kSlabCh, kKC).
template <int C> cudaError_t encode_weight_map_bf16(CUtensorMap* w_map, const void* w, int K) {
  const uint64_t dims[2] = {(uint64_t)C, (uint64_t)K * C};
  const uint32_t box[2] = {(uint32_t)WgTileBf16<C>::kSlabCh, (uint32_t)WgCfgBf16<C>::kKC};
  return sm90::encode_bf16_map(w_map, w, 2, dims, box);
}

// Host: the map over the activation x (B, T, C) with boxes of box_rows rows.
template <int C>
cudaError_t encode_act_map_bf16(CUtensorMap* x_map, const void* x, int B, int T_len, int box_rows) {
  const uint64_t dims[3] = {(uint64_t)C, (uint64_t)T_len, (uint64_t)B};
  const uint32_t box[3] = {(uint32_t)WgTileBf16<C>::kSlabCh, (uint32_t)box_rows, 1};
  return sm90::encode_bf16_map(x_map, x, 3, dims, box);
}

}  // namespace evt
