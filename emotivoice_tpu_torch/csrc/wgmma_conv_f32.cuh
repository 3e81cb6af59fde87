// Hopper conv core of the HiFi-GAN MRF kernels' f32 instantiation
// (resblock.cu, mrf_stage.cu): wgmma on a 3xTF32 split, weights through TMA
// into an mbarrier ring fed by a producer warp. The bf16 instantiation has a
// core of the same shape without the split (wgmma_conv_bf16.cuh).
//
// Takes the place of the TPU kernels' MXU matmuls at f32 precision
// (emotivoice_tpu/ops/pallas/resblock.py, _residual_unit_kernel, and
// emotivoice_tpu/ops/pallas/packed_stage.py, _mrf_stage_kernel, under
// jax_default_matmul_precision "highest").
//
// Bound on the H100: operations. The tensor cores take f32 only as TF32 (a
// 10-bit mantissa), and one TF32 product per f32 product misses the f32
// path's 2e-4 agreement with its plain version. Three do not: a*b is taken as
// a_tail*b_head + a_head*b_tail + a_head*b_head, summed in f32 (the
// tail*tail term, ~2^-22 of the product, is dropped). So the least time for
// f32-accurate work is 3 * FLOP / 495 TFLOP/s (dense TF32), and only wgmma
// reaches that rate: mma.sync (the core this one replaced) does not.
//
// Design: an implicit GEMM per conv (tap kk = the activation tile shifted by
// kk*d rows, times W[kk]; no im2col), in a block of three warpgroups:
//  - A producer warp (warp 0 of warpgroup 2, one thread) keeps TMA loads of
//    weight tiles in flight into a ring of `stages` stages, one full and one
//    empty mbarrier per stage. A stage is the (C_out, kKC) tile of one tap
//    and kKC input channels, K-major: wgmma takes tf32 B only K-major, so
//    the wrappers hand the kernels W as (taps, C_out, C_in), C_in
//    contiguous, and the map's swizzle (kKC * 4 bytes) is the descriptor's.
//  - The B tail: the head is the raw f32 tile as TMA lands it, which the
//    tensor cores read truncated to TF32; the tail, rna_tf32(w - trunc(w)),
//    is made in shared memory beside the stage by warps 1-3 of the producer
//    warpgroup as soon as it lands (they signal a third, "ready" mbarrier).
//    A tail tensor in device memory would double the L2 weight stream; tails split in registers by every
//    consumer (as the mma.sync core did) are impossible, B being read by the
//    tensor cores from shared memory. head + tail = w within 2^-22 |w|.
//  - Two consumer warpgroups run wgmma on the stages that have landed. They
//    split the rows: m64 tile i of a pass belongs to warpgroup i % 2, and
//    each holds kMT m64 x C accumulators (kMT * C / 2 registers a thread).
//    Registers bound the tiling: ptxas gives every thread of the kernel 168
//    registers (64K over 384 threads; over 320 threads too, warpgroups
//    counting whole), and setmaxnreg, the producer warpgroup handing
//    registers to the consumers, did not raise that budget for the
//    consumers' code (PERF.md): kMT * C / 2 accumulators plus the A
//    fragments of a stage have to fit, or ptxas serializes the wgmmas.
//  - A comes from registers: each warp loads its 16 rows of the shifted tap
//    with ldmatrix "b16" on the swizzled f32 tile (8x8 b16 matrices are 8
//    rows x 4 floats, so lane (g, t) receives (g, t), (g+8, t), (g, t+4),
//    (g+8, t+4): wgmma's tf32 A layout), applies lrelu and splits each value
//    into TF32 head and tail. A from a descriptor would have to start at the
//    swizzle atoms; from registers the tap's row shift is free.
//  - Per stage a warpgroup issues 3 * (kKC / 8) * (active m64 tiles) wgmmas
//    (tail terms first, so products into one accumulator are not adjacent),
//    commits, waits and releases the stage. The other warpgroup's wgmmas keep
//    the tensor cores busy meanwhile.
//  - Activation tiles: slab-major, 32 channels (128 bytes) a slab, rows of a
//    slab 128-byte swizzled (16-byte chunk c of row r at c ^ (r & 7)): what a
//    TMA load with SWIZZLE_128B writes, and conflict-free for ldmatrix (any
//    8 consecutive rows of one chunk hit 8 bank groups).
//  - Epilogue: epi(r, co, v) consumes columns co, co+1 of row r exactly once,
//    v = sum + bias in f32, no rounding; the kernels apply lrelu, the residual
//    add or the chain sum there.
//  - Error: wgmma adds in another order than mma.sync; the worst f32 error
//    against the plain version is in PERF.md beside the 2e-4 limit.

#pragma once

#include "conv_tile.cuh"
#include "hopper.cuh"

namespace evt {

// Tiling of the core per C: kMT m64 tiles per consumer warpgroup and pass,
// kKC input channels per ring stage (8 / 16 / 32: 32 / 64 / 128-byte
// swizzle), kStages the deepest ring a launch takes (fewer where shared
// memory is short; at least 2).
template <int C> struct WgCfg;
template <> struct WgCfg<32> { static constexpr int kMT = 2, kKC = 32, kStages = 6; };
template <> struct WgCfg<64> { static constexpr int kMT = 2, kKC = 32, kStages = 4; };
template <> struct WgCfg<128> { static constexpr int kMT = 1, kKC = 32, kStages = 4; };
template <> struct WgCfg<256> { static constexpr int kMT = 1, kKC = 8, kStages = 4; };

constexpr int kTailWarps = 3;  // warps 1-3 of the producer warpgroup
constexpr int kSlab = 32;      // channels per 128-byte activation slab

template <int C> struct WgTile : WgCfg<C> {
  using Cfg = WgCfg<C>;
  static_assert(C % kSlab == 0 && C % Cfg::kKC == 0, "slabs and stages tile C");
  static_assert(Cfg::kKC == 8 || Cfg::kKC == 16 || Cfg::kKC == 32, "a swizzle mode per kKC");
  static_assert(Cfg::kMT * C / 2 <= 128, "accumulators fit the registers");
  static constexpr int kPassRows = kConsumerWGs * Cfg::kMT * 64;
  static constexpr int kSwizzle = Cfg::kKC * 4;            // bytes of a stage row
  static constexpr int kStageBytes = C * Cfg::kKC * 4;     // head; the tail as much again
  static_assert(kStageBytes % 1024 == 0, "stages stay aligned to the swizzle atoms");
};

// A slab-major swizzled f32 activation tile in shared memory.
struct ActTile {
  uint32_t addr;  // shared address of slab 0, row 0 (1024-byte aligned)
  char* ptr;      // the same as a generic pointer
  int rows;       // rows per slab (a multiple of 8)

  // Byte offset of 16-byte chunk ch (channels 4ch..4ch+3) of row r.
  __device__ __forceinline__ int off(int r, int ch) const {
    return ((ch >> 3) * rows + r) * 128 + (((ch & 7) ^ (r & 7)) << 4);
  }
  __device__ __forceinline__ float2& pair(int r, int co) const {
    return *reinterpret_cast<float2*>(ptr + off(r, co >> 2) + (co & 3) * 4);
  }
};

// A TF32 operand in registers: head = rna_tf32(v); the tail is v - head plus
// half a TF32 ulp, which the tensor cores read truncated, i.e. rounded
// to nearest (the ties away from zero of tf32_round in ops/cuda/resblock.py).
__device__ __forceinline__ void split_tf32(float v, uint32_t& head, uint32_t& tail) {
  head = (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
  tail = __float_as_uint(v - __uint_as_float(head)) + 0x1000u;
}

// The B tail of a weight as the tensor cores read it beside the raw head:
// w - trunc_tf32(w) (exact) plus half a TF32 ulp.
__device__ __forceinline__ uint32_t weight_tail(float w) {
  return __float_as_uint(w - __uint_as_float(__float_as_uint(w) & 0xffffe000u)) + 0x1000u;
}

// The weight ring in shared memory: per stage a head and a tail tile
// (kStageBytes each), then the full, ready and empty mbarriers of every
// stage. Every role walks the same sequence of chunks, so each keeps its
// own (stage, phase) position.
template <int C> struct WgRing {
  uint32_t base;  // stage 0's head; stage s at base + 2 * s * kStageBytes
  uint32_t bars;  // full[s] = bars + 8s, ready[s] = full[stages + s], empty[s] = full[2 * stages + s]
  int stages;
  int s = 0;
  uint32_t phase = 0;

  __device__ __forceinline__ uint32_t head() const { return base + 2 * s * WgTile<C>::kStageBytes; }
  __device__ __forceinline__ uint32_t full() const { return bars + 8 * s; }
  __device__ __forceinline__ uint32_t ready() const { return bars + 8 * (stages + s); }
  __device__ __forceinline__ uint32_t empty() const { return bars + 8 * (2 * stages + s); }
  __device__ __forceinline__ void advance() {
    if (++s == stages) {
      s = 0;
      phase ^= 1;
    }
  }

  // One thread: barrier counts (full: the producer's arrive with its bytes;
  // ready: the tail warps; empty: the consumer warps).
  __device__ void init() {
    for (int i = 0; i < stages; ++i) {
      sm90::mbar_init(bars + 8 * i, 1);
      sm90::mbar_init(bars + 8 * (stages + i), kTailWarps);
      sm90::mbar_init(bars + 8 * (2 * stages + i), kConsumers / 32);
    }
  }

  // Producer thread: the chunks of one conv of K taps whose weights start at
  // tap tap0 of the (taps, C_out, C_in) map, once per pass over n_out rows.
  __device__ void produce(const CUtensorMap* w_map, int tap0, int K, int n_out) {
    constexpr int KC = WgCfg<C>::kKC;
    const int n_pass = cdiv(n_out, WgTile<C>::kPassRows);
    for (int p = 0; p < n_pass; ++p)
      for (int kk = 0; kk < K; ++kk)
        for (int cc = 0; cc < C / KC; ++cc) {
          sm90::mbar_wait(empty(), phase ^ 1);
          sm90::mbar_arrive_expect_tx(full(), WgTile<C>::kStageBytes);
          sm90::tma_load_2d(head(), w_map, full(), cc * KC, (tap0 + kk) * C);
          advance();
        }
  }

  // Tail warps (thread `i` of them): the tails of the next n chunks, each as
  // soon as its head has landed.
  __device__ void make_tails(int n, int i) {
    constexpr int kVecs = WgTile<C>::kStageBytes / 16;
    for (int c = 0; c < n; ++c) {
      sm90::mbar_wait(full(), phase);
      char* h = static_cast<char*>(__cvta_shared_to_generic(head()));
      const float4* src = reinterpret_cast<const float4*>(h);
      uint4* dst = reinterpret_cast<uint4*>(h + WgTile<C>::kStageBytes);
      for (int v = i; v < kVecs; v += 32 * kTailWarps) {
        const float4 w = src[v];
        dst[v] = make_uint4(weight_tail(w.x), weight_tail(w.y), weight_tail(w.z), weight_tail(w.w));
      }
      sm90::fence_proxy_async();  // the tail, written here, is read by wgmma
      __syncwarp();
      if ((i & 31) == 0) sm90::mbar_arrive(ready());
      advance();
    }
  }
};

// The chunks of one conv: passes x taps x C / kKC.
template <int C> __device__ __forceinline__ int conv_chunks(int K, int n_out) {
  return cdiv(n_out, WgTile<C>::kPassRows) * K * (C / WgCfg<C>::kKC);
}

// out[r][co] = sum_{kk<K} sum_{ci<C} act(in[in_row0 + r + kk*d][ci]) * W[kk][ci][co]
// for r in [0, n_out), act lrelu when LRELU_IN, else the identity; the
// weights are the ring's next chunks, as the producer streams them. Called
// by the 256 consumer threads; returns after a consumer barrier, with every
// epilogue write visible. SYNC_EPI: the epilogue writes output row r over
// input row in_row0 + r, so every pass waits for all reads of the pass
// before its epilogue; later passes read only rows past it.
template <int C, bool LRELU_IN, bool SYNC_EPI, typename Epi>
__device__ __forceinline__ void wg_conv(const ActTile& in, int in_row0, int n_out, int K, int d,
                        const float* __restrict__ bias, WgRing<C>& ring, Epi epi) {
  using Cfg = WgTile<C>;
  constexpr int MT = Cfg::kMT, KC = Cfg::kKC, NACC = C / 2;
  const int wg = threadIdx.x >> 7;
  const int warp = (threadIdx.x >> 5) & 3;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int n_pass = cdiv(n_out, Cfg::kPassRows);

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
      for (int kk = 0; kk < K; ++kk) {
        const int shift = kk * d;
        for (int cc = 0; cc < C / KC; ++cc) {
          sm90::mbar_wait(ring.full(), ring.phase);
          sm90::mbar_wait(ring.ready(), ring.phase);
          if constexpr (NA > 0) {
            const uint32_t bh = ring.head(), bt = bh + Cfg::kStageBytes;
#pragma unroll
            for (int s8 = 0; s8 < KC / 8; ++s8) {
              uint32_t ah[NA][4], al[NA][4];
#pragma unroll
              for (int i = 0; i < NA; ++i) {
                uint32_t a[4];
                ldsm_x4(a, in.addr + in.off(arow[i] + shift, cc * (KC / 4) + 2 * s8 + (lane >> 4)));
#pragma unroll
                for (int q = 0; q < 4; ++q) {
                  const float v = __uint_as_float(a[q]);
                  split_tf32(LRELU_IN ? lrelu(v) : v, ah[i][q], al[i][q]);
                }
              }
              const uint64_t dh = sm90::smem_desc_kmajor(bh + 32 * s8, Cfg::kSwizzle);
              const uint64_t dt = sm90::smem_desc_kmajor(bt + 32 * s8, Cfg::kSwizzle);
              sm90::wgmma_fence();
#pragma unroll
              for (int i = 0; i < NA; ++i) sm90::Wgmma<C>::run(acc[i], al[i], dh);
#pragma unroll
              for (int i = 0; i < NA; ++i) sm90::Wgmma<C>::run(acc[i], ah[i], dt);
#pragma unroll
              for (int i = 0; i < NA; ++i) sm90::Wgmma<C>::run(acc[i], ah[i], dh);
            }
            sm90::wgmma_commit();
            sm90::wgmma_wait<0>();
#pragma unroll
            for (int i = 0; i < NA; ++i) sm90::fence_regs(acc[i]);
          }
          __syncwarp();
          if (lane == 0) sm90::mbar_arrive(ring.empty());
          ring.advance();
        }
      }
    });

    if (SYNC_EPI) sm90::bar_sync(kConsumerBar, kConsumers);
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      const int r = ((pass * MT + i) * kConsumerWGs + wg) * 64 + warp * 16 + g;
      if (r - g - warp * 16 >= n_out) continue;
#pragma unroll
      for (int j = 0; j < C / 8; ++j) {
        const int co = 8 * j + 2 * t;
        const float2 bb = *reinterpret_cast<const float2*>(bias + co);
        if (r < n_out) epi(r, co, make_float2(acc[i][4 * j] + bb.x, acc[i][4 * j + 1] + bb.y));
        if (r + 8 < n_out)
          epi(r + 8, co, make_float2(acc[i][4 * j + 2] + bb.x, acc[i][4 * j + 3] + bb.y));
      }
    }
  }
  sm90::bar_sync(kConsumerBar, kConsumers);
}

// Consumer thread 0: expect and issue the TMA loads of one activation tile,
// rows [g0, g0 + n_box * box_rows) of batch row b, every slab, from a 3D map
// over (B, T, C) with boxes of (32, box_rows, 1); rows outside [0, T) land as
// zeros.
template <int C>
__device__ void load_act_tile(const ActTile& dst, const CUtensorMap* x_map, uint32_t bar, int b,
                              int g0, int box_rows, int n_box) {
  sm90::mbar_arrive_expect_tx(bar, (uint32_t)(C / kSlab) * n_box * box_rows * 128);
  for (int sl = 0; sl < C / kSlab; ++sl)
    for (int i = 0; i < n_box; ++i)
      sm90::tma_load_3d(dst.addr + (sl * dst.rows + i * box_rows) * 128, x_map, bar, sl * kSlab,
                        g0 + i * box_rows, b);
}

// Host: smem bytes of the ring with `stages` stages (tiles and barriers).
template <int C> constexpr size_t ring_bytes(int stages) {
  return (size_t)stages * 2 * WgTile<C>::kStageBytes + 8 * 3 * (size_t)stages;
}

// Host: the weight map over W (taps, C_out, C_in) and the activation map over
// x (B, T, C) with boxes of box_rows rows.
template <int C>
cudaError_t encode_maps(CUtensorMap* w_map, const void* w, int taps, CUtensorMap* x_map,
                        const void* x, int B, int T_len, int box_rows) {
  const uint64_t wd[2] = {(uint64_t)C, (uint64_t)taps * C};
  const uint32_t wb[2] = {(uint32_t)WgCfg<C>::kKC, (uint32_t)C};
  cudaError_t err = sm90::encode_f32_map(w_map, w, 2, wd, wb);
  if (err != cudaSuccess) return err;
  const uint64_t xd[3] = {(uint64_t)C, (uint64_t)T_len, (uint64_t)B};
  const uint32_t xb[3] = {(uint32_t)kSlab, (uint32_t)box_rows, 1};
  return sm90::encode_f32_map(x_map, x, 3, xd, xb);
}

}  // namespace evt
