// Flash attention forward: softmax(Q K^T / sqrt(D)) V over [B, L, H, D].
//
// Replaces mofa_tpu/kernels/flash_attention.py::_flash_fwd_kernel. The TPU
// kernel keeps one head's whole K/V in VMEM and runs a clamped fixed-max
// softmax by default; here a block walks the keys in 128-key tiles with
// the EXACT online-max softmax (running max and sum per row).
//
// bf16 path (the main path), FlashAttention-3 in shape, on Hopper's
// warpgroup tensor-core instruction `wgmma`. Bound: operations (4 L^2 D
// per head against 989 TFLOP/s bf16), with the softmax's exp2 on the
// multi-function unit close behind at D = 64: a 128-key tile costs as many
// exp2 issue cycles as its two products cost tensor-core cycles, so the
// design is about keeping both busy at once. One block per (batch x head,
// 64 NCW query rows), NCW + 1 warpgroups:
// - a producer warpgroup (its registers handed to the consumers with
//   `setmaxnreg`), one thread of which issues TMA copies: Q once, then K
//   and V tiles of 128 keys into a ring of STAGES stages, each behind a
//   "full" mbarrier (K and V apart, so S can start before V lands) and an
//   "empty" one that the consumers release; the tensor maps are 4-D ([B,
//   L, H, D], D in 64-wide boxes), so TMA zero-fills rows past L and writes
//   the 128-byte swizzle that wgmma reads without bank conflicts;
// - NCW consumer warpgroups of 64 query rows (3 at D = 64, 2 at D = 128,
//   as registers allow). S = Q K^T is `wgmma.m64n128k16` with Q and K from
//   shared memory (both K-major); the softmax runs on the fp32 accumulator
//   fragments in base 2 with the scale folded into one FMA; P is packed in
//   registers as the A operand of O += P V (`wgmma.m64nDk16`, V read
//   through the transposed-B layout from the [key][d] tile as it lies).
//   Each consumer is pipelined one tile deep (S of tile i is issued with
//   P V of tile i - 1, which runs under tile i's softmax), and the
//   consumers take turns to issue (named barriers, round robin), so one's
//   softmax runs under the others' products. The [L, L] logits never reach
//   device memory.
// D in {64, 128}; a ragged L is zero-filled by TMA and masked in the
// softmax (keys) or not stored (queries).
//
// fp32 path (training, composition checks), split TF32 on `wgmma`.
// Replaces the same TPU kernel at fp32 (stage-1 and stage-2 training run
// the adapter in fp32). The plain version computes in full fp32 (TF32
// off), and one TF32 product keeps about 11 bits, so each fp32 operand is
// split into big = tf32(x) and small = tf32(x - big) and each product is
// small * big + big * small + big * big on the tensor cores, with fp32
// accumulation: about 22 bits. Bound: operations, 3 x 4 L^2 D per head
// against 495 TFLOP/s dense TF32 (1.03 ms at [25, 2304, 5, 64], against
// 2.54 ms of fp32 FMA on the CUDA cores). The design:
// - a split pass writes q and k as big / small planes in their own layout
//   and v transposed, [B * H, D, keys], as two planes: tf32 `wgmma` reads
//   both operands K-major only, and V [key][d] is the MN-major B of P V.
//   The pass reads v once to split it anyway, so the transpose costs no
//   extra read; P V on `mma.sync` m16n8k8 could take the [key][d] tile as
//   it lies, but at `mma.sync`'s rate and issued by every warp in step.
//   In each 8 keys the Vt planes hold the keys in the order 0 2 4 6 1 3 5
//   7: a thread's accumulator fragment holds P's columns 2t and 2t + 1 of
//   each 8, and the tf32 A fragment wants columns t and t + 4, so P serves
//   as the A operand from its registers with no shuffle, the reordered
//   keys matching it;
// - one block per (batch x head, 64 NCW query rows), NCW consumer
//   warpgroups and a producer warpgroup whose one thread issues the TMA
//   copies: Q's two planes once, then per key tile K's two planes and
//   Vt's two into a ring of two stages behind full / empty mbarriers
//   (rows past L zero-filled by TMA, Vt zero-padded by the split pass);
// - a consumer runs S = Q K^T as three `wgmma.m64nBNk8` (shared-memory
//   operands) a k8 step, the exact online-max softmax in fp32 on the
//   accumulator fragments (a ragged L masked), splits P in registers and
//   runs the tile's P V as three `wgmma.m64nDk8` with P from registers
//   into a fresh accumulator, added to O in fp32 (the tensor cores' fp32
//   accumulation truncates: O summed there over 2304 keys read 1.6e-5
//   relative RMS from the plain version on an H100, a tile at a time
//   1.3e-6). A consumer waits for each product; the warpgroups
//   interleave, one's softmax under the other's products. At D = 64 two
//   consumers and 64-key tiles, at D = 128 one consumer and 32-key tiles,
//   as shared memory allows.
#include <algorithm>

#include "hopper.cuh"

using bf16 = __nv_bfloat16;

namespace {

constexpr int BN = 128;                 // keys per K/V tile
constexpr int ROW_BYTES = 128;          // one swizzled row: 64 bf16

// NCW consumer warpgroups of 64 query rows each, then one producer
// warpgroup: three consumers at D = 64 (their registers fit in 160), two
// at D = 128 (240).
template <int D, int NCW>
struct FlashCfg {
  static constexpr int BM = 64 * NCW;                    // query rows per block
  static constexpr int NTHREADS = 128 * (NCW + 1);
  // three stages: a pipelined consumer holds two (K of tile i, V of tile
  // i - 1), the third keeps one tile's copy in flight; 225 KB at D = 128
  static constexpr int STAGES = 3;
  static constexpr int Q_BYTES = BM * D * 2;
  static constexpr int KV_BYTES = BN * D * 2;            // one K or V tile
  static constexpr int SMEM = Q_BYTES + 2 * STAGES * KV_BYTES + 1024;  // + alignment
  // registers: the producer keeps 24, the consumers share the rest
  static constexpr int CONSUMER_REGS = NCW == 2 ? 240 : 160;
};

template <int D, int NCW>
__global__ void __launch_bounds__(FlashCfg<D, NCW>::NTHREADS, 1) flash_bf16_kernel(
    const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
    const __grid_constant__ CUtensorMap tv, bf16* __restrict__ out, int Lq, int Lk, int H,
    float scale_log2) {
  using C = FlashCfg<D, NCW>;
  constexpr int BM = C::BM, CHUNKS = D / 64;
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t bars[1 + 3 * C::STAGES];
  // swizzled tiles start on 1024-byte boundaries (the 8-row swizzle atom)
  const uint32_t sQ = (mofa::smem_addr(smem_raw) + 1023) & ~1023u;
  const uint32_t sK = sQ + C::Q_BYTES;
  const uint32_t sV = sK + C::STAGES * C::KV_BYTES;
  const uint32_t bar_q = mofa::smem_addr(&bars[0]);
  auto k_full = [&](int s) { return mofa::smem_addr(&bars[1 + s]); };
  auto v_full = [&](int s) { return mofa::smem_addr(&bars[1 + C::STAGES + s]); };
  auto empty = [&](int s) { return mofa::smem_addr(&bars[1 + 2 * C::STAGES + s]); };

  const int tid = threadIdx.x, wg = tid / 128;
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int q0 = blockIdx.x * BM;
  const int ntiles = (Lk + BN - 1) / BN;

  if (tid == 0) {
    mofa::mbar_init(bar_q, 1);
    for (int s = 0; s < C::STAGES; ++s) {
      mofa::mbar_init(k_full(s), 1);
      mofa::mbar_init(v_full(s), 1);
      mofa::mbar_init(empty(s), 4 * NCW);     // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == NCW) {
    // ---- producer: one thread issues every copy
    mofa::setmaxnreg_dec<24>();
    if (tid == NCW * 128) {
      mofa::mbar_arrive_expect_tx(bar_q, C::Q_BYTES);
#pragma unroll
      for (int c = 0; c < CHUNKS; ++c)
        mofa::tma_load_4d(sQ + c * BM * ROW_BYTES, &tq, bar_q, c * 64, h, q0, b);
      for (int i = 0; i < ntiles; ++i) {
        const int s = i % C::STAGES, round = i / C::STAGES;
        if (round > 0) mofa::mbar_wait(empty(s), (round - 1) & 1);
        const uint32_t ks = sK + s * C::KV_BYTES, vs = sV + s * C::KV_BYTES;
        mofa::mbar_arrive_expect_tx(k_full(s), C::KV_BYTES);
#pragma unroll
        for (int c = 0; c < CHUNKS; ++c)
          mofa::tma_load_4d(ks + c * BN * ROW_BYTES, &tk, k_full(s), c * 64, h, i * BN, b);
        mofa::mbar_arrive_expect_tx(v_full(s), C::KV_BYTES);
#pragma unroll
        for (int c = 0; c < CHUNKS; ++c)
          mofa::tma_load_4d(vs + c * BN * ROW_BYTES, &tv, v_full(s), c * 64, h, i * BN, b);
      }
    }
  } else {
    // ---- consumers: 64 query rows per warpgroup. Each is software-
    // pipelined one tile deep: S of tile i is issued with P V of tile
    // i - 1, whose product runs under tile i's softmax. The consumers take
    // turns issuing their products (named barriers, round robin), so one's
    // softmax runs under another's products.
    mofa::setmaxnreg_inc<C::CONSUMER_REGS>();
    const int warp = (tid % 128) / 32, lane = tid % 32;
    const int t = lane & 3;
    float o[D / 2];                           // O, 64 x D
    float s[BN / 2];                          // S, then P (fp32), 64 x 128
    uint32_t pa[BN / 16][4];                  // P as the A operand of P V
#pragma unroll
    for (int n = 0; n < D / 2; ++n) o[n] = 0.0f;
#pragma unroll
    for (int n = 0; n < BN / 2; ++n) s[n] = 0.0f;   // overwritten (scale-d 0)
    float m0 = -INFINITY, m1 = -INFINITY;     // running max of rows r, r + 8
    float l0 = 0.0f, l1 = 0.0f;               // running sums (this thread's part)
    const uint32_t qa = sQ + wg * 64 * ROW_BYTES;
    auto stage = [](int i) { return i % C::STAGES; };
    auto parity = [](int i) { return (uint32_t)((i / C::STAGES) & 1); };
    // turn-taking: wait for this warpgroup's turn, hand the turn on
    auto my_turn = [&]() { mofa::named_bar_sync(1 + wg, 256); };
    auto next_turn = [&]() { mofa::named_bar_arrive(1 + (wg + 1) % NCW, 256); };

    // S = Q K^T: D/16 k-steps; within a 64-wide box a k-step is 32 bytes
    auto issue_s = [&](int i) {
      const uint32_t ks = sK + stage(i) * C::KV_BYTES;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t off = (kk / 4) * BM * ROW_BYTES + (kk % 4) * 32;
        const uint32_t koff = (kk / 4) * BN * ROW_BYTES + (kk % 4) * 32;
        mofa::wgmma_m64n128k16_ss(s, mofa::gmma_desc_sw128(qa + off, 16, 1024),
                            mofa::gmma_desc_sw128(ks + koff, 16, 1024), kk > 0);
      }
      mofa::wgmma_commit();
    };
    // O += P V: V [key][d] as the transposed B operand; a k-step is 16
    // keys (2048 bytes); the two 64-wide boxes at D = 128 are LBO apart
    auto issue_pv = [&](int i) {
      const uint32_t vs = sV + stage(i) * C::KV_BYTES;
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk) {
        const uint64_t dv = mofa::gmma_desc_sw128(vs + kk * 16 * ROW_BYTES,
                                                  BN * ROW_BYTES, 1024);
        if constexpr (D == 64) mofa::wgmma_m64n64k16_rs(o, pa[kk], dv);
        else mofa::wgmma_m64n128k16_rs(o, pa[kk], dv);
      }
      mofa::wgmma_commit();
    };
    // online softmax of tile i in base 2 on the accumulator fragments: P
    // in place of S (fp32), the running max and sums updated; returns O's
    // corrections
    auto softmax = [&](int i, float& c0, float& c1) {
#pragma unroll
      for (int n = 0; n < BN / 2; ++n) mofa::fence_operand(s[n]);
      if ((i + 1) * BN > Lk) {
        const int kbase = i * BN + 2 * t;
#pragma unroll
        for (int n = 0; n < BN / 2; ++n)
          if (kbase + (n / 4) * 8 + (n & 1) >= Lk) s[n] = -INFINITY;
      }
      float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        mx0 = fmaxf(mx0, fmaxf(s[4 * j], s[4 * j + 1]));
        mx1 = fmaxf(mx1, fmaxf(s[4 * j + 2], s[4 * j + 3]));
      }
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
      const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
      c0 = mofa::ex2((m0 - mn0) * scale_log2);
      c1 = mofa::ex2((m1 - mn1) * scale_log2);
      m0 = mn0;
      m1 = mn1;
      const float ms0 = mn0 * scale_log2, ms1 = mn1 * scale_log2;
      float sum0 = 0.0f, sum1 = 0.0f;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        s[4 * j] = mofa::ex2(fmaf(s[4 * j], scale_log2, -ms0));
        s[4 * j + 1] = mofa::ex2(fmaf(s[4 * j + 1], scale_log2, -ms0));
        s[4 * j + 2] = mofa::ex2(fmaf(s[4 * j + 2], scale_log2, -ms1));
        s[4 * j + 3] = mofa::ex2(fmaf(s[4 * j + 3], scale_log2, -ms1));
        sum0 += s[4 * j] + s[4 * j + 1];
        sum1 += s[4 * j + 2] + s[4 * j + 3];
      }
      l0 = l0 * c0 + sum0;
      l1 = l1 * c1 + sum1;
    };
    // P (fp32, in s) -> bf16 A fragments: n8-block j is half j % 2 of k-step j / 2
    auto pack_p = [&]() {
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        pa[j / 2][(j & 1) * 2] = mofa::pack_bf16(s[4 * j], s[4 * j + 1]);
        pa[j / 2][(j & 1) * 2 + 1] = mofa::pack_bf16(s[4 * j + 2], s[4 * j + 3]);
      }
    };
    auto rescale_o = [&](float c0, float c1) {
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        o[4 * j] *= c0;
        o[4 * j + 1] *= c0;
        o[4 * j + 2] *= c1;
        o[4 * j + 3] *= c1;
      }
    };
    auto fence_o = [&]() {
#pragma unroll
      for (int n = 0; n < D / 2; ++n) mofa::fence_operand(o[n]);
    };
    auto release = [&](int i) {               // tile i's stage may be refilled
      __syncwarp();
      if (lane == 0) mofa::mbar_arrive(empty(stage(i)));
    };

    if (wg == NCW - 1) mofa::named_bar_arrive(1, 256);   // warpgroup 0 goes first
    mofa::mbar_wait(bar_q, 0);
    float c0, c1;
    mofa::mbar_wait(k_full(0), 0);
    my_turn();
    mofa::wgmma_fence();
    issue_s(0);
    next_turn();
    mofa::wgmma_wait<0>();
    softmax(0, c0, c1);                     // O is still 0: no correction
    pack_p();
    for (int i = 1; i < ntiles; ++i) {
      mofa::mbar_wait(k_full(stage(i)), parity(i));
      mofa::mbar_wait(v_full(stage(i - 1)), parity(i - 1));
      fence_o();
      my_turn();
      mofa::wgmma_fence();
      issue_s(i);
      issue_pv(i - 1);
      next_turn();
      mofa::wgmma_wait<1>();                // S of tile i is in
      softmax(i, c0, c1);                   // while P V of tile i - 1 runs
      mofa::wgmma_wait<0>();
      // the product read pa and wrote o asynchronously: both stay in
      // their registers, untouched, until here
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r) mofa::fence_operand(pa[kk][r]);
      fence_o();
      release(i - 1);
      pack_p();
      rescale_o(c0, c1);
    }
    mofa::mbar_wait(v_full(stage(ntiles - 1)), parity(ntiles - 1));
    my_turn();
    mofa::wgmma_fence();
    issue_pv(ntiles - 1);
    next_turn();
    mofa::wgmma_wait<0>();
    fence_o();
    release(ntiles - 1);
    if (wg == 0) mofa::named_bar_sync(1, 256);   // absorb the turn left in flight

    // finish the row sums across the 4 threads of each row, normalise, store
    l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
    l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
    const float inv0 = 1.0f / l0, inv1 = 1.0f / l1;
    const long long ld = (long long)H * D;
    bf16* ob = out + (long long)b * Lq * ld + (long long)h * D;
    const int row0 = q0 + wg * 64 + warp * 16 + (lane >> 2), row1 = row0 + 8;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int col = j * 8 + 2 * t;
      if (row0 < Lq)
        *reinterpret_cast<__nv_bfloat162*>(ob + (long long)row0 * ld + col) =
            __floats2bfloat162_rn(o[4 * j] * inv0, o[4 * j + 1] * inv0);
      if (row1 < Lq)
        *reinterpret_cast<__nv_bfloat162*>(ob + (long long)row1 * ld + col) =
            __floats2bfloat162_rn(o[4 * j + 2] * inv1, o[4 * j + 3] * inv1);
    }
  }
}

// ---- the fp32 route: split-TF32 products on wgmma

// Per head width: NCW consumer warpgroups of 64 query rows, key tiles of BN
// and STAGES ring stages, sized so that Q's two planes and the ring fit in
// shared memory (192 KB either way: at D = 64, 2 x 32 KB of Q and two
// 64 KB stages; at D = 128, 2 x 32 KB of Q for one warpgroup and two 64 KB
// stages of 32 keys).
template <int D> struct F32Shape;
template <> struct F32Shape<64> { static constexpr int NCW = 2, BN = 64, STAGES = 2; };
template <> struct F32Shape<128> { static constexpr int NCW = 1, BN = 32, STAGES = 2; };
// the Vt planes' key axis is padded with zeros to a multiple of KEY_PAD,
// which both key tiles divide (kernels/flash_attention.py sizes the scratch)
constexpr int KEY_PAD = 64;

template <int D>
struct F32Cfg : F32Shape<D> {
  using S = F32Shape<D>;
  static constexpr int BM = 64 * S::NCW;
  static constexpr int NTHREADS = 128 * (S::NCW + 1);
  static constexpr int Q_PLANE = BM * D * 4;                // one plane's Q tile
  static constexpr int KV_PLANE = S::BN * D * 4;            // one plane's K or Vt tile
  static constexpr int STAGE_BYTES = 4 * KV_PLANE;          // K big, K small, Vt big, Vt small
  static constexpr int SMEM = 2 * Q_PLANE + S::STAGES * STAGE_BYTES + 1024;  // + alignment
  static_assert(SMEM <= 232448, "fits a block's shared memory");
};

template <int N>
__device__ __forceinline__ void wgmma_s_tf32(float* d, uint64_t da, uint64_t db, int acc) {
  if constexpr (N == 32) mofa::wgmma_m64n32k8_tf32_ss(d, da, db, acc);
  else mofa::wgmma_m64n64k8_tf32_ss(d, da, db, acc);
}
template <int N>
__device__ __forceinline__ void wgmma_pv_tf32(float* d, const uint32_t* a, uint64_t db, int acc) {
  if constexpr (N == 64) mofa::wgmma_m64n64k8_tf32_rs(d, a, db, acc);
  else mofa::wgmma_m64n128k8_tf32_rs(d, a, db, acc);
}

// q, k: [B, L, H, D] -> big and small planes in the same layout
__global__ void split_planes_kernel(const float4* __restrict__ x, float4* __restrict__ big,
                                    float4* __restrict__ small, long long n4) {
  mofa::split_tf32_planes(x, big, small, n4);
}

// v [B, L, H, D] -> Vt big and small planes [B * H, D, Lp] (keys innermost,
// zero past L): the K-major B operand of O += P V. Within each group of 8
// keys, position p holds key 2p (p < 4) or key 2(p - 4) + 1: the order in
// which a thread's P fragment (its columns 2t, 2t + 1 of each 8) serves as
// the A operand's columns t and t + 4. A block transposes 32 keys x 32 d.
__global__ void __launch_bounds__(256) split_vt_kernel(const float* __restrict__ v,
                                                       float* __restrict__ big,
                                                       float* __restrict__ small, int L, int H,
                                                       int D, int Lp) {
  __shared__ float tile[32][33];
  const int bh = blockIdx.z, b = bh / H, h = bh % H;
  const int k0 = blockIdx.x * 32, d0 = blockIdx.y * 32;
  const int tx = threadIdx.x, ty = threadIdx.y;
  for (int r = ty; r < 32; r += 8) {
    const int key = k0 + r;
    tile[r][tx] = key < L ? v[(((long long)b * L + key) * H + h) * D + d0 + tx] : 0.0f;
  }
  __syncthreads();
  const int p8 = tx & 7;
  const int key = (tx & ~7) + (p8 < 4 ? 2 * p8 : 2 * (p8 - 4) + 1);
  for (int r = ty; r < 32; r += 8) {
    const long long o = ((long long)bh * D + d0 + r) * Lp + k0 + tx;
    float bg, sm;
    mofa::split_tf32(tile[key][r], bg, sm);
    big[o] = bg;
    small[o] = sm;
  }
}

template <int D>
__global__ void __launch_bounds__(F32Cfg<D>::NTHREADS, 1) flash_f32_kernel(
    const __grid_constant__ CUtensorMap tqb, const __grid_constant__ CUtensorMap tqs,
    const __grid_constant__ CUtensorMap tkb, const __grid_constant__ CUtensorMap tks,
    const __grid_constant__ CUtensorMap tvb, const __grid_constant__ CUtensorMap tvs,
    float* __restrict__ out, int Lq, int Lk, int H, float scale_log2) {
  using C = F32Cfg<D>;
  constexpr int BM = C::BM, BN = C::BN, NCW = C::NCW, STAGES = C::STAGES;
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t bars[1 + 2 * STAGES];
  // swizzled tiles start on 1024-byte boundaries (the 8-row swizzle atom):
  // Q big, Q small, then the stages [K big | K small | Vt big | Vt small]
  const uint32_t sQ = (mofa::smem_addr(smem_raw) + 1023) & ~1023u;
  const uint32_t sR = sQ + 2 * C::Q_PLANE;
  const uint32_t bar_q = mofa::smem_addr(&bars[0]);
  auto full = [&](int s) { return mofa::smem_addr(&bars[1 + s]); };
  auto empty = [&](int s) { return mofa::smem_addr(&bars[1 + STAGES + s]); };

  const int tid = threadIdx.x, wg = tid / 128;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int q0 = blockIdx.x * BM;
  const int ntiles = (Lk + BN - 1) / BN;

  if (tid == 0) {
    mofa::mbar_init(bar_q, 1);
    for (int s = 0; s < STAGES; ++s) {
      mofa::mbar_init(full(s), 1);
      mofa::mbar_init(empty(s), 4 * NCW);       // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == NCW) {
    // ---- producer: one thread issues every copy
    if constexpr (NCW > 1) mofa::setmaxnreg_dec<24>();
    if (tid == NCW * 128) {
      mofa::mbar_arrive_expect_tx(bar_q, 2 * C::Q_PLANE);
#pragma unroll
      for (int c = 0; c < D / 32; ++c) {
        mofa::tma_load_4d(sQ + c * BM * 128, &tqb, bar_q, c * 32, h, q0, b);
        mofa::tma_load_4d(sQ + C::Q_PLANE + c * BM * 128, &tqs, bar_q, c * 32, h, q0, b);
      }
      for (int i = 0; i < ntiles; ++i) {
        const int s = i % STAGES, round = i / STAGES;
        if (round > 0) mofa::mbar_wait(empty(s), (round - 1) & 1);
        const uint32_t st = sR + s * C::STAGE_BYTES;
        mofa::mbar_arrive_expect_tx(full(s), C::STAGE_BYTES);
#pragma unroll
        for (int c = 0; c < D / 32; ++c) {
          mofa::tma_load_4d(st + c * BN * 128, &tkb, full(s), c * 32, h, i * BN, b);
          mofa::tma_load_4d(st + C::KV_PLANE + c * BN * 128, &tks, full(s), c * 32, h, i * BN, b);
        }
#pragma unroll
        for (int c = 0; c < BN / 32; ++c) {
          mofa::tma_load_3d(st + 2 * C::KV_PLANE + c * D * 128, &tvb, full(s), i * BN + c * 32,
                            0, bh);
          mofa::tma_load_3d(st + 3 * C::KV_PLANE + c * D * 128, &tvs, full(s), i * BN + c * 32,
                            0, bh);
        }
      }
    }
  } else {
    // ---- consumers: 64 query rows per warpgroup, a tile at a time
    if constexpr (NCW > 1) mofa::setmaxnreg_inc<240>();
    const int warp = (tid % 128) / 32, lane = tid % 32, t = lane & 3;
    float o[D / 2];                           // O, 64 x D
    float ot[D / 2];                          // P V of the tile, 64 x D
    float s[BN / 2];                          // S, then P (fp32), 64 x BN
    uint32_t pb[BN / 8][4], ps[BN / 8][4];    // P's big and small A fragments
#pragma unroll
    for (int n = 0; n < D / 2; ++n) o[n] = ot[n] = 0.0f;
#pragma unroll
    for (int n = 0; n < BN / 2; ++n) s[n] = 0.0f;   // overwritten (scale-d 0)
    float m0 = -INFINITY, m1 = -INFINITY;     // running max of rows r, r + 8
    float l0 = 0.0f, l1 = 0.0f;               // running sums (this thread's part)
    const uint32_t qa = sQ + wg * 64 * 128;
    mofa::mbar_wait(bar_q, 0);
    for (int i = 0; i < ntiles; ++i) {
      const int stg = i % STAGES;
      const uint32_t st = sR + stg * C::STAGE_BYTES;
      mofa::mbar_wait(full(stg), (i / STAGES) & 1);
      // S = Q K^T: per k8 step (32 bytes of a 128-byte row; D / 32 boxes)
      // small * big + big * small + big * big
#pragma unroll
      for (int n = 0; n < BN / 2; ++n) mofa::fence_operand(s[n]);
      mofa::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 8; ++kk) {
        const uint32_t qo = qa + (kk / 4) * BM * 128 + (kk % 4) * 32;
        const uint32_t ko = st + (kk / 4) * BN * 128 + (kk % 4) * 32;
        const uint64_t qb = mofa::gmma_desc_sw128(qo, 16, 1024);
        const uint64_t qs = mofa::gmma_desc_sw128(qo + C::Q_PLANE, 16, 1024);
        const uint64_t kb = mofa::gmma_desc_sw128(ko, 16, 1024);
        const uint64_t ks = mofa::gmma_desc_sw128(ko + C::KV_PLANE, 16, 1024);
        wgmma_s_tf32<BN>(s, qs, kb, kk > 0);
        wgmma_s_tf32<BN>(s, qb, ks, 1);
        wgmma_s_tf32<BN>(s, qb, kb, 1);
      }
      mofa::wgmma_commit();
      mofa::wgmma_wait<0>();
#pragma unroll
      for (int n = 0; n < BN / 2; ++n) mofa::fence_operand(s[n]);

      // the exact online softmax in base 2 on the fragments (n8 block j:
      // s[4j + e] at row r + 8 (e / 2), key 8j + 2t + e % 2)
      if ((i + 1) * BN > Lk) {
        const int kbase = i * BN + 2 * t;
#pragma unroll
        for (int n = 0; n < BN / 2; ++n)
          if (kbase + (n / 4) * 8 + (n & 1) >= Lk) s[n] = -INFINITY;
      }
      float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        mx0 = fmaxf(mx0, fmaxf(s[4 * j], s[4 * j + 1]));
        mx1 = fmaxf(mx1, fmaxf(s[4 * j + 2], s[4 * j + 3]));
      }
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
      const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
      const float c0 = mofa::ex2((m0 - mn0) * scale_log2);
      const float c1 = mofa::ex2((m1 - mn1) * scale_log2);
      m0 = mn0;
      m1 = mn1;
      const float ms0 = mn0 * scale_log2, ms1 = mn1 * scale_log2;
      float sum0 = 0.0f, sum1 = 0.0f;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        s[4 * j] = mofa::ex2(fmaf(s[4 * j], scale_log2, -ms0));
        s[4 * j + 1] = mofa::ex2(fmaf(s[4 * j + 1], scale_log2, -ms0));
        s[4 * j + 2] = mofa::ex2(fmaf(s[4 * j + 2], scale_log2, -ms1));
        s[4 * j + 3] = mofa::ex2(fmaf(s[4 * j + 3], scale_log2, -ms1));
        sum0 += s[4 * j] + s[4 * j + 1];
        sum1 += s[4 * j + 2] + s[4 * j + 3];
      }
      l0 = l0 * c0 + sum0;
      l1 = l1 * c1 + sum1;
      // P as the A operand of k8 step j: columns t and t + 4 take this
      // thread's keys 2t and 2t + 1 (the Vt planes hold the keys in that order)
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        mofa::split_tf32(s[4 * j], pb[j][0], ps[j][0]);
        mofa::split_tf32(s[4 * j + 2], pb[j][1], ps[j][1]);
        mofa::split_tf32(s[4 * j + 1], pb[j][2], ps[j][2]);
        mofa::split_tf32(s[4 * j + 3], pb[j][3], ps[j][3]);
      }

      // the tile's P V: per k8 step (8 keys), small * big + big * small +
      // big * big into a fresh accumulator, then O = c O + P V in fp32
      // adds (the tensor cores' fp32 accumulation truncates each product
      // group's sum: summing a whole row of keys there loses about one
      // bit per 30 of the 3 L / 8 groups)
#pragma unroll
      for (int n = 0; n < D / 2; ++n) mofa::fence_operand(ot[n]);
      mofa::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BN / 8; ++kk) {
        const uint32_t vo = st + 2 * C::KV_PLANE + (kk / 4) * D * 128 + (kk % 4) * 32;
        const uint64_t vb = mofa::gmma_desc_sw128(vo, 16, 1024);
        const uint64_t vs = mofa::gmma_desc_sw128(vo + C::KV_PLANE, 16, 1024);
        wgmma_pv_tf32<D>(ot, ps[kk], vb, kk > 0);
        wgmma_pv_tf32<D>(ot, pb[kk], vs, 1);
        wgmma_pv_tf32<D>(ot, pb[kk], vb, 1);
      }
      mofa::wgmma_commit();
      mofa::wgmma_wait<0>();
      // the products read pb / ps and wrote ot asynchronously: both stay in
      // their registers, untouched, until here
#pragma unroll
      for (int kk = 0; kk < BN / 8; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          mofa::fence_operand(pb[kk][r]);
          mofa::fence_operand(ps[kk][r]);
        }
#pragma unroll
      for (int n = 0; n < D / 2; ++n) mofa::fence_operand(ot[n]);
      __syncwarp();
      if (lane == 0) mofa::mbar_arrive(empty(stg));   // the stage may be refilled
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        o[4 * j] = fmaf(o[4 * j], c0, ot[4 * j]);
        o[4 * j + 1] = fmaf(o[4 * j + 1], c0, ot[4 * j + 1]);
        o[4 * j + 2] = fmaf(o[4 * j + 2], c1, ot[4 * j + 2]);
        o[4 * j + 3] = fmaf(o[4 * j + 3], c1, ot[4 * j + 3]);
      }
    }

    // finish the row sums across the 4 threads of each row, normalise, store
    l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
    l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
    const float inv0 = 1.0f / l0, inv1 = 1.0f / l1;
    const long long ld = (long long)H * D;
    float* ob = out + (long long)b * Lq * ld + (long long)h * D;
    const int row0 = q0 + wg * 64 + warp * 16 + (lane >> 2), row1 = row0 + 8;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int col = j * 8 + 2 * t;
      if (row0 < Lq)
        *reinterpret_cast<float2*>(ob + (long long)row0 * ld + col) =
            make_float2(o[4 * j] * inv0, o[4 * j + 1] * inv0);
      if (row1 < Lq)
        *reinterpret_cast<float2*>(ob + (long long)row1 * ld + col) =
            make_float2(o[4 * j + 2] * inv1, o[4 * j + 3] * inv1);
    }
  }
}

// ---- host: tensor maps and launches

// [B, L, H, D] bf16 (fp32) as a 4-D map (innermost first: d, head, row,
// batch) whose box is 64 (32) d x 1 head x `rows` rows x 1 batch: 128
// bytes a row, 128-byte swizzled; rows past L are zero-filled
bool rows_map(CUtensorMap* map, const void* base, int B, int L, int H, int D, int rows,
              bool f32 = false) {
  const mofa::EncodeTiledFn encode = mofa::encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t es = f32 ? 4 : 2;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)H, (cuuint64_t)L, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)D * es, (cuuint64_t)H * D * es,
                                 (cuuint64_t)L * H * D * es};
  const cuuint32_t box[4] = {(cuuint32_t)(128 / es), 1, (cuuint32_t)rows, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode(map, f32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                4, const_cast<void*>(base), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// a Vt plane [B * H, D, Lp] fp32 as a 3-D map whose box is 32 keys (128
// bytes, 128-byte swizzled) x D rows x 1
bool vt_map(CUtensorMap* map, const void* base, int BH, int D, int Lp) {
  const mofa::EncodeTiledFn encode = mofa::encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)Lp, (cuuint64_t)D, (cuuint64_t)BH};
  const cuuint64_t strides[2] = {(cuuint64_t)Lp * 4, (cuuint64_t)D * Lp * 4};
  const cuuint32_t box[3] = {32, (cuuint32_t)D, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<void*>(base), dims,
                strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D, int NCW>
int launch_bf16(const void* q, const void* k, const void* v, void* out, int B, int Lq,
                int Lk, int H, cudaStream_t st) {
  using C = FlashCfg<D, NCW>;
  CUtensorMap tq, tk, tv;
  if (!rows_map(&tq, q, B, Lq, H, D, C::BM) || !rows_map(&tk, k, B, Lk, H, D, BN) ||
      !rows_map(&tv, v, B, Lk, H, D, BN))
    return (int)cudaErrorNotSupported;
  auto kernel = flash_bf16_kernel<D, NCW>;
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  const dim3 grid((Lq + C::BM - 1) / C::BM, B * H);
  const float scale_log2 = 1.4426950408889634f / sqrtf((float)D);
  kernel<<<grid, C::NTHREADS, C::SMEM, st>>>(tq, tk, tv, (bf16*)out, Lq, Lk, H, scale_log2);
  return (int)cudaGetLastError();
}

// the split pass (q, k into big / small planes; v into the Vt planes),
// then the flash kernel on the planes; scratch: 2 B Lq H D + 2 B Lk H D +
// 2 B H D Lp floats, Lp = Lk rounded up to KEY_PAD
template <int D>
int launch_f32(const void* q, const void* k, const void* v, void* out, void* scratch, int B,
               int Lq, int Lk, int H, cudaStream_t st) {
  using C = F32Cfg<D>;
  const int Lp = (Lk + KEY_PAD - 1) / KEY_PAD * KEY_PAD;
  const long long nq = (long long)B * Lq * H * D, nk = (long long)B * Lk * H * D;
  const long long nv = (long long)B * H * D * Lp;
  float* qb = static_cast<float*>(scratch);
  float* qs = qb + nq;
  float* kb = qs + nq;
  float* ks = kb + nk;
  float* vb = ks + nk;
  float* vs = vb + nv;
  auto blocks = [](long long n4) { return (unsigned)std::min<long long>((n4 + 255) / 256, 8192); };
  split_planes_kernel<<<blocks(nq / 4), 256, 0, st>>>(
      (const float4*)q, (float4*)qb, (float4*)qs, nq / 4);
  split_planes_kernel<<<blocks(nk / 4), 256, 0, st>>>(
      (const float4*)k, (float4*)kb, (float4*)ks, nk / 4);
  split_vt_kernel<<<dim3(Lp / 32, D / 32, B * H), dim3(32, 8), 0, st>>>(
      (const float*)v, vb, vs, Lk, H, D, Lp);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  CUtensorMap tqb, tqs, tkb, tks, tvb, tvs;
  if (!rows_map(&tqb, qb, B, Lq, H, D, C::BM, true) ||
      !rows_map(&tqs, qs, B, Lq, H, D, C::BM, true) ||
      !rows_map(&tkb, kb, B, Lk, H, D, C::BN, true) ||
      !rows_map(&tks, ks, B, Lk, H, D, C::BN, true) || !vt_map(&tvb, vb, B * H, D, Lp) ||
      !vt_map(&tvs, vs, B * H, D, Lp))
    return (int)cudaErrorNotSupported;
  auto kernel = flash_f32_kernel<D>;
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  const dim3 grid((Lq + C::BM - 1) / C::BM, B * H);
  const float scale_log2 = 1.4426950408889634f / sqrtf((float)D);
  kernel<<<grid, C::NTHREADS, C::SMEM, st>>>(tqb, tqs, tkb, tks, tvb, tvs, (float*)out, Lq,
                                             Lk, H, scale_log2);
  return (int)cudaGetLastError();
}

}  // namespace

// q [B, Lq, H, D], k/v [B, Lk, H, D], out [B, Lq, H, D], contiguous, 16-byte
// aligned; D in {64, 128}; dtype 0 = fp32, 1 = bf16. fp32 only: scratch of
// 2 B Lq H D + 2 B Lk H D + 2 B H D Lp floats, 16-byte aligned, Lp = Lk
// rounded up to a multiple of 64 (null for bf16).
extern "C" int mofa_flash_attention(const void* q, const void* k, const void* v,
                                    void* out, void* scratch, int B, int Lq, int Lk, int H,
                                    int D, int dtype, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (B * H == 0 || Lq == 0) return (int)cudaGetLastError();
  if (Lk < 1) return (int)cudaErrorInvalidValue;
  if (dtype == mofa::kBF16) {
    if (D == 64) return launch_bf16<64, 3>(q, k, v, out, B, Lq, Lk, H, st);
    if (D == 128) return launch_bf16<128, 2>(q, k, v, out, B, Lq, Lk, H, st);
  } else if (dtype == mofa::kF32 && scratch != nullptr) {
    if (D == 64) return launch_f32<64>(q, k, v, out, scratch, B, Lq, Lk, H, st);
    if (D == 128) return launch_f32<128>(q, k, v, out, scratch, B, Lq, Lk, H, st);
  }
  return (int)cudaErrorInvalidValue;
}
