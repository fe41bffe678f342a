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
// fp32 path (composition checks, tests): one thread per query row with q
// and the accumulator in registers, K/V tiles broadcast from shared memory.
// Plain FMA, exact fp32; not meant to be fast.
#include <cuda.h>

#include "common.cuh"

using bf16 = __nv_bfloat16;

namespace {

// ---- wgmma instructions (sm_90a), accumulator fragment of thread (warp w,
// lane l) for n8-block j: d[4j + e] at row 16w + l/4 + 8(e/2), column
// 8j + 2(l%4) + e%2; the register A operand has mma.sync's A layout.
// D[64 x 128] (+)= A[64 x 16] * B[16 x 128]: A and B K-major in shared memory
__device__ __forceinline__ void wgmma_m64n128k16_ss(float* d, uint64_t da, uint64_t db,
                                                    int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// D[64 x 64] += A[64 x 16] * B[16 x 64]: A in registers, B MN-major in shared memory
__device__ __forceinline__ void wgmma_m64n64k16_rs(float* d, const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D[64 x 128] += A[64 x 16] * B[16 x 128]: A in registers, B MN-major in shared memory
__device__ __forceinline__ void wgmma_m64n128k16_rs(float* d, const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

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
        wgmma_m64n128k16_ss(s, mofa::gmma_desc_sw128(qa + off, 16, 1024),
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
        if constexpr (D == 64) wgmma_m64n64k16_rs(o, pa[kk], dv);
        else wgmma_m64n128k16_rs(o, pa[kk], dv);
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

constexpr int F32_BQ = 64, F32_BK = 32;

template <int D>
__global__ void __launch_bounds__(F32_BQ) flash_f32_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    float* __restrict__ out, int Lq, int Lk, int H, float scale) {
  __shared__ float Ks[F32_BK][D];
  __shared__ float Vs[F32_BK][D];
  const int tid = threadIdx.x;
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int row = blockIdx.x * F32_BQ + tid;
  const long long ld = (long long)H * D;
  const float* kb = k + (long long)b * Lk * ld + (long long)h * D;
  const float* vb = v + (long long)b * Lk * ld + (long long)h * D;

  float qr[D], acc[D];
  const float* qrow = q + ((long long)b * Lq + (row < Lq ? row : 0)) * ld + (long long)h * D;
#pragma unroll
  for (int d = 0; d < D; ++d) { qr[d] = qrow[d] * scale; acc[d] = 0.0f; }
  float m = -INFINITY, l = 0.0f;

  for (int k0 = 0; k0 < Lk; k0 += F32_BK) {
    for (int i = tid; i < F32_BK * D; i += F32_BQ) {
      const int r = i / D, d = i % D;
      const bool ok = k0 + r < Lk;
      Ks[r][d] = ok ? kb[(long long)(k0 + r) * ld + d] : 0.0f;
      Vs[r][d] = ok ? vb[(long long)(k0 + r) * ld + d] : 0.0f;
    }
    __syncthreads();
    const int nk = min(F32_BK, Lk - k0);
    for (int j = 0; j < nk; ++j) {
      float s = 0.0f;
#pragma unroll
      for (int d = 0; d < D; ++d) s = fmaf(qr[d], Ks[j][d], s);
      const float m_new = fmaxf(m, s);
      const float corr = expf(m - m_new);
      const float p = expf(s - m_new);
      l = l * corr + p;
#pragma unroll
      for (int d = 0; d < D; ++d) acc[d] = fmaf(acc[d], corr, p * Vs[j][d]);
      m = m_new;
    }
    __syncthreads();
  }
  if (row < Lq) {
    float* orow = out + ((long long)b * Lq + row) * ld + (long long)h * D;
#pragma unroll
    for (int d = 0; d < D; ++d) orow[d] = acc[d] / l;
  }
}

// ---- host: tensor maps and launches

// cuTensorMapEncodeTiled is a driver symbol; the library links only the
// runtime, so it is fetched once through the runtime's entry-point query
using EncodeTiledFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                   const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                   const cuuint32_t*, CUtensorMapInterleave,
                                   CUtensorMapSwizzle, CUtensorMapL2promotion,
                                   CUtensorMapFloatOOBfill);

EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault,
                                     &found);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (found == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// [B, L, H, D] bf16 as a 4-D map (innermost first: d, head, row, batch) whose
// box is 64 d x 1 head x `rows` rows x 1 batch, 128-byte swizzled; rows past
// L are zero-filled
bool rows_map(CUtensorMap* map, const void* base, int B, int L, int H, int D, int rows) {
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)H, (cuuint64_t)L, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)D * 2, (cuuint64_t)H * D * 2,
                                 (cuuint64_t)L * H * D * 2};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)rows, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims,
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

template <int D>
int launch_f32(const void* q, const void* k, const void* v, void* out, int B, int Lq,
               int Lk, int H, cudaStream_t st) {
  const dim3 grid((Lq + F32_BQ - 1) / F32_BQ, B * H);
  flash_f32_kernel<D><<<grid, F32_BQ, 0, st>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)out, Lq, Lk, H,
      1.0f / sqrtf((float)D));
  return (int)cudaGetLastError();
}

}  // namespace

// q [B, Lq, H, D], k/v [B, Lk, H, D], out [B, Lq, H, D], contiguous, 16-byte
// aligned; D in {64, 128}; dtype 0 = fp32, 1 = bf16.
extern "C" int mofa_flash_attention(const void* q, const void* k, const void* v,
                                    void* out, int B, int Lq, int Lk, int H, int D,
                                    int dtype, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (B * H == 0 || Lq == 0) return (int)cudaGetLastError();
  if (Lk < 1) return (int)cudaErrorInvalidValue;
  if (dtype == mofa::kBF16) {
    if (D == 64) return launch_bf16<64, 3>(q, k, v, out, B, Lq, Lk, H, st);
    if (D == 128) return launch_bf16<128, 2>(q, k, v, out, B, Lq, Lk, H, st);
  } else if (dtype == mofa::kF32) {
    if (D == 64) return launch_f32<64>(q, k, v, out, B, Lq, Lk, H, st);
    if (D == 128) return launch_f32<128>(q, k, v, out, B, Lq, Lk, H, st);
  }
  return (int)cudaErrorInvalidValue;
}
