// The GEGLU feed-forward family, C -> 8C -> 4C -> C (torch Linear layouts:
// W0 [8C, C], W2 [C, 4C]):
//   ln_geglu_ffn:  out = x + (a * gelu_erf(g)) W2^T + b2,  [a | g] = LN(x) W0^T + b0
//   geglu_ffn:     out =     (a * gelu_erf(g)) W2^T + b2,  [a | g] =    x  W0^T + b0
//
// Replaces mofa_tpu/kernels/geglu_ffn.py: `_ln_ffn_kernel` (:390; variant
// "plain", and "tanh" with the tanh-form gelu), `_ln_ffn_kernel_ilv`
// (:344, "ilv"), `_ln_ffn_kernel_pipe` (:363, "pipe") and `_ffn_kernel`
// (:93, `geglu_ffn`): one route of three stages, the gate GEMM in one of
// three schedules. The TPU kernels hold both weight matrices and the
// whole [rows, 8C] intermediate in VMEM; a Hopper block has 227 KB of
// shared memory, and W0 alone is 6.5 MB at C=640.
//
// bf16 plain / tanh / geglu_ffn (the main path): three kernels in turn.
// Bound: operations, 24 M C^2 (two products of 2 M C 8C and 2 M 4C C),
// 1.145 ms at both main-path shapes (M = 460,800 at C = 320, 115,200 at
// C = 640) against 989 TFLOP/s.
// - `ffn_ln_rows`: xn = LN(x) as bf16, one warp per row, 16-byte loads
//   (skipped by geglu_ffn: the gate GEMM reads x itself).
// - `ffn_gemm_gate`: h = gate(xn W0^T + b0), [M, 4C] bf16. A block tile is
//   128 rows (two consumer warpgroups of 64) x 128 gate columns; a
//   producer warpgroup (its registers handed to the consumers with
//   `setmaxnreg`) issues the TMA copies into a ring of four shared-memory
//   stages, each holding a k-tile of 64: the xn rows, W0 rows
//   [n0, n0 + 128) (a) and W0 rows [4C + n0, 4C + n0 + 128) (g), all three
//   boxes 128-byte swizzled. The a and g boxes lie back to back, so one
//   `wgmma.m64n256k16` per k16 makes both halves, and a_j and g_j land in
//   the same thread at accumulator offsets j and 64 + j: the epilogue adds
//   b0, applies the gate in fp32 (erf as the TPU kernel's own
//   Abramowitz-Stegun polynomial, or tanhf for "tanh") and stores bf16
//   pairs, masking rows past M.
// - `ffn_gemm_out`: out = h W2^T + b2 (+ x), the same mainloop with h as
//   the A operand and W2 rows as B, a tile of 128 rows x 160 output columns
//   (one `wgmma.m64n160k16` per k16, B as two 80-row boxes) and five ring
//   stages; the epilogue stages 32 columns at a time in fp32 through
//   shared memory and writes rows of 4-column pieces with the residual
//   added, rounded once.
// Both GEMMs are persistent (one block per SM walks the tiles, N
// fastest, so a row tile's A operand is re-read from L2, not HBM, and the
// weights stay resident in L2); the producer runs ahead into the next
// tile's k-tiles while the consumers run the epilogue, whose bias (and
// residual) loads are issued before the tile's products. TMA zero-fills
// the rows past M. The rounding points are the TPU kernel's: LN rounded to
// bf16, fp32 accumulation plus bias, the gate in fp32 rounded to bf16,
// fp32 accumulation plus bias plus residual rounded once. So h in device
// memory changes no result; its round trip costs 2 M 4C 2 bytes each way,
// 2.36 GB at C = 320 (0.70 ms at 3.35 TB/s) and half that at C = 640.
// Why not one fused kernel: a `wgmma` warpgroup owns 64 rows, and holding
// the fused kernel's whole [64, C] fp32 output accumulator takes 64 C / 128
// registers a thread, 320 at C = 640, over the 255 limit; splitting the
// output columns across warpgroups that share each gate chunk through
// shared memory would need a schedule of its own. The fused `mma.sync`
// designs this route replaced, for plain and then for ilv and pipe, read
// all of W0 and W2 from L2 for every 64 rows and lost to the stock cuBLAS
// chain at both widths.
//
// ilv / pipe (entry points only): the same three stages and rounding
// points (the TPU schedules compute plain's function), with a gate GEMM of
// their own. Both TPU schedules overlap the gate's vector work (the erf
// polynomial) with the matrix unit; on this card the gate is the gate
// GEMM's epilogue, which in plain's kernel runs after its tile's products.
// Both keep plain's persistent grid, producer warpgroup (`setmaxnreg`),
// 128-byte swizzle and bias pairs loaded before the products.
// - pipe (`ffn_gate_pipe_kernel`, the TPU's next block's first GEMM issued
//   before this block's gate): a software pipeline inside each consumer
//   warpgroup. A tile is 128 rows (64 a warpgroup) x 64 gate columns, one
//   `wgmma.m64n128k16` per k16 over B = W0's a rows and g rows, 64
//   accumulators a thread, so two accumulator sets fit. A warpgroup issues
//   tile j + 1's k-tiles into one set (one commit group each) and runs
//   tile j's epilogue from the other in slices between them, so tile j's
//   gate runs while the tensor cores work on j + 1; each stage is released
//   as its group retires (`wgmma.wait_group 1`: a tile has 10 k-tiles at
//   C = 640 and the ring 6 stages of 32 KB, so holding a tile's stages
//   until its epilogue would stall the producer). The tile loop is unrolled
//   by two so that each set's registers are named at compile time (a set
//   indexed at run time, or touched between issue and wait, makes ptxas
//   serialise the wgmma).
// - ilv (`ffn_gate_ilv_kernel`, the TPU's row sub-blocks that never wait
//   on one another): ping-pong consumer warpgroups. Each owns whole tiles
//   of 64 rows x 128 gate columns (plain's `wgmma.m64n256k16`, 128
//   accumulators a thread), the two taking alternate tiles of the block's
//   sequence; the producer loads the tiles' k-tiles in tile order into a
//   ring of four 40 KB stages, each released by its owner's four warps (in
//   both blocks of the cluster, below). The turn to issue products passes
//   in tile order on named barriers (`bar.sync` / `bar.arrive`, one id per
//   warpgroup), and a warpgroup hands it on before its epilogue, so one
//   warpgroup's erf gate runs while the other's products run. A turn is
//   handed on only to a tile that exists, so with an odd tile count the
//   warpgroup left without a last tile is never waited for.
// What was in their way, in the order it was found (PERF.md section 6,
// "PR 8", has what each cause cost on an H100):
// - L2 reads: the smaller tiles read more operand bytes from L2 per
//   product than plain's 128 x 128 (64 and 51 FLOP a byte against 85), so
//   both run in clusters of two blocks that take two row tiles at one n0:
//   each block loads its own xn box and one of the two W0 boxes, multicast
//   to both, and a consumer releases a stage in both blocks (its empty
//   barrier counts the warps of both). That brings both to plain's L2
//   bytes per product. The remote arrival keeps the default .release.cta
//   semantics: a .cluster release waits for the thread's global stores.
// - The stores: plain's 4-byte fragment stores to h, eight rows a warp
//   instruction, cost more than the erf, so each warpgroup stages its gated
//   tile in shared memory (bf16, in TMA's 128-byte swizzle, which spreads a
//   warp's eight rows over all 32 banks) and one thread writes it with a
//   TMA store, which also skips the rows past M (pipe: two staging buffers
//   a warpgroup, the next tile's slices filling one while the other is
//   stored; ilv: one, its tiles being two apart).
// - The erf's instructions: __fdividef and __expf compile to subnormal
//   fix-ups (a compare and conditional multiplies each); `gate_ftz`
//   computes the same values without them. In pipe, ptxas spreads a slice's math
//   between the HGMMAs of the k-tile issued before it, so that work still
//   delays the tensor cores there; ilv's products are issued by a warp
//   that runs no epilogue at the time.
// Bound of either gate GEMM: operations, 2 M C 8C (0.763 ms at M =
// 460,800, C = 320).
// fp32 plain (training: stage 1 and stage 2 run the adapter in fp32;
// composition checks): the bf16 route's three stages on split TF32. The
// plain version computes in full fp32 (TF32 off), and one TF32 product
// keeps about 11 bits, so every GEMM operand is split into big = tf32(x)
// and small = tf32(x - big) and each product is small * big + big * small
// + big * big on `wgmma` (tf32, k8) with fp32 accumulation: about 22 bits.
// Bound: operations, 3 x 24 M C^2 against 495 TFLOP/s dense TF32 (0.86 ms
// at M = 57,600, C = 320 and at M = 14,400, C = 640, the training sites;
// 2.11 ms of fp32 FMA on the CUDA cores). tf32 `wgmma` reads both operands
// K-major, which all four are here (xn, W0, h, W2). The design:
// - `split_planes_kernel`: W0 and W2 into big / small planes once a call
//   (4.9 MB at C = 320);
// - `ffn_ln_split_kernel`: xn = LN(x) in fp32, written as its two planes;
// - `ffn_gemm_f32_kernel<C, true>`: h = (a + b0) * gelu_erf(g + b0') from
//   three products a k8 step over the planes in shared memory, a tile of
//   128 rows x 64 gate columns (W0's a and g boxes back to back: one
//   m64n128k8 a product), h stored as its two planes;
// - `ffn_gemm_f32_kernel<C, false>`: out = h W2^T + b2 + x, a tile of 128
//   rows x 160 columns (m64n160k8).
// Both GEMMs keep the bf16 GEMM's shape (persistent, a TMA producer
// warpgroup, two consumer warpgroups, a ring of three stages of k = 32:
// each stage carries A's and B's two planes, 64 / 72 KB). A consumer
// takes a k-tile's 12 products into a fresh accumulator and adds it to
// the tile's sum in fp32: the tensor cores' accumulation truncates. The
// A operands' planes go through device memory (xn and h twice, 2.2 GB at
// 57,600 x 320, about 0.4 ms at 3.35 TB/s beside the 0.86 ms of
// products): both operands of a shared-memory `wgmma` are read as they
// lie, so each is split where it is written. The gate is the plain
// version's gelu, fp32 erf.
#include <algorithm>

#include "hopper.cuh"

using bf16 = __nv_bfloat16;

namespace {

constexpr float LN_EPS = 1e-5f;

__device__ __forceinline__ float gelu_erf(float g) {
  return 0.5f * g * (1.0f + erff(g * 0.70710678118654752f));
}
// the tanh form (variant "tanh") with tanhf, not tanh.approx: the form
// itself already sits ~3e-2 from erf after GEMM2 (geglu_ffn.py:176-184)
__device__ __forceinline__ float gelu_tanh(float g) {
  return 0.5f * g * (1.0f + tanhf(0.7978845608028654f * (g + 0.044715f * g * g * g)));
}
// erf as Abramowitz-Stegun 7.1.26 (max abs error 1.5e-7), the TPU
// kernel's own formula: one reciprocal, five FMAs and one exp2
__device__ __forceinline__ float gelu_erf_as(float g) {
  const float xs = g * 0.70710678118654752f, ax = fabsf(xs);
  const float t = __fdividef(1.0f, fmaf(0.3275911f, ax, 1.0f));
  const float poly =
      t * fmaf(t, fmaf(t, fmaf(t, fmaf(t, 1.061405429f, -1.453152027f), 1.421413741f),
                       -0.284496736f),
               0.254829592f);
  const float erf = copysignf(1.0f - poly * __expf(-ax * ax), xs);
  return 0.5f * g * (1.0f + erf);
}
// gelu_erf_as with the reciprocal and exp2 approximations that flush
// subnormals: the same values (the denominator is >= 1, and where the exp
// would be subnormal the erf is already +-1) without the subnormal fix-ups
// that __fdividef and __expf compile to; the ilv and pipe schedules'
// epilogue, which runs beside the tensor cores
__device__ __forceinline__ float gate_ftz(float a, float g) {
  const float xs = g * 0.70710678118654752f, ax = fabsf(xs);
  const float t = mofa::rcp_ftz(fmaf(0.3275911f, ax, 1.0f));
  const float poly =
      t * fmaf(t, fmaf(t, fmaf(t, fmaf(t, 1.061405429f, -1.453152027f), 1.421413741f),
                       -0.284496736f),
               0.254829592f);
  const float erf = copysignf(1.0f - poly * mofa::ex2(-ax * ax * 1.4426950408889634f), xs);
  return a * (0.5f * g * (1.0f + erf));
}
// the gate of the gate GEMM's epilogue: GELU 0 = erf (Abramowitz-Stegun),
// 1 = the tanh form
template <int GELU>
__device__ __forceinline__ float gate_of(float a, float g) {
  return a * (GELU == 1 ? gelu_tanh(g) : gelu_erf_as(g));
}

// ---- the bf16 route of plain / tanh / geglu_ffn: LN pass, two wgmma GEMMs

// xn = LN(x) in bf16, one warp per row: fp32 statistics (E[x^2] - mean^2),
// scale and shift in fp32, one rounding
template <int C>
__global__ void __launch_bounds__(256) ffn_ln_rows_kernel(
    const bf16* __restrict__ x, const float* __restrict__ ls, const float* __restrict__ lb,
    bf16* __restrict__ xn, long long R) {
  constexpr int V = C / 8;                          // 16-byte vectors a row
  constexpr int PER = (V + 31) / 32;                // vectors a lane
  const int lane = threadIdx.x % 32;
  const long long row = (long long)blockIdx.x * 8 + threadIdx.x / 32;
  if (row >= R) return;
  const uint4* xr = reinterpret_cast<const uint4*>(x + row * C);
  uint4 v[PER];
  float s1 = 0.0f, s2 = 0.0f;
#pragma unroll
  for (int i = 0; i < PER; ++i) {                  // a lane past the row reads zeros
    const int c = lane + 32 * i;
    v[i] = c < V ? xr[c] : make_uint4(0u, 0u, 0u, 0u);
    const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&v[i]);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 f = __bfloat1622float2(p[e]);
      s1 += f.x + f.y;
      s2 += f.x * f.x + f.y * f.y;
    }
  }
  s1 = mofa::warp_sum(s1);
  s2 = mofa::warp_sum(s2);
  const float mean = s1 / C;
  const float var = fmaxf(s2 / C - mean * mean, 0.0f);
  const float rstd = rsqrtf(var + LN_EPS);
  uint4* yr = reinterpret_cast<uint4*>(xn + row * C);
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int c = lane + 32 * i;
    if (c < V) {
      const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&v[i]);
      const float4* sc = reinterpret_cast<const float4*>(ls) + 2 * c;
      const float4* sh = reinterpret_cast<const float4*>(lb) + 2 * c;
      const float4 s0 = sc[0], s1v = sc[1], h0 = sh[0], h1 = sh[1];
      const float scale[8] = {s0.x, s0.y, s0.z, s0.w, s1v.x, s1v.y, s1v.z, s1v.w};
      const float shift[8] = {h0.x, h0.y, h0.z, h0.w, h1.x, h1.y, h1.z, h1.w};
      uint4 o;
      __nv_bfloat162* q = reinterpret_cast<__nv_bfloat162*>(&o);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 f = __bfloat1622float2(p[e]);
        q[e] = __floats2bfloat162_rn((f.x - mean) * rstd * scale[2 * e] + shift[2 * e],
                                     (f.y - mean) * rstd * scale[2 * e + 1] + shift[2 * e + 1]);
      }
      yr[c] = o;
    }
  }
}

constexpr int GEMM_BM = 128;        // rows per tile: two consumer warpgroups of 64
constexpr int KTILE = 64;           // k per ring stage: one 128-byte swizzled row
constexpr int GEMM_THREADS = 384;   // two consumer warpgroups, one producer
constexpr int SMEM_LIMIT = 232448;  // a block's shared memory on sm_90
constexpr int OUT_CH = 32;          // output columns per staged chunk of the out GEMM
constexpr int OUT_PITCH = 40;       // its fp32 row pitch: conflict-free float2 / float4

// The two products as one TN GEMM (A [M, K] and B [N, K], both K-major):
// GATE: A = xn [M, C], B = W0 [8C, C], a tile of TN = 128 gate columns (B:
// the a rows and the g rows, two boxes of 128); otherwise A = h [M, 4C],
// B = W2 [C, 4C], a tile of TN = 160 output columns (B: two boxes of 80).
template <int C, bool GATE>
struct GemmCfg {
  static constexpr int K = GATE ? C : 4 * C;
  static constexpr int KT = K / KTILE;
  static constexpr int N = GATE ? 4 * C : C;             // output columns
  static constexpr int TN = GATE ? 128 : 160;            // output columns per tile
  static constexpr int N_TILES = N / TN;
  static constexpr int BOX_ROWS = GATE ? 128 : TN / 2;   // B rows per box, two boxes
  static constexpr int A_BYTES = GEMM_BM * 128;
  static constexpr int BOX_BYTES = BOX_ROWS * 128;
  static constexpr int STAGE_BYTES = A_BYTES + 2 * BOX_BYTES;
  // the out GEMM's epilogue stages a 64 x OUT_CH fp32 chunk per warpgroup
  static constexpr int EPI_WG_BYTES = GATE ? 0 : 64 * OUT_PITCH * 4;
  static constexpr int STAGES_FIT = (SMEM_LIMIT - 1024 - 256 - 2 * EPI_WG_BYTES) / STAGE_BYTES;
  static constexpr int STAGES = STAGES_FIT < 6 ? STAGES_FIT : 6;
  static constexpr int SMEM = STAGES * STAGE_BYTES + 2 * EPI_WG_BYTES + 1024;  // + alignment
  static constexpr int ACC = GATE ? 128 : TN / 2;        // fp32 accumulators a thread
  // residual pieces (4 columns) a consumer thread adds per chunk
  static constexpr int RES_PER_CHUNK = 64 * OUT_CH / 4 / 128;
  static_assert(K % KTILE == 0 && N % TN == 0 && TN % OUT_CH == 0, "whole tiles");
  static_assert(BOX_BYTES % 1024 == 0, "boxes keep the 1024-byte swizzle atoms");
  static_assert(STAGES >= 2, "a ring");
};

template <int C, bool GATE, int GELU, bool RESID>
__global__ void __launch_bounds__(GEMM_THREADS, 1) ffn_gemm_kernel(
    const __grid_constant__ CUtensorMap ta, const __grid_constant__ CUtensorMap tb,
    const bf16* __restrict__ bias, const bf16* __restrict__ resid, bf16* __restrict__ out,
    int M) {
  using G = GemmCfg<C, GATE>;
  constexpr int TN = G::TN;
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t bars[2 * G::STAGES];
  // swizzled tiles start on 1024-byte boundaries (the 8-row swizzle atom)
  const uint32_t base = (mofa::smem_addr(smem_raw) + 1023) & ~1023u;
  auto sa = [&](int s) { return base + s * G::STAGE_BYTES; };
  auto sb = [&](int s) { return base + s * G::STAGE_BYTES + G::A_BYTES; };
  auto full = [&](int s) { return mofa::smem_addr(&bars[s]); };
  auto empty = [&](int s) { return mofa::smem_addr(&bars[G::STAGES + s]); };

  const int tid = threadIdx.x, wg = tid / 128;
  const int tiles = (M + GEMM_BM - 1) / GEMM_BM * G::N_TILES;
  if (tid == 0) {
    for (int s = 0; s < G::STAGES; ++s) {
      mofa::mbar_init(full(s), 1);
      mofa::mbar_init(empty(s), 8);                 // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {
    // ---- producer: one thread issues every copy, running ahead of the
    // consumers by up to STAGES k-tiles, across tiles
    mofa::setmaxnreg_dec<24>();
    if (tid == 256) {
      int it = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int m0 = tile / G::N_TILES * GEMM_BM, n0 = tile % G::N_TILES * TN;
        for (int kt = 0; kt < G::KT; ++kt, ++it) {
          const int s = it % G::STAGES, round = it / G::STAGES;
          if (round > 0) mofa::mbar_wait(empty(s), (round - 1) & 1);
          mofa::mbar_arrive_expect_tx(full(s), G::STAGE_BYTES);
          mofa::tma_load_2d(sa(s), &ta, full(s), kt * KTILE, m0);
#pragma unroll
          for (int b = 0; b < 2; ++b)
            mofa::tma_load_2d(sb(s) + b * G::BOX_BYTES, &tb, full(s), kt * KTILE,
                              GATE ? n0 + b * 4 * C : n0 + b * G::BOX_ROWS);
        }
      }
    }
    return;
  }

  // ---- consumers: 64 rows of the tile each
  mofa::setmaxnreg_inc<240>();
  const int warp = (tid % 128) / 32, lane = tid % 32, t = lane & 3, wt = tid % 128;
  const int wrow = warp * 16 + (lane >> 2);         // the fragment's first row in the warpgroup
  float* const stage_out = reinterpret_cast<float*>(
      smem_raw + (base - mofa::smem_addr(smem_raw)) + G::STAGES * G::STAGE_BYTES +
      wg * G::EPI_WG_BYTES);
  float acc[G::ACC];
  auto fence_acc = [&]() {
#pragma unroll
    for (int i = 0; i < G::ACC; ++i) mofa::fence_operand(acc[i]);
  };
  auto release = [&](int it) {                      // k-tile it's stage may be refilled
    __syncwarp();
    if (lane == 0) mofa::mbar_arrive(empty(it % G::STAGES));
  };
  int it = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int m0 = tile / G::N_TILES * GEMM_BM, n0 = tile % G::N_TILES * TN;
    // the epilogue's operands are loaded before the products, which hide
    // their latency: the bias pairs of this thread's fragment columns (and
    // of the g columns), and the residual pieces of its copy-out rows
    uint32_t bias2[GATE ? 32 : TN / 8];
#pragma unroll
    for (int j = 0; j < TN / 8; ++j) {
      bias2[j] = __ldg(reinterpret_cast<const unsigned*>(bias + n0 + 8 * j + 2 * t));
      if constexpr (GATE)
        bias2[16 + j] = __ldg(reinterpret_cast<const unsigned*>(bias + 4 * C + n0 + 8 * j + 2 * t));
    }
    uint2 res[RESID ? TN / OUT_CH * G::RES_PER_CHUNK : 1];
    if constexpr (RESID) {
#pragma unroll
      for (int i = 0; i < TN / OUT_CH * G::RES_PER_CHUNK; ++i) {
        const int q = wt + 128 * (i % G::RES_PER_CHUNK), r = q / (OUT_CH / 4);
        const int col = n0 + i / G::RES_PER_CHUNK * OUT_CH + 4 * (q % (OUT_CH / 4));
        const long long grow = m0 + wg * 64 + r;
        res[i] = grow < M ? __ldg(reinterpret_cast<const uint2*>(resid + grow * C + col))
                          : make_uint2(0u, 0u);
      }
    }

    for (int kt = 0; kt < G::KT; ++kt, ++it) {
      const int s = it % G::STAGES;
      mofa::mbar_wait(full(s), (it / G::STAGES) & 1);
      const uint32_t a = sa(s) + wg * 64 * 128;
      fence_acc();
      mofa::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < KTILE / 16; ++kk) {     // a k16 step is 32 bytes of the row
        const uint64_t da = mofa::gmma_desc_sw128(a + kk * 32, 16, 1024);
        const uint64_t db = mofa::gmma_desc_sw128(sb(s) + kk * 32, 16, 1024);
        const int accumulate = kt > 0 || kk > 0;
        // gate: the a and g boxes back to back, one n256 product makes both;
        // out: the two 80-row boxes back to back, one n160 product
        if constexpr (GATE) mofa::wgmma_m64n256k16_ss(acc, da, db, accumulate);
        else mofa::wgmma_m64n160k16_ss(acc, da, db, accumulate);
      }
      mofa::wgmma_commit();
      fence_acc();
      if (kt > 0) {
        mofa::wgmma_wait<1>();                      // k-tile kt - 1 is done with its stage
        release(it - 1);
      }
    }
    mofa::wgmma_wait<0>();
    fence_acc();
    release(it - 1);

    // ---- epilogue: fragment (warp, lane) holds rows wrow and wrow + 8 of
    // every n8 block j at columns 8j + 2t, 8j + 2t + 1
    if constexpr (GATE) {
      const int r0 = m0 + wg * 64 + wrow;
      bf16* hrow = out + (long long)r0 * (4 * C);
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const float2 ba = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&bias2[j]));
        const float2 bg =
            __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&bias2[16 + j]));
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          if (r0 + 8 * hh < M)
            *reinterpret_cast<__nv_bfloat162*>(hrow + hh * 8 * (4 * C) + n0 + 8 * j + 2 * t) =
                __floats2bfloat162_rn(
                    gate_of<GELU>(acc[4 * j + 2 * hh] + ba.x, acc[64 + 4 * j + 2 * hh] + bg.x),
                    gate_of<GELU>(acc[4 * j + 2 * hh + 1] + ba.y,
                                  acc[64 + 4 * j + 2 * hh + 1] + bg.y));
        }
      }
    } else {
      // OUT_CH columns at a time: acc + b2 in fp32 into shared memory, then
      // rows of 4-column pieces (eight lanes to a row's 64 bytes) with the
      // residual added, rounded once
#pragma unroll
      for (int ch = 0; ch < TN / OUT_CH; ++ch) {
        mofa::named_bar_sync(1 + wg, 128);          // the last chunk's copy-out is done
#pragma unroll
        for (int j = ch * OUT_CH / 8; j < (ch + 1) * OUT_CH / 8; ++j) {
          const float2 bb =
              __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&bias2[j]));
#pragma unroll
          for (int hh = 0; hh < 2; ++hh)
            *reinterpret_cast<float2*>(stage_out + (wrow + 8 * hh) * OUT_PITCH + 8 * j -
                                       ch * OUT_CH + 2 * t) =
                make_float2(acc[4 * j + 2 * hh] + bb.x, acc[4 * j + 2 * hh + 1] + bb.y);
        }
        mofa::named_bar_sync(1 + wg, 128);
#pragma unroll
        for (int i = 0; i < G::RES_PER_CHUNK; ++i) {
          const int q = wt + 128 * i, r = q / (OUT_CH / 4), c = 4 * (q % (OUT_CH / 4));
          const long long grow = m0 + wg * 64 + r;
          if (grow < M) {
            float4 v = *reinterpret_cast<const float4*>(stage_out + r * OUT_PITCH + c);
            if constexpr (RESID) {
              const uint2 xr = res[ch * G::RES_PER_CHUNK + i];
              const float2 x01 =
                  __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&xr.x));
              const float2 x23 =
                  __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&xr.y));
              v.x += x01.x;
              v.y += x01.y;
              v.z += x23.x;
              v.w += x23.y;
            }
            *reinterpret_cast<uint2*>(out + grow * C + n0 + ch * OUT_CH + c) =
                make_uint2(mofa::pack_bf16(v.x, v.y), mofa::pack_bf16(v.z, v.w));
          }
        }
      }
    }
  }
}

// ---- the fp32 route of plain: LN pass, two split-TF32 wgmma GEMMs

// the big and small planes of n4 float4s (W0 and W2, once a call)
__global__ void split_planes_kernel(const float4* __restrict__ x, float4* __restrict__ big,
                                    float4* __restrict__ small, long long n4) {
  mofa::split_tf32_planes(x, big, small, n4);
}

// xn = LN(x) in fp32 as its big and small TF32 planes, one warp per row:
// the statistics as the bf16 pass (E[x^2] - mean^2), 16-byte loads
template <int C>
__global__ void __launch_bounds__(256) ffn_ln_split_kernel(
    const float* __restrict__ x, const float* __restrict__ ls, const float* __restrict__ lb,
    float* __restrict__ xb, float* __restrict__ xs, long long R) {
  constexpr int V = C / 4;                          // 16-byte vectors a row
  constexpr int PER = (V + 31) / 32;                // vectors a lane
  const int lane = threadIdx.x % 32;
  const long long row = (long long)blockIdx.x * 8 + threadIdx.x / 32;
  if (row >= R) return;
  const float4* xr = reinterpret_cast<const float4*>(x + row * C);
  float4 v[PER];
  float s1 = 0.0f, s2 = 0.0f;
#pragma unroll
  for (int i = 0; i < PER; ++i) {                  // a lane past the row reads zeros
    const int c = lane + 32 * i;
    v[i] = c < V ? xr[c] : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    s1 += (v[i].x + v[i].y) + (v[i].z + v[i].w);
    s2 += (v[i].x * v[i].x + v[i].y * v[i].y) + (v[i].z * v[i].z + v[i].w * v[i].w);
  }
  s1 = mofa::warp_sum(s1);
  s2 = mofa::warp_sum(s2);
  const float mean = s1 / C;
  const float var = fmaxf(s2 / C - mean * mean, 0.0f);
  const float rstd = rsqrtf(var + LN_EPS);
  float4* br = reinterpret_cast<float4*>(xb + row * C);
  float4* sr = reinterpret_cast<float4*>(xs + row * C);
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int c = lane + 32 * i;
    if (c < V) {
      const float4 sc = reinterpret_cast<const float4*>(ls)[c];
      const float4 sh = reinterpret_cast<const float4*>(lb)[c];
      float4 bg, sm;
      mofa::split_tf32((v[i].x - mean) * rstd * sc.x + sh.x, bg.x, sm.x);
      mofa::split_tf32((v[i].y - mean) * rstd * sc.y + sh.y, bg.y, sm.y);
      mofa::split_tf32((v[i].z - mean) * rstd * sc.z + sh.z, bg.z, sm.z);
      mofa::split_tf32((v[i].w - mean) * rstd * sc.w + sh.w, bg.w, sm.w);
      br[c] = bg;
      sr[c] = sm;
    }
  }
}

// The two fp32 products as TN GEMMs on split TF32: A and B each as a big
// and a small plane, both K-major; per k8 step three `wgmma` (small * big,
// big * small, big * big) into one fp32 accumulator. GATE: A = xn [M, C],
// B = W0 [8C, C], a tile of TN = 64 gate columns (B: the a rows and the g
// rows, two boxes of 64, one m64n128k8 per product); otherwise A = h
// [M, 4C], B = W2 [C, 4C], a tile of TN = 160 output columns (one box,
// m64n160k8). A stage holds a k-tile of 32 (one 128-byte swizzled row) of
// A's two planes and B's two.
constexpr int F32_KTILE = 32;
template <int C, bool GATE>
struct GemmF32Cfg {
  static constexpr int K = GATE ? C : 4 * C;
  static constexpr int KT = K / F32_KTILE;
  static constexpr int N = GATE ? 4 * C : C;             // output columns
  static constexpr int TN = GATE ? 64 : 160;             // output columns per tile
  static constexpr int N_TILES = N / TN;
  static constexpr int B_ROWS = GATE ? 2 * TN : TN;      // B rows a plane: a | g, or W2's
  static constexpr int BOX_ROWS = GATE ? TN : B_ROWS;    // B rows a box
  static constexpr int ACC = B_ROWS / 2;                 // fp32 accumulators a thread
  static constexpr int A_BYTES = GEMM_BM * 128;          // one plane's A box
  static constexpr int B_BYTES = B_ROWS * 128;           // one plane's B boxes
  static constexpr int STAGE_BYTES = 2 * (A_BYTES + B_BYTES);
  static constexpr int STAGES_FIT = (SMEM_LIMIT - 1024 - 256) / STAGE_BYTES;
  static constexpr int STAGES = STAGES_FIT < 6 ? STAGES_FIT : 6;
  static constexpr int SMEM = STAGES * STAGE_BYTES + 1024;   // + alignment
  static_assert(K % F32_KTILE == 0 && N % TN == 0, "whole tiles");
  static_assert(B_BYTES % 1024 == 0 && BOX_ROWS * 128 % 1024 == 0, "1024-byte swizzle atoms");
  static_assert(STAGES >= 2, "a ring");
};

template <int N>
__device__ __forceinline__ void wgmma_tf32(float* d, uint64_t da, uint64_t db, int acc) {
  if constexpr (N == 128) mofa::wgmma_m64n128k8_tf32_ss(d, da, db, acc);
  else mofa::wgmma_m64n160k8_tf32_ss(d, da, db, acc);
}

// Persistent (one block per SM walks the tiles, N fastest), a producer
// warpgroup and two consumer warpgroups of 64 rows, as the bf16 GEMM.
// Epilogue, GATE: h = (a + b0) * gelu_erf(g + b0') in fp32, stored as its
// big and small planes (out_b, out_s: the out GEMM's A); otherwise out =
// acc + b2 + x in fp32 (out_b). Fragment stores of two floats: four
// threads write a row's 32 contiguous bytes, whole sectors.
template <int C, bool GATE>
__global__ void __launch_bounds__(GEMM_THREADS, 1) ffn_gemm_f32_kernel(
    const __grid_constant__ CUtensorMap tab, const __grid_constant__ CUtensorMap tas,
    const __grid_constant__ CUtensorMap tbb, const __grid_constant__ CUtensorMap tbs,
    const float* __restrict__ bias, const float* __restrict__ resid,
    float* __restrict__ out_b, float* __restrict__ out_s, int M) {
  using G = GemmF32Cfg<C, GATE>;
  constexpr int TN = G::TN;
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t bars[2 * G::STAGES];
  // a stage: [A big | A small | B big | B small], 1024-byte aligned boxes
  const uint32_t base = (mofa::smem_addr(smem_raw) + 1023) & ~1023u;
  auto stage = [&](int s) { return base + s * G::STAGE_BYTES; };
  auto full = [&](int s) { return mofa::smem_addr(&bars[s]); };
  auto empty = [&](int s) { return mofa::smem_addr(&bars[G::STAGES + s]); };

  const int tid = threadIdx.x, wg = tid / 128;
  const int tiles = (M + GEMM_BM - 1) / GEMM_BM * G::N_TILES;
  if (tid == 0) {
    for (int s = 0; s < G::STAGES; ++s) {
      mofa::mbar_init(full(s), 1);
      mofa::mbar_init(empty(s), 8);                 // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {
    // ---- producer: one thread issues every copy, running ahead of the
    // consumers by up to STAGES k-tiles, across tiles
    mofa::setmaxnreg_dec<24>();
    if (tid == 256) {
      int it = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int m0 = tile / G::N_TILES * GEMM_BM, n0 = tile % G::N_TILES * TN;
        for (int kt = 0; kt < G::KT; ++kt, ++it) {
          const int s = it % G::STAGES, round = it / G::STAGES;
          if (round > 0) mofa::mbar_wait(empty(s), (round - 1) & 1);
          const uint32_t st = stage(s);
          const int k0 = kt * F32_KTILE;
          mofa::mbar_arrive_expect_tx(full(s), G::STAGE_BYTES);
          mofa::tma_load_2d(st, &tab, full(s), k0, m0);
          mofa::tma_load_2d(st + G::A_BYTES, &tas, full(s), k0, m0);
#pragma unroll
          for (int q = 0; q < G::B_ROWS / G::BOX_ROWS; ++q) {
            const int row = GATE ? n0 + q * 4 * C : n0;
            const uint32_t bo = st + 2 * G::A_BYTES + q * G::BOX_ROWS * 128;
            mofa::tma_load_2d(bo, &tbb, full(s), k0, row);
            mofa::tma_load_2d(bo + G::B_BYTES, &tbs, full(s), k0, row);
          }
        }
      }
    }
    return;
  }

  // ---- consumers: 64 rows of the tile each. A k-tile's products go to a
  // fresh accumulator, which is added to the tile's sum in fp32 adds: the
  // tensor cores' fp32 accumulation truncates each product group's sum.
  // With the whole row summed there (the out GEMM's 480 groups at C =
  // 320) the route read 7.4e-6 relative RMS from the plain version on an
  // H100; with the k-tile sums added in fp32, 6.0e-7.
  mofa::setmaxnreg_inc<240>();
  const int warp = (tid % 128) / 32, lane = tid % 32, t = lane & 3;
  const int wrow = warp * 16 + (lane >> 2);         // the fragment's first row in the warpgroup
  float acc[G::ACC], sum[G::ACC];
  auto fence_acc = [&]() {
#pragma unroll
    for (int i = 0; i < G::ACC; ++i) mofa::fence_operand(acc[i]);
  };
  int it = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int m0 = tile / G::N_TILES * GEMM_BM, n0 = tile % G::N_TILES * TN;
#pragma unroll
    for (int i = 0; i < G::ACC; ++i) sum[i] = 0.0f;
    for (int kt = 0; kt < G::KT; ++kt, ++it) {
      const int s = it % G::STAGES;
      mofa::mbar_wait(full(s), (it / G::STAGES) & 1);
      const uint32_t a = stage(s) + wg * 64 * 128, b = stage(s) + 2 * G::A_BYTES;
      fence_acc();
      mofa::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < F32_KTILE / 8; ++kk) {  // a k8 step is 32 bytes of the row
        const uint64_t ab = mofa::gmma_desc_sw128(a + kk * 32, 16, 1024);
        const uint64_t as = mofa::gmma_desc_sw128(a + G::A_BYTES + kk * 32, 16, 1024);
        const uint64_t bb = mofa::gmma_desc_sw128(b + kk * 32, 16, 1024);
        const uint64_t bs = mofa::gmma_desc_sw128(b + G::B_BYTES + kk * 32, 16, 1024);
        wgmma_tf32<G::B_ROWS>(acc, as, bb, kk > 0);
        wgmma_tf32<G::B_ROWS>(acc, ab, bs, 1);
        wgmma_tf32<G::B_ROWS>(acc, ab, bb, 1);
      }
      mofa::wgmma_commit();
      mofa::wgmma_wait<0>();
      fence_acc();
      __syncwarp();
      if (lane == 0) mofa::mbar_arrive(empty(s));   // the stage may be refilled
#pragma unroll
      for (int i = 0; i < G::ACC; ++i) sum[i] += acc[i];
    }

    // ---- epilogue: fragment (warp, lane) holds rows wrow and wrow + 8 of
    // every n8 block j at columns 8j + 2t, 8j + 2t + 1
    const long long r0 = m0 + wg * 64 + wrow;
    if constexpr (GATE) {
#pragma unroll
      for (int j = 0; j < TN / 8; ++j) {
        const int col = n0 + 8 * j + 2 * t;
        const float2 ba = __ldg(reinterpret_cast<const float2*>(bias + col));
        const float2 bg = __ldg(reinterpret_cast<const float2*>(bias + 4 * C + col));
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const long long row = r0 + 8 * hh;
          if (row < M) {
            const int e = 4 * j + 2 * hh, f = TN / 2 + 4 * j + 2 * hh;   // a, then g
            float2 hb, hs;
            mofa::split_tf32((sum[e] + ba.x) * gelu_erf(sum[f] + bg.x), hb.x, hs.x);
            mofa::split_tf32((sum[e + 1] + ba.y) * gelu_erf(sum[f + 1] + bg.y), hb.y, hs.y);
            *reinterpret_cast<float2*>(out_b + row * (4 * C) + col) = hb;
            *reinterpret_cast<float2*>(out_s + row * (4 * C) + col) = hs;
          }
        }
      }
    } else {
#pragma unroll
      for (int j = 0; j < TN / 8; ++j) {
        const int col = n0 + 8 * j + 2 * t;
        const float2 bb = __ldg(reinterpret_cast<const float2*>(bias + col));
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const long long row = r0 + 8 * hh;
          if (row < M) {
            const float2 xr = __ldg(reinterpret_cast<const float2*>(resid + row * C + col));
            *reinterpret_cast<float2*>(out_b + row * C + col) =
                make_float2(sum[4 * j + 2 * hh] + bb.x + xr.x,
                            sum[4 * j + 2 * hh + 1] + bb.y + xr.y);
          }
        }
      }
    }
  }
}

// ---- the gate GEMM's "pipe" and "ilv" schedules (entry points only)

enum Schedule { kPlain = 0, kIlv = 1, kPipe = 2 };   // the Python names' order

// A schedule's tile: BM rows of xn x TN gate columns, its B operand W0's a
// rows [n0, n0 + TN) and g rows [4C + n0, 4C + n0 + TN), two boxes back to
// back, so one m64 x n(2 TN) product per k16 makes both halves; k-tiles of
// 64 in a ring of as many stages as fit beside the epilogue's staging. The
// blocks run in clusters of two that walk pair tiles: the two row tiles
// [m0, m0 + 2 BM) at one n0, block rank r taking rows m0 + r BM; block r
// loads its own xn box and W0 box r (a or g), multicast to both, so each
// block reads half of B from L2. A warpgroup's gated [64, TN] tile is
// staged in shared memory (EPI_BUFS buffers a warpgroup, 64-column
// sub-tiles of 8 KB in the 128-byte swizzle) and written by a TMA store.
constexpr int CLUSTER = 2;
template <int C, int BM_, int TN_, int EPI_BUFS_>
struct SchedCfg {
  static constexpr int BM = BM_, TN = TN_, EPI_BUFS = EPI_BUFS_;
  static constexpr int KT = C / KTILE;
  static constexpr int N_TILES = 4 * C / TN;       // gate-column tiles
  static constexpr int A_BYTES = BM * 128;
  static constexpr int BOX_BYTES = TN * 128;
  static constexpr int STAGE_BYTES = A_BYTES + 2 * BOX_BYTES;
  static constexpr int EPI_TILE = 64 * TN * 2;     // a warpgroup's gated tile, bf16
  static constexpr int EPI_BYTES = 2 * EPI_BUFS * EPI_TILE;
  static constexpr int STAGES_FIT = (SMEM_LIMIT - 1024 - 256 - EPI_BYTES) / STAGE_BYTES;
  static constexpr int STAGES = STAGES_FIT < 8 ? STAGES_FIT : 8;
  static constexpr int SMEM = STAGES * STAGE_BYTES + EPI_BYTES + 1024;  // + alignment
  static_assert(C % KTILE == 0 && (4 * C) % TN == 0 && TN % 64 == 0, "whole tiles");
  static_assert(A_BYTES % 1024 == 0 && BOX_BYTES % 1024 == 0, "1024-byte swizzle atoms");
  static_assert(STAGES >= 3, "a ring");
};
// pipe: 128 rows (a warpgroup's 64 each) x 64 gate columns, 32 KB stages,
// two staging buffers a warpgroup (a tile's stores overlap the next tile's
// epilogue); ilv: 64 rows (one warpgroup's tile) x 128 gate columns, 40 KB
// stages, one staging buffer a warpgroup (its tiles are two apart)
template <int C> using PipeCfg = SchedCfg<C, GEMM_BM, 64, 2>;
template <int C> using IlvCfg = SchedCfg<C, 64, 128, 1>;
// named barriers: 1 + w, warpgroup w's epilogue; 3 + w, the ilv turn of w
constexpr int EPI_BAR = 1, TURN_BAR = 3;

template <int N>
__device__ __forceinline__ void fence_acc(float (&acc)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) mofa::fence_operand(acc[i]);
}

// The pair tiles of M rows, and this block's count of them (its cluster
// walks pair tiles cluster, cluster + clusters, ...)
template <typename Cfg>
__device__ __forceinline__ int pair_tiles(int M) {
  return (M + CLUSTER * Cfg::BM - 1) / (CLUSTER * Cfg::BM) * Cfg::N_TILES;
}
template <typename Cfg>
__device__ __forceinline__ int block_tiles(int M) {
  const int cluster = blockIdx.x / CLUSTER, clusters = gridDim.x / CLUSTER;
  return (pair_tiles<Cfg>(M) - cluster + clusters - 1) / clusters;
}
// the origin (m0, n0) of tile i of this block (of cluster rank `rank`)
template <typename Cfg>
__device__ __forceinline__ void tile_origin(int i, uint32_t rank, int& m0, int& n0) {
  const int p = blockIdx.x / CLUSTER + i * (gridDim.x / CLUSTER);
  m0 = (p / Cfg::N_TILES * CLUSTER + (int)rank) * Cfg::BM;
  n0 = p % Cfg::N_TILES * Cfg::TN;
}

// The producer: one thread walks the block's tiles in order; for each
// k-tile, once the ring stage is empty in both blocks of the cluster, it
// loads the block's xn box and multicasts W0 box `rank` (the a rows, or
// the g rows) into the stage of both blocks. At the end it waits until
// every stage's last use is released by both blocks' consumers, so no
// remote arrival targets this block after it exits.
template <typename Cfg, int C>
__device__ __forceinline__ void gate_produce(const CUtensorMap* ta, const CUtensorMap* tb,
                                             uint32_t base, uint64_t* bars, int M,
                                             uint32_t rank) {
  const int n = block_tiles<Cfg>(M);
  auto empty = [&](int s) { return mofa::smem_addr(&bars[Cfg::STAGES + s]); };
  int it = 0;
  for (int i = 0; i < n; ++i) {
    int m0, n0;
    tile_origin<Cfg>(i, rank, m0, n0);
    for (int kt = 0; kt < Cfg::KT; ++kt, ++it) {
      const int s = it % Cfg::STAGES, round = it / Cfg::STAGES;
      const uint32_t full = mofa::smem_addr(&bars[s]), st = base + s * Cfg::STAGE_BYTES;
      if (round > 0) mofa::mbar_wait(empty(s), (round - 1) & 1);
      mofa::mbar_arrive_expect_tx(full, Cfg::STAGE_BYTES);
      mofa::tma_load_2d(st, ta, full, kt * KTILE, m0);
      for (int b = rank; b < 2; b += CLUSTER)
        mofa::tma_load_2d_multicast(st + Cfg::A_BYTES + b * Cfg::BOX_BYTES, tb, full,
                                    kt * KTILE, b * 4 * C + n0, (1 << CLUSTER) - 1);
    }
  }
  for (int k = 0; k < Cfg::STAGES; ++k, ++it)
    if (it >= Cfg::STAGES) mofa::mbar_wait(empty(it % Cfg::STAGES), (it / Cfg::STAGES - 1) & 1);
}

// A consumer warpgroup of a schedule. Its accumulator of a tile holds TN
// fp32 a thread: a_j at [4j + e] and g_j at [TN / 2 + 4j + e] for n8 block
// j < TN / 8, rows wrow + 8 (e / 2) of its 64, column 8j + 2t + e % 2.
template <typename Cfg, int C>
struct GateWarpgroup {
  static constexpr int TN = Cfg::TN;
  uint32_t base;            // the ring
  uint64_t* bars;           // full[STAGES], empty[STAGES]
  uint32_t epi;             // this warpgroup's staging buffers
  int w;                    // the warpgroup
  int row_off;              // its first row in a tile; in bytes of the xn box, row_off * 128
  int wrow, t, lane;        // the fragment's first row of the 64; lane % 4; lane
  bool leader;              // the thread that issues the warpgroup's TMA stores
  int it;                   // the ring position of the next k-tile to issue

  // k-tile kt of a tile into acc: four k16 products, one commit group
  __device__ __forceinline__ void issue(float (&acc)[TN], int kt) {
    const int s = it % Cfg::STAGES;
    mofa::mbar_wait(mofa::smem_addr(&bars[s]), (it / Cfg::STAGES) & 1);
    const uint32_t a = base + s * Cfg::STAGE_BYTES + row_off * 128;
    const uint32_t b = base + s * Cfg::STAGE_BYTES + Cfg::A_BYTES;
    fence_acc(acc);
    mofa::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KTILE / 16; ++kk) {   // a k16 step is 32 bytes of the row
      const uint64_t da = mofa::gmma_desc_sw128(a + kk * 32, 16, 1024);
      const uint64_t db = mofa::gmma_desc_sw128(b + kk * 32, 16, 1024);
      const int accumulate = kt > 0 || kk > 0;
      if constexpr (TN == 64) mofa::wgmma_m64n128k16_ss(acc, da, db, accumulate);
      else mofa::wgmma_m64n256k16_ss(acc, da, db, accumulate);
    }
    mofa::wgmma_commit();
    fence_acc(acc);
    ++it;
  }
  // the stage of ring position pos may be refilled (its group retired):
  // one arrival on its empty barrier in each block of the cluster
  __device__ __forceinline__ void release(int pos) const {
    __syncwarp();
    if (lane < CLUSTER)
      mofa::mbar_arrive_cluster(mofa::smem_addr(&bars[Cfg::STAGES + pos % Cfg::STAGES]), lane);
  }
  // the bias pairs of this thread's columns n0 + 8j + 2t: a at [j], g at [TN / 8 + j]
  __device__ __forceinline__ void load_bias(uint32_t (&bias)[TN / 4], const bf16* __restrict__ b0,
                                            int n0) const {
#pragma unroll
    for (int j = 0; j < TN / 8; ++j) {
      bias[j] = __ldg(reinterpret_cast<const unsigned*>(b0 + n0 + 8 * j + 2 * t));
      bias[TN / 8 + j] =
          __ldg(reinterpret_cast<const unsigned*>(b0 + 4 * C + n0 + 8 * j + 2 * t));
    }
  }
  // the epilogue of n8 block j: the gate in fp32, rounded to bf16, into
  // staging buffer buf at rows wrow, wrow + 8, columns 8j + 2t, + 1 (the
  // 16-byte chunk j % 8 of a 128-byte row r lies at chunk (j % 8) ^ (r % 8),
  // and r % 8 = lane / 4: a warp's eight rows hit 32 distinct banks)
  __device__ __forceinline__ void store(const float (&acc)[TN], const uint32_t (&bias)[TN / 4],
                                        int j, int buf) const {
    const float2 ba = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&bias[j]));
    const float2 bg =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&bias[TN / 8 + j]));
    const uint32_t sub = epi + buf * Cfg::EPI_TILE + j / 8 * 8192;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = wrow + 8 * hh;
      mofa::st_shared_b32(
          sub + r * 128 + (((j % 8) ^ (lane / 4)) << 4) + 4 * t,
          mofa::pack_bf16(
              gate_ftz(acc[4 * j + 2 * hh] + ba.x, acc[TN / 2 + 4 * j + 2 * hh] + bg.x),
              gate_ftz(acc[4 * j + 2 * hh + 1] + ba.y, acc[TN / 2 + 4 * j + 2 * hh + 1] + bg.y)));
    }
  }
  // staging buffer buf holds the warpgroup's rows of the tile at (m0, n0):
  // the leader waits until its previous store has read its buffer, then,
  // once every thread's writes are visible to TMA, stores the buffer's
  // 64-column sub-tiles (rows past M are not written)
  __device__ __forceinline__ void flush(const CUtensorMap* th, int m0, int n0, int buf) const {
    mofa::fence_proxy_async();
    if (leader) mofa::bulk_wait_read<0>();
    mofa::named_bar_sync(EPI_BAR + w, 128);
    if (leader) {
#pragma unroll
      for (int q = 0; q < TN / 64; ++q)
        mofa::tma_store_2d(th, epi + buf * Cfg::EPI_TILE + q * 8192, n0 + 64 * q, m0 + row_off);
      mofa::bulk_commit();
    }
  }
};

// shared set-up of both schedules: the ring's barriers (empty: `consumers`
// warps of each block of the cluster arrive), then the producer
// warpgroup's branch; returns false there
template <typename Cfg, int C>
__device__ __forceinline__ bool gate_setup(const CUtensorMap* ta, const CUtensorMap* tb,
                                           uint32_t base, uint64_t* bars, int M, uint32_t rank,
                                           int consumers) {
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < Cfg::STAGES; ++s) {
      mofa::mbar_init(mofa::smem_addr(&bars[s]), 1);
      mofa::mbar_init(mofa::smem_addr(&bars[Cfg::STAGES + s]), consumers * CLUSTER);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  mofa::cluster_sync();
  if (tid >= 256) {
    mofa::setmaxnreg_dec<24>();
    if (tid == 256) gate_produce<Cfg, C>(ta, tb, base, bars, M, rank);
    return false;
  }
  mofa::setmaxnreg_inc<240>();
  return true;
}

// a consumer warpgroup of schedule Cfg in the kernel's block
template <typename Cfg, int C>
__device__ __forceinline__ GateWarpgroup<Cfg, C> gate_warpgroup(uint32_t base, uint64_t* bars,
                                                                int row_off) {
  const int tid = threadIdx.x, lane = tid % 32, w = tid / 128;
  return {base, bars, base + Cfg::STAGES * Cfg::STAGE_BYTES + w * Cfg::EPI_BUFS * Cfg::EPI_TILE,
          w, row_off, (tid % 128) / 32 * 16 + lane / 4, lane % 4, lane, tid % 128 == 0, 0};
}

// pipe, one step of a consumer warpgroup: tile i + 1's products (at n0n)
// into nxt, each k-tile's stage released as its group retires, and tile
// i's epilogue (at m0, n0, staging buffer buf) from cur in KT slices
// between them (n8 block j in slice j KT / 8), so the erf work runs beside
// the tensor cores. On entry cur's last group may be in flight; on exit
// nxt's last is.
template <int C>
__device__ __forceinline__ void pipe_step(GateWarpgroup<PipeCfg<C>, C>& wg, float (&nxt)[64],
                                          uint32_t (&bn)[16], float (&cur)[64],
                                          const uint32_t (&bc)[16], int m0, int n0, int n0n,
                                          int buf, const bf16* __restrict__ b0,
                                          const CUtensorMap* th) {
  constexpr int KT = PipeCfg<C>::KT;
  wg.load_bias(bn, b0, n0n);
#pragma unroll
  for (int kt = 0; kt < KT; ++kt) {
    wg.issue(nxt, kt);
    if (kt == 0) {                     // cur's last group retired: its epilogue may start
      mofa::wgmma_wait<1>();
      wg.release(wg.it - 2);
      fence_acc(cur);
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
      if (j * KT / 8 == kt) wg.store(cur, bc, j, buf);
    if (kt > 0) {                      // nxt's k-tile kt - 1 retired
      mofa::wgmma_wait<1>();
      wg.release(wg.it - 2);
    }
  }
  wg.flush(th, m0, n0, buf);
}

// pipe, the block's last tile: its last group retired, then its epilogue
template <int C>
__device__ __forceinline__ void pipe_drain(GateWarpgroup<PipeCfg<C>, C>& wg, float (&cur)[64],
                                           const uint32_t (&bc)[16], int m0, int n0, int buf,
                                           const CUtensorMap* th) {
  mofa::wgmma_wait<0>();
  wg.release(wg.it - 1);
  fence_acc(cur);
#pragma unroll
  for (int j = 0; j < 8; ++j) wg.store(cur, bc, j, buf);
  wg.flush(th, m0, n0, buf);
}

// "pipe": both consumer warpgroups walk the same tiles (64 rows each),
// with two accumulator sets and two staging buffers; the tile loop is
// unrolled by two so that each set's registers are named at compile time.
template <int C>
__global__ void __launch_bounds__(GEMM_THREADS, 1) ffn_gate_pipe_kernel(
    const __grid_constant__ CUtensorMap ta, const __grid_constant__ CUtensorMap tb,
    const __grid_constant__ CUtensorMap th, const bf16* __restrict__ b0, int M) {
  using P = PipeCfg<C>;
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t bars[2 * P::STAGES];
  const uint32_t base = (mofa::smem_addr(smem_raw) + 1023) & ~1023u;
  const uint32_t rank = mofa::cluster_ctarank();
  if (!gate_setup<P, C>(&ta, &tb, base, bars, M, rank, 8)) return;

  auto wg = gate_warpgroup<P, C>(base, bars, threadIdx.x / 128 * 64);
  const int n = block_tiles<P>(M);
  auto m0_of = [&](int i) { int m0, n0; tile_origin<P>(i, rank, m0, n0); return m0; };
  auto n0_of = [&](int i) { int m0, n0; tile_origin<P>(i, rank, m0, n0); return n0; };
  float acc0[64], acc1[64];
  uint32_t bias0[16], bias1[16];
  // the prologue: tile 0's products into acc0
  wg.load_bias(bias0, b0, n0_of(0));
#pragma unroll
  for (int kt = 0; kt < P::KT; ++kt) {
    wg.issue(acc0, kt);
    if (kt > 0) {
      mofa::wgmma_wait<1>();
      wg.release(wg.it - 2);
    }
  }
  for (int i = 0;; i += 2) {
    if (i + 1 == n) {
      pipe_drain<C>(wg, acc0, bias0, m0_of(i), n0_of(i), 0, &th);
      break;
    }
    pipe_step<C>(wg, acc1, bias1, acc0, bias0, m0_of(i), n0_of(i), n0_of(i + 1), 0, b0, &th);
    if (i + 2 == n) {
      pipe_drain<C>(wg, acc1, bias1, m0_of(i + 1), n0_of(i + 1), 1, &th);
      break;
    }
    pipe_step<C>(wg, acc0, bias0, acc1, bias1, m0_of(i + 1), n0_of(i + 1), n0_of(i + 2), 1, b0,
                 &th);
  }
  if (wg.leader) mofa::bulk_wait_read<0>();   // the staging read before the block exits
}

// "ilv": the consumer warpgroups take alternate tiles of the block's
// sequence (warpgroup w tiles i = w, w + 2, ...), each a whole 64-row tile;
// the turn to issue products passes in tile order on named barriers, and a
// warpgroup hands it on before its epilogue, so one warpgroup's erf work
// runs beside the other's products.
template <int C>
__global__ void __launch_bounds__(GEMM_THREADS, 1) ffn_gate_ilv_kernel(
    const __grid_constant__ CUtensorMap ta, const __grid_constant__ CUtensorMap tb,
    const __grid_constant__ CUtensorMap th, const bf16* __restrict__ b0, int M) {
  using I = IlvCfg<C>;
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t bars[2 * I::STAGES];
  const uint32_t base = (mofa::smem_addr(smem_raw) + 1023) & ~1023u;
  const uint32_t rank = mofa::cluster_ctarank();
  // a stage belongs to one warpgroup's tile: its four warps release it
  if (!gate_setup<I, C>(&ta, &tb, base, bars, M, rank, 4)) return;

  auto wg = gate_warpgroup<I, C>(base, bars, 0);
  const int w = wg.w, n = block_tiles<I>(M);
  float acc[128];
  uint32_t bias[32];
  for (int i = w; i < n; i += 2) {
    int m0, n0;
    tile_origin<I>(i, rank, m0, n0);
    wg.load_bias(bias, b0, n0);
    wg.it = i * I::KT;                 // the producer loads the tiles' k-tiles in tile order
    // the turn: tile i - 1 (the other warpgroup's) has issued its products.
    // Every turn handed on is taken: tile i + 1 exists whenever tile i hands
    // it on, so a warpgroup left without a last tile is never waited for.
    // Before taking it the leader sees this warpgroup's last store read its
    // staging buffer, which the epilogue below refills.
    if (i > 0) {
      if (wg.leader) mofa::bulk_wait_read<0>();
      mofa::named_bar_sync(TURN_BAR + w, 256);
    }
#pragma unroll
    for (int kt = 0; kt < I::KT; ++kt) {
      wg.issue(acc, kt);
      if (kt > 0) {
        mofa::wgmma_wait<1>();
        wg.release(wg.it - 2);
      }
    }
    if (i + 1 < n) mofa::named_bar_arrive(TURN_BAR + 1 - w, 256);
    mofa::wgmma_wait<0>();
    wg.release(wg.it - 1);
    fence_acc(acc);
#pragma unroll
    for (int j = 0; j < 16; ++j) wg.store(acc, bias, j, 0);
    wg.flush(&th, m0, n0, 0);
  }
  if (wg.leader) mofa::bulk_wait_read<0>();   // the staging read before the block exits
}

// ---- host: launches

template <int C>
int launch_ln_rows(const void* x, const void* ls, const void* lb, void* xn, int R,
                   cudaStream_t st) {
  if (R <= 0) return (int)cudaGetLastError();
  ffn_ln_rows_kernel<C><<<(R + 7) / 8, 256, 0, st>>>((const bf16*)x, (const float*)ls,
                                                     (const float*)lb, (bf16*)xn, R);
  return (int)cudaGetLastError();
}

int sm_count() {
  int dev = 0, n = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  return n;
}

// one GEMM: A [M, K] and B [N, K] bf16 as 2-D tensor maps, a persistent
// grid of at most one block per SM
template <int C, bool GATE, int GELU, bool RESID>
int launch_gemm(const void* a, const void* b, const void* bias, const void* resid, void* out,
                int M, cudaStream_t st) {
  using G = GemmCfg<C, GATE>;
  if (M <= 0) return (int)cudaGetLastError();
  CUtensorMap ta, tb;
  if (!mofa::bf16_rows_map(&ta, a, M, G::K, GEMM_BM) ||
      !mofa::bf16_rows_map(&tb, b, GATE ? 8 * C : C, G::K, G::BOX_ROWS))
    return (int)cudaErrorNotSupported;
  auto kernel = ffn_gemm_kernel<C, GATE, GELU, RESID>;
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, G::SMEM);
  const int tiles = (M + GEMM_BM - 1) / GEMM_BM * G::N_TILES;
  kernel<<<std::min(tiles, sm_count()), GEMM_THREADS, G::SMEM, st>>>(
      ta, tb, (const bf16*)bias, (const bf16*)resid, (bf16*)out, M);
  return (int)cudaGetLastError();
}

// one schedule's gate GEMM: xn, W0 and h as 2-D tensor maps (boxes of the
// schedule's rows and gate columns; h in boxes of 64 x 64), a persistent
// grid of as many two-block clusters as can be resident at once
template <int C, typename Cfg>
int launch_schedule(void (*kernel)(CUtensorMap, CUtensorMap, CUtensorMap, const bf16*, int),
                    const void* xn, const void* w0, const void* b0, void* h, int M,
                    cudaStream_t st) {
  if (M <= 0) return (int)cudaGetLastError();
  CUtensorMap ta, tb, th;
  if (!mofa::bf16_rows_map(&ta, xn, M, C, Cfg::BM) ||
      !mofa::bf16_rows_map(&tb, w0, 8 * C, C, Cfg::TN) ||
      !mofa::bf16_rows_map(&th, h, M, 4 * C, 64))
    return (int)cudaErrorNotSupported;
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Cfg::SMEM);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CLUSTER;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(CLUSTER);
  cfg.blockDim = dim3(GEMM_THREADS);
  cfg.dynamicSmemBytes = Cfg::SMEM;
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int clusters = 0;
  const cudaError_t err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
  if (err != cudaSuccess) return (int)err;
  if (clusters < 1) return (int)cudaErrorInvalidConfiguration;
  const int pairs = (M + CLUSTER * Cfg::BM - 1) / (CLUSTER * Cfg::BM) * Cfg::N_TILES;
  cfg.gridDim = dim3(CLUSTER * std::min(pairs, clusters));
  return (int)cudaLaunchKernelEx(&cfg, kernel, ta, tb, th, (const bf16*)b0, M);
}

// schedule: kPlain (gelu 0 = erf, 1 = tanh), kIlv or kPipe (erf only)
template <int C>
int launch_gate(const void* xn, const void* w0, const void* b0, void* h, int R, int gelu,
                int sched, cudaStream_t st) {
  if (sched == kPlain && gelu == 0)
    return launch_gemm<C, true, 0, false>(xn, w0, b0, nullptr, h, R, st);
  if (sched == kPlain && gelu == 1)
    return launch_gemm<C, true, 1, false>(xn, w0, b0, nullptr, h, R, st);
  if (sched == kIlv && gelu == 0)
    return launch_schedule<C, IlvCfg<C>>(ffn_gate_ilv_kernel<C>, xn, w0, b0, h, R, st);
  if (sched == kPipe && gelu == 0)
    return launch_schedule<C, PipeCfg<C>>(ffn_gate_pipe_kernel<C>, xn, w0, b0, h, R, st);
  return (int)cudaErrorInvalidValue;
}

template <int C>
int launch_out(const void* h, const void* w2, const void* b2, const void* resid, void* out,
               int R, cudaStream_t st) {
  if (resid != nullptr) return launch_gemm<C, false, 0, true>(h, w2, b2, resid, out, R, st);
  return launch_gemm<C, false, 0, false>(h, w2, b2, nullptr, out, R, st);
}

// the three stages in turn; ls == nullptr: geglu_ffn (no LN, no residual)
template <int C>
int launch_ffn(const void* x, const void* ls, const void* lb, const void* w0, const void* b0,
               const void* w2, const void* b2, void* xn, void* h, void* out, int R, int gelu,
               int sched, cudaStream_t st) {
  const bool ln = ls != nullptr;
  int err = ln ? launch_ln_rows<C>(x, ls, lb, xn, R, st) : 0;
  if (err == 0) err = launch_gate<C>(ln ? xn : x, w0, b0, h, R, gelu, sched, st);
  if (err == 0) err = launch_out<C>(h, w2, b2, ln ? x : nullptr, out, R, st);
  return err;
}

// one split-TF32 GEMM: A's and B's planes as 2-D tensor maps, a
// persistent grid of at most one block per SM
template <int C, bool GATE>
int launch_gemm_f32(const float* ab, const float* as, const float* bb, const float* bs,
                    const void* bias, const void* resid, float* out_b, float* out_s, int M,
                    cudaStream_t st) {
  using G = GemmF32Cfg<C, GATE>;
  CUtensorMap tab, tas, tbb, tbs;
  if (!mofa::f32_rows_map(&tab, ab, M, G::K, GEMM_BM) ||
      !mofa::f32_rows_map(&tas, as, M, G::K, GEMM_BM) ||
      !mofa::f32_rows_map(&tbb, bb, GATE ? 8 * C : C, G::K, G::BOX_ROWS) ||
      !mofa::f32_rows_map(&tbs, bs, GATE ? 8 * C : C, G::K, G::BOX_ROWS))
    return (int)cudaErrorNotSupported;
  auto kernel = ffn_gemm_f32_kernel<C, GATE>;
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, G::SMEM);
  const int tiles = (M + GEMM_BM - 1) / GEMM_BM * G::N_TILES;
  kernel<<<std::min(tiles, sm_count()), GEMM_THREADS, G::SMEM, st>>>(
      tab, tas, tbb, tbs, (const float*)bias, (const float*)resid, out_b, out_s, M);
  return (int)cudaGetLastError();
}

// the fp32 route: W0 and W2 split into planes (ws: 24 C^2 floats), xn =
// LN(x) as planes (xn: 2 R C), h as planes (h: 2 R 4C), then out
template <int C>
int launch_f32(const void* x, const void* ls, const void* lb, const void* w0, const void* b0,
               const void* w2, const void* b2, void* xn, void* h, void* ws, void* out, int R,
               cudaStream_t st) {
  if (R <= 0) return (int)cudaGetLastError();
  float* w0b = static_cast<float*>(ws);
  float* w0s = w0b + 8 * C * C;
  float* w2b = w0s + 8 * C * C;
  float* w2s = w2b + 4 * C * C;
  float* xb = static_cast<float*>(xn);
  float* xs = xb + (long long)R * C;
  float* hb = static_cast<float*>(h);
  float* hs = hb + (long long)R * 4 * C;
  split_planes_kernel<<<(2 * C * C + 255) / 256, 256, 0, st>>>(
      (const float4*)w0, (float4*)w0b, (float4*)w0s, 2 * C * C);
  split_planes_kernel<<<(C * C + 255) / 256, 256, 0, st>>>(
      (const float4*)w2, (float4*)w2b, (float4*)w2s, C * C);
  ffn_ln_split_kernel<C><<<(R + 7) / 8, 256, 0, st>>>(
      (const float*)x, (const float*)ls, (const float*)lb, xb, xs, R);
  int err = (int)cudaGetLastError();
  if (err == 0) err = launch_gemm_f32<C, true>(xb, xs, w0b, w0s, b0, nullptr, hb, hs, R, st);
  if (err == 0)
    err = launch_gemm_f32<C, false>(hb, hs, w2b, w2s, b2, x, (float*)out, nullptr, R, st);
  return err;
}

}  // namespace

// Arguments of every entry: x/out [R, C]; ls/lb [C] fp32; w0 [8C, C], b0
// [8C], w2 [C, 4C], b2 [C] in x's dtype; all contiguous and 32-byte
// aligned. Scratch in x's dtype: bf16, xn [R, C] and h [R, 4C] (ws null);
// fp32, the big and small planes, xn [2, R, C], h [2, R, 4C] and ws (of
// W0 and W2) 24 C^2 floats. C in {320, 640}; dtype 0 = fp32, 1 = bf16;
// gelu 0 = erf, 1 = tanh (bf16 only); sched: the gate GEMM's schedule, 0 =
// plain, 1 = ilv, 2 = pipe (bf16 and erf only for ilv and pipe).
extern "C" int mofa_ln_geglu_ffn(const void* x, const void* ls, const void* lb,
                                 const void* w0, const void* b0, const void* w2,
                                 const void* b2, void* xn, void* h, void* ws, void* out,
                                 int R, int C, int dtype, int gelu, int sched, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (ls == nullptr || lb == nullptr) return (int)cudaErrorInvalidValue;
  if (dtype == mofa::kBF16) {
    if (C == 320)
      return launch_ffn<320>(x, ls, lb, w0, b0, w2, b2, xn, h, out, R, gelu, sched, st);
    if (C == 640)
      return launch_ffn<640>(x, ls, lb, w0, b0, w2, b2, xn, h, out, R, gelu, sched, st);
  } else if (dtype == mofa::kF32 && gelu == 0 && sched == kPlain && ws != nullptr) {
    if (C == 320) return launch_f32<320>(x, ls, lb, w0, b0, w2, b2, xn, h, ws, out, R, st);
    if (C == 640) return launch_f32<640>(x, ls, lb, w0, b0, w2, b2, xn, h, ws, out, R, st);
  }
  return (int)cudaErrorInvalidValue;
}

extern "C" int mofa_geglu_ffn(const void* x, const void* w0, const void* b0, const void* w2,
                              const void* b2, void* h, void* out, int R, int C, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (C == 320)
    return launch_ffn<320>(x, nullptr, nullptr, w0, b0, w2, b2, nullptr, h, out, R, 0,
                           kPlain, st);
  if (C == 640)
    return launch_ffn<640>(x, nullptr, nullptr, w0, b0, w2, b2, nullptr, h, out, R, 0,
                           kPlain, st);
  return (int)cudaErrorInvalidValue;
}

// The stages one at a time (bf16): xn = LN(x); h = gate(xn W0^T + b0) by
// schedule 0 = plain, 1 = ilv, 2 = pipe (erf only); out = h W2^T + b2
// (+ resid, which may be null).
extern "C" int mofa_ffn_ln_rows(const void* x, const void* ls, const void* lb, void* xn, int R,
                                int C, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (C == 320) return launch_ln_rows<320>(x, ls, lb, xn, R, st);
  if (C == 640) return launch_ln_rows<640>(x, ls, lb, xn, R, st);
  return (int)cudaErrorInvalidValue;
}
extern "C" int mofa_ffn_gemm_gate(const void* xn, const void* w0, const void* b0, void* h, int R,
                                  int C, int gelu, int sched, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (C == 320) return launch_gate<320>(xn, w0, b0, h, R, gelu, sched, st);
  if (C == 640) return launch_gate<640>(xn, w0, b0, h, R, gelu, sched, st);
  return (int)cudaErrorInvalidValue;
}
extern "C" int mofa_ffn_gemm_out(const void* h, const void* w2, const void* b2,
                                 const void* resid, void* out, int R, int C, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (C == 320) return launch_out<320>(h, w2, b2, resid, out, R, st);
  if (C == 640) return launch_out<640>(h, w2, b2, resid, out, R, st);
  return (int)cudaErrorInvalidValue;
}
