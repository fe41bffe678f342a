// The GEGLU feed-forward family, C -> 8C -> 4C -> C (torch Linear layouts:
// W0 [8C, C], W2 [C, 4C]):
//   ln_geglu_ffn:  out = x + (a * gelu_erf(g)) W2^T + b2,  [a | g] = LN(x) W0^T + b0
//   geglu_ffn:     out =     (a * gelu_erf(g)) W2^T + b2,  [a | g] =    x  W0^T + b0
//
// Replaces mofa_tpu/kernels/geglu_ffn.py: `_ln_ffn_kernel` (:390; variant
// "plain", and "tanh" with the tanh-form gelu), `_ln_ffn_kernel_ilv`
// (:344, "ilv"), `_ln_ffn_kernel_pipe` (:363, "pipe") and `_ffn_kernel`
// (:93, `geglu_ffn`). The TPU kernels hold both weight matrices and the
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
// design this route replaced read all of W0 and W2 from L2 for every 64
// rows and lost to the stock cuBLAS chain at both widths.
//
// ilv / pipe (entry points only): fused schedules on
// `mma.sync.m16n8k16` fed by `ldmatrix`: a block puts a 64-row tile
// (normalised) into shared memory once and walks the 4C inner axis in
// chunks (32 wide at C=320, 16 at C=640): the chunk's W0 rows (a and g)
// and W2 columns are double-buffered in shared memory with `cp.async`
// (streamed from L2), GEMM1 makes the chunk's [a | g] in registers, the
// gate runs there in fp32, and GEMM2 adds into fp32 accumulators held in
// registers for the block's whole [64, C] output; the [rows, 8C]
// intermediate never reaches device memory. 8 warps, two per 16-row tile,
// each owning half of the output columns and half of each chunk's gate
// columns. Bound: tensor-core issue and the L2 reads of the weight tiles
// (each 64-row block reads all of W0 and W2: 64 FLOP per byte).
// - pipe (`ffn_pipe_kernel`): a two-stage software pipeline over the inner
//   axis. GEMM1 of chunk k+1 is issued before the gate and GEMM2 of chunk
//   k, so two chunks' [a | g] fragments are live in registers and the
//   gate's FP32 erf work has independent tensor-core work beside it in the
//   same warp; the W0 tiles are staged one chunk ahead of the W2 tiles, and
//   the last chunk drains after the loop. The TPU pipelined over row
//   blocks because VMEM held the whole [rows, 8C] intermediate; here the
//   price is registers (-Xptxas -v reports them).
// - ilv (`ffn_ilv_kernel`): row sub-tiles that never wait on one another.
//   Each 16-row sub-tile is a group of two warps that runs LN -> GEMM1 ->
//   gate -> GEMM2 on its own rows and synchronises only its own warps
//   (named barriers); a ninth, producer warp streams the weight chunks into
//   a two-stage ring of shared memory, signalled by mbarriers (full: its
//   cp.asyncs landed; empty: all eight consumer warps are done with the
//   stage). The groups drift out of phase, so one group's erf gate overlaps
//   another's tensor-core GEMMs: what the TPU's sub-block split was for.
// fp32 (composition checks, tests; plain variant only): the chunked
// schedule in plain FMA, 16 rows per block, exact fp32.
#include <algorithm>

#include "hopper.cuh"

using bf16 = __nv_bfloat16;

namespace {

constexpr float LN_EPS = 1e-5f;
constexpr int KC = 32;     // inner chunk of the fp32 path

__device__ __forceinline__ float gelu_erf(float g) {
  return 0.5f * g * (1.0f + erff(g * 0.70710678118654752f));
}
// the tanh form (variant "tanh") with tanhf, not tanh.approx: the form
// itself already sits ~3e-2 from erf after GEMM2 (geglu_ffn.py:176-184)
__device__ __forceinline__ float gelu_tanh(float g) {
  return 0.5f * g * (1.0f + tanhf(0.7978845608028654f * (g + 0.044715f * g * g * g)));
}
__device__ __forceinline__ float gelu_gate(float a, float g) { return a * gelu_erf(g); }
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
// the gate of the gate GEMM's epilogue: GELU 0 = erf (Abramowitz-Stegun),
// 1 = the tanh form
template <int GELU>
__device__ __forceinline__ float gate_of(float a, float g) {
  return a * (GELU == 1 ? gelu_tanh(g) : gelu_erf_as(g));
}

// LayerNorm of rows [row0, row0 + nrows) into dst (pitch ldx), zero past R.
template <typename T, typename TD, int C>
__device__ __forceinline__ void layer_norm_rows(TD* dst, int ldx, const T* __restrict__ x,
                                                const float* __restrict__ ls,
                                                const float* __restrict__ lb, long long row0,
                                                int nrows, long long R, int warp, int nwarps,
                                                int lane) {
  for (int r = warp; r < nrows; r += nwarps) {
    const long long row = row0 + r;
    if (row >= R) {
      for (int c = lane; c < C; c += 32) dst[r * ldx + c] = mofa::from_f32<TD>(0.0f);
      continue;
    }
    const T* xr = x + row * C;
    float s1 = 0.0f, s2 = 0.0f;
    for (int c = lane; c < C; c += 32) {
      const float v = mofa::to_f32(xr[c]);
      s1 += v;
      s2 += v * v;
    }
    s1 = mofa::warp_sum(s1);
    s2 = mofa::warp_sum(s2);
    const float mean = s1 / C;
    const float var = fmaxf(s2 / C - mean * mean, 0.0f);
    const float rstd = rsqrtf(var + LN_EPS);
    for (int c = lane; c < C; c += 32)
      dst[r * ldx + c] = mofa::from_f32<TD>((mofa::to_f32(xr[c]) - mean) * rstd * ls[c] + lb[c]);
  }
}

// A fragment (16x16) of a row-major bf16 tile at p (pitch ld)
__device__ __forceinline__ void load_a(uint32_t* a, const bf16* p, int ld, int lane) {
  mofa::ldsm_x4(a, p + (lane & 15) * ld + (lane >> 4) * 8);
}
// B fragments (k16 x n8, "col") of two n-tiles whose rows (n) start at
// row_lo and row_hi of a [n][k] row-major tile: r[0..1] and r[2..3]
__device__ __forceinline__ void load_b2(uint32_t* r, const bf16* p, int ld, int row_lo,
                                        int row_hi, int lane) {
  const int m = lane >> 3, i = lane & 7;
  mofa::ldsm_x4(r, p + ((m < 2 ? row_lo : row_hi) + i) * ld + (m & 1) * 8);
}

template <int C>
struct BfLayout {
  static constexpr int BR = 64;                    // rows per block
  static constexpr int KC = C <= 320 ? 32 : 16;    // inner chunk (shared memory)
  static constexpr int NCH = 4 * C / KC;           // chunks
  static constexpr int CG = 2;                     // warps sharing a 16-row tile
  static constexpr int NW = BR / 16 * CG;          // warps per block
  static constexpr int NC = C / CG;                // output columns per warp
  static constexpr int KW = KC / CG;               // gate columns per warp
  static constexpr int LDX = C + 8;                // bf16 pitch of LN(x), W0 tile
  static constexpr int LDA = KC + 8;               // bf16 pitch of gate, W2 tile
  static constexpr int W0T = 2 * KC * LDX;         // W0 tile elements
  static constexpr int W2T = C * LDA;              // W2 tile elements
  static constexpr size_t bytes = (size_t)(BR * LDX + 2 * W0T + 2 * W2T + BR * LDA) * 2;
  static_assert(KW % 8 == 0 && NC % 16 == 0, "mma n-tiles, in pairs");
  static_assert(bytes <= 232448, "fits one block's shared memory");
};

// The weight tiles of inner chunk [j0, j0 + KC), issued by threads tid of
// nt: W0's a and g rows into d0 [2KC][LDX], W2's columns into d2 [C][LDA].
template <int C>
__device__ __forceinline__ void stage_w0(bf16* d0, const bf16* __restrict__ w0, int j0, int tid,
                                         int nt) {
  using Lt = BfLayout<C>;
  for (int i = tid; i < 2 * Lt::KC * (C / 8); i += nt) {
    const int r = i / (C / 8), c = (i % (C / 8)) * 8;
    const int wrow = r < Lt::KC ? j0 + r : 4 * C + j0 + (r - Lt::KC);
    mofa::cp_async16(d0 + r * Lt::LDX + c, w0 + (long long)wrow * C + c);
  }
}
template <int C>
__device__ __forceinline__ void stage_w2(bf16* d2, const bf16* __restrict__ w2, int j0, int tid,
                                         int nt) {
  using Lt = BfLayout<C>;
  for (int i = tid; i < C * (Lt::KC / 8); i += nt) {
    const int r = i / (Lt::KC / 8), c = (i % (Lt::KC / 8)) * 8;
    mofa::cp_async16(d2 + r * Lt::LDA + c, w2 + (long long)r * 4 * C + j0 + c);
  }
}

// GEMM1 of one warp: its KW gate columns of a and g for the 16 rows at Xw,
// contraction over C, from the chunk's W0 tile
template <int C>
__device__ __forceinline__ void gemm1(float (&ha)[BfLayout<C>::KW / 8][4],
                                      float (&hg)[BfLayout<C>::KW / 8][4], const bf16* Xw,
                                      const bf16* W0t, int cg, int lane) {
  using Lt = BfLayout<C>;
  constexpr int KW = Lt::KW;
#pragma unroll
  for (int j = 0; j < KW / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) ha[j][e] = hg[j][e] = 0.0f;
#pragma unroll 4
  for (int kk = 0; kk < C / 16; ++kk) {
    uint32_t a[4];
    load_a(a, Xw + kk * 16, Lt::LDX, lane);
#pragma unroll
    for (int j = 0; j < KW / 8; ++j) {
      uint32_t b[4];                                // a-rows tile, g-rows tile
      const int row = cg * KW + j * 8;
      load_b2(b, W0t + kk * 16, Lt::LDX, row, Lt::KC + row, lane);
      mofa::mma_bf16(ha[j], a, b[0], b[1]);
      mofa::mma_bf16(hg[j], a, b[2], b[3]);
    }
  }
}

// gate = (a + b0a) * gelu(g + b0g) of one warp's fragments, as bf16 into
// the 16 rows at Aw (pitch LDA), columns of the chunk starting at j0
template <int C>
__device__ __forceinline__ void gate_store(const float (&ha)[BfLayout<C>::KW / 8][4],
                                           const float (&hg)[BfLayout<C>::KW / 8][4],
                                           const bf16* __restrict__ b0, int j0, bf16* Aw, int cg,
                                           int lane) {
  using Lt = BfLayout<C>;
  constexpr int LDA = Lt::LDA, I4 = 4 * C;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < Lt::KW / 8; ++j) {
    const int col = cg * Lt::KW + j * 8 + 2 * t;
    const float ba0 = __bfloat162float(b0[j0 + col]), ba1 = __bfloat162float(b0[j0 + col + 1]);
    const float bg0 = __bfloat162float(b0[I4 + j0 + col]);
    const float bg1 = __bfloat162float(b0[I4 + j0 + col + 1]);
    bf16* r0p = Aw + g * LDA + col;
    *reinterpret_cast<__nv_bfloat162*>(r0p) =
        __floats2bfloat162_rn(gelu_gate(ha[j][0] + ba0, hg[j][0] + bg0),
                              gelu_gate(ha[j][1] + ba1, hg[j][1] + bg1));
    *reinterpret_cast<__nv_bfloat162*>(r0p + 8 * LDA) =
        __floats2bfloat162_rn(gelu_gate(ha[j][2] + ba0, hg[j][2] + bg0),
                              gelu_gate(ha[j][3] + ba1, hg[j][3] + bg1));
  }
}

// GEMM2 of one warp: acc (16 x NC) += gate (the 16 rows at Aw, KC wide)
// times W2[this warp's output columns, chunk]^T
template <int C>
__device__ __forceinline__ void gemm2(float (&acc)[BfLayout<C>::NC / 8][4], const bf16* Aw,
                                      const bf16* W2t, int cg, int lane) {
  using Lt = BfLayout<C>;
  constexpr int NC = Lt::NC;
#pragma unroll
  for (int kk = 0; kk < Lt::KC / 16; ++kk) {
    uint32_t a[4];
    load_a(a, Aw + kk * 16, Lt::LDA, lane);
#pragma unroll
    for (int n = 0; n < NC / 8; n += 2) {
      uint32_t b[4];
      const int row = cg * NC + n * 8;
      load_b2(b, W2t + kk * 16, Lt::LDA, row, row + 8, lane);
      mofa::mma_bf16(acc[n], a, b[0], b[1]);
      mofa::mma_bf16(acc[n + 1], a, b[2], b[3]);
    }
  }
}

template <int C>
__device__ __forceinline__ void zero_acc(float (&acc)[BfLayout<C>::NC / 8][4]) {
#pragma unroll
  for (int n = 0; n < BfLayout<C>::NC / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.0f;
}

// epilogue of one warp: out rows [rbase, rbase + 16) = acc + b2 + x
template <int C>
__device__ __forceinline__ void store_out(const float (&acc)[BfLayout<C>::NC / 8][4],
                                          const bf16* __restrict__ b2, const bf16* __restrict__ x,
                                          bf16* __restrict__ out, long long rbase, long long R,
                                          int cg, int lane) {
  constexpr int NC = BfLayout<C>::NC;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int n = 0; n < NC / 8; ++n) {
    const int col = cg * NC + n * 8 + 2 * t;
    const float c0 = __bfloat162float(b2[col]), c1 = __bfloat162float(b2[col + 1]);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long long row = rbase + g + 8 * h;
      if (row < R) {
        const __nv_bfloat162 xr = *reinterpret_cast<const __nv_bfloat162*>(x + row * C + col);
        const float v0 = acc[n][2 * h] + c0 + __low2float(xr);
        const float v1 = acc[n][2 * h + 1] + c1 + __high2float(xr);
        *reinterpret_cast<__nv_bfloat162*>(out + row * C + col) = __floats2bfloat162_rn(v0, v1);
      }
    }
  }
}

// variant "pipe": GEMM1 of chunk k+1 before the gate and GEMM2 of chunk k.
// The W0 tiles run one chunk ahead of the W2 tiles: the commit group issued
// in iteration k holds W0(k+2) and W2(k+1).
template <int C>
__global__ void __launch_bounds__(BfLayout<C>::NW * 32, 1) ffn_pipe_kernel(
    const bf16* __restrict__ x, const float* __restrict__ ls, const float* __restrict__ lb,
    const bf16* __restrict__ w0, const bf16* __restrict__ b0, const bf16* __restrict__ w2,
    const bf16* __restrict__ b2, bf16* __restrict__ out, long long R) {
  using Lt = BfLayout<C>;
  constexpr int BR = Lt::BR, KC = Lt::KC, NW = Lt::NW, NT = NW * 32, NCH = Lt::NCH;
  constexpr int HW = Lt::KW / 8;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Xs = reinterpret_cast<bf16*>(smem);
  bf16* W0s = Xs + BR * Lt::LDX;
  bf16* W2s = W0s + 2 * Lt::W0T;
  bf16* As = W2s + 2 * Lt::W2T;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int rt = warp / Lt::CG, cg = warp % Lt::CG;
  const long long row0 = (long long)blockIdx.x * BR;
  auto stage = [&](int w0_chunk, int w2_chunk) {    // chunk indices past NCH: none
    if (w0_chunk < NCH)
      stage_w0<C>(W0s + (w0_chunk & 1) * Lt::W0T, w0, w0_chunk * KC, tid, NT);
    if (w2_chunk < NCH)
      stage_w2<C>(W2s + (w2_chunk & 1) * Lt::W2T, w2, w2_chunk * KC, tid, NT);
    mofa::cp_async_commit();
  };

  stage(0, NCH);                                    // W0(0)
  stage(1, 0);                                      // W0(1), W2(0)
  layer_norm_rows<bf16, bf16, C>(Xs, Lt::LDX, x, ls, lb, row0, BR, R, warp, NW, lane);
  float acc[Lt::NC / 8][4];
  zero_acc<C>(acc);
  const bf16* Xw = Xs + rt * 16 * Lt::LDX;
  bf16* Aw = As + rt * 16 * Lt::LDA;

  float ca[HW][4], cgt[HW][4], na[HW][4], ngt[HW][4];   // [a | g] of chunks k, k+1
  mofa::cp_async_wait<1>();
  __syncthreads();
  gemm1<C>(ca, cgt, Xw, W0s, cg, lane);             // prologue: GEMM1 of chunk 0
  for (int ch = 0; ch + 1 < NCH; ++ch) {
    __syncthreads();                                // every read of the refilled buffers done
    stage(ch + 2, ch + 1);
    mofa::cp_async_wait<1>();                       // W0(ch+1), W2(ch)
    __syncthreads();
    gemm1<C>(na, ngt, Xw, W0s + ((ch + 1) & 1) * Lt::W0T, cg, lane);
    gate_store<C>(ca, cgt, b0, ch * KC, Aw, cg, lane);
    __syncthreads();
    gemm2<C>(acc, Aw, W2s + (ch & 1) * Lt::W2T, cg, lane);
#pragma unroll
    for (int j = 0; j < HW; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) ca[j][e] = na[j][e], cgt[j][e] = ngt[j][e];
  }
  // the drain: the last chunk's gate and GEMM2
  mofa::cp_async_wait<0>();
  __syncthreads();
  gate_store<C>(ca, cgt, b0, (NCH - 1) * KC, Aw, cg, lane);
  __syncthreads();
  gemm2<C>(acc, Aw, W2s + ((NCH - 1) & 1) * Lt::W2T, cg, lane);
  store_out<C>(acc, b2, x, out, row0 + rt * 16, R, cg, lane);
}

// variant "ilv": BR / 16 row sub-tiles, each a group of CG warps that
// synchronises only itself, plus one producer warp filling a two-stage
// ring of weight tiles
template <int C>
struct IlvLayout {
  using Lt = BfLayout<C>;
  static constexpr int NT = (Lt::NW + 1) * 32;     // consumers + the producer warp
  static constexpr size_t base = (size_t)(Lt::BR * Lt::LDX + 2 * Lt::W0T + 2 * Lt::W2T) * 2;
  static constexpr size_t gate_bytes = (size_t)Lt::BR * Lt::LDA * 2;
  // two gate buffers per group (one group barrier per chunk) where they fit
  static constexpr int AB = base + 2 * gate_bytes + 32 <= 232448 ? 2 : 1;
  static constexpr size_t bars = base + AB * gate_bytes;   // full[2], empty[2]
  static constexpr size_t bytes = bars + 4 * 8;
  static_assert(bytes <= 232448, "fits one block's shared memory");
};

template <int C>
__global__ void __launch_bounds__(IlvLayout<C>::NT, 1) ffn_ilv_kernel(
    const bf16* __restrict__ x, const float* __restrict__ ls, const float* __restrict__ lb,
    const bf16* __restrict__ w0, const bf16* __restrict__ b0, const bf16* __restrict__ w2,
    const bf16* __restrict__ b2, bf16* __restrict__ out, long long R) {
  using Lt = BfLayout<C>;
  using Il = IlvLayout<C>;
  constexpr int BR = Lt::BR, KC = Lt::KC, CG = Lt::CG, NW = Lt::NW, NCH = Lt::NCH;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Xs = reinterpret_cast<bf16*>(smem);
  bf16* W0s = Xs + BR * Lt::LDX;
  bf16* W2s = W0s + 2 * Lt::W0T;
  bf16* As = W2s + 2 * Lt::W2T;                     // AB x [BR][LDA]
  const uint32_t full = mofa::smem_addr(smem + Il::bars), empty = full + 16;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const long long row0 = (long long)blockIdx.x * BR;
  if (tid == 0) {
    for (int s = 0; s < 2; ++s) {
      mofa::mbar_init(full + 8 * s, 32);            // one per producer lane
      mofa::mbar_init(empty + 8 * s, NW);           // one per consumer warp
    }
  }
  __syncthreads();                                  // the only block-wide barrier

  if (warp == NW) {                                 // producer
    for (int ch = 0; ch < NCH; ++ch) {
      const int s = ch & 1;
      if (ch >= 2) mofa::mbar_wait(empty + 8 * s, ((ch >> 1) - 1) & 1);
      stage_w0<C>(W0s + s * Lt::W0T, w0, ch * KC, lane, 32);
      stage_w2<C>(W2s + s * Lt::W2T, w2, ch * KC, lane, 32);
      mofa::cp_async_mbar_arrive(full + 8 * s);
    }
    mofa::cp_async_wait_all();
    return;
  }

  const int grp = warp / CG, cg = warp % CG;        // row sub-tile, column group
  const int bar_id = 1 + grp;                       // the group's named barrier
  const bf16* Xw = Xs + grp * 16 * Lt::LDX;
  layer_norm_rows<bf16, bf16, C>(Xs + grp * 16 * Lt::LDX, Lt::LDX, x, ls, lb, row0 + grp * 16,
                                 16, R, cg, CG, lane);
  mofa::named_bar_sync(bar_id, CG * 32);
  float acc[Lt::NC / 8][4];
  zero_acc<C>(acc);
  for (int ch = 0; ch < NCH; ++ch) {
    const int s = ch & 1;
    bf16* Aw = As + ((Il::AB == 2 ? s : 0) * BR + grp * 16) * Lt::LDA;
    mofa::mbar_wait(full + 8 * s, (ch >> 1) & 1);
    float ha[Lt::KW / 8][4], hg[Lt::KW / 8][4];
    gemm1<C>(ha, hg, Xw, W0s + s * Lt::W0T, cg, lane);
    if constexpr (Il::AB == 1) mofa::named_bar_sync(bar_id, CG * 32);  // last gate read
    gate_store<C>(ha, hg, b0, ch * KC, Aw, cg, lane);
    mofa::named_bar_sync(bar_id, CG * 32);
    gemm2<C>(acc, Aw, W2s + s * Lt::W2T, cg, lane);
    __syncwarp();
    if (lane == 0) mofa::mbar_arrive(empty + 8 * s);
  }
  store_out<C>(acc, b2, x, out, row0 + grp * 16, R, cg, lane);
}

constexpr int F32_BR = 16, F32_NT = 256;

template <int C>
__global__ void __launch_bounds__(F32_NT) ffn_f32_kernel(
    const float* __restrict__ x, const float* __restrict__ ls, const float* __restrict__ lb,
    const float* __restrict__ w0, const float* __restrict__ b0, const float* __restrict__ w2,
    const float* __restrict__ b2, float* __restrict__ out, long long R) {
  constexpr int I4 = 4 * C, NO = F32_BR * C / F32_NT;
  static_assert((F32_BR * C) % F32_NT == 0, "outputs must split evenly");
  __shared__ float Xs[F32_BR][C];
  __shared__ float Hs[F32_BR][2 * KC];
  __shared__ float As[F32_BR][KC];
  const int tid = threadIdx.x;
  const long long row0 = (long long)blockIdx.x * F32_BR;
  layer_norm_rows<float, float, C>(&Xs[0][0], C, x, ls, lb, row0, F32_BR, R, tid / 32,
                                   F32_NT / 32, tid % 32);
  __syncthreads();
  float acc[NO];
#pragma unroll
  for (int i = 0; i < NO; ++i) acc[i] = 0.0f;

  for (int j0 = 0; j0 < I4; j0 += KC) {
    for (int o = tid; o < F32_BR * 2 * KC; o += F32_NT) {
      const int r = o / (2 * KC), j = o % (2 * KC);
      const int wrow = j < KC ? j0 + j : I4 + j0 + (j - KC);
      const float* wr = w0 + (long long)wrow * C;
      float s = 0.0f;
      for (int c = 0; c < C; ++c) s = fmaf(Xs[r][c], wr[c], s);
      Hs[r][j] = s + b0[wrow];
    }
    __syncthreads();
    for (int o = tid; o < F32_BR * KC; o += F32_NT) {
      const int r = o / KC, j = o % KC;
      As[r][j] = gelu_gate(Hs[r][j], Hs[r][KC + j]);
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < NO; ++i) {
      const int o = tid + F32_NT * i;
      const int r = o / C, col = o % C;
      const float* wr = w2 + (long long)col * I4 + j0;
      float s = acc[i];
#pragma unroll 8
      for (int j = 0; j < KC; ++j) s = fmaf(As[r][j], wr[j], s);
      acc[i] = s;
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < NO; ++i) {
    const int o = tid + F32_NT * i;
    const int r = o / C, col = o % C;
    const long long row = row0 + r;
    if (row < R) out[row * C + col] = acc[i] + b2[col] + x[row * C + col];
  }
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

// ---- host: launches

template <typename Kernel>
int launch_fused(Kernel kernel, int threads, size_t bytes, const void* x, const void* ls,
                 const void* lb, const void* w0, const void* b0, const void* w2,
                 const void* b2, void* out, long long R, cudaStream_t st) {
  if (R <= 0) return (int)cudaGetLastError();
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  const long long blocks = (R + 63) / 64;           // BfLayout::BR rows per block
  kernel<<<(unsigned)blocks, threads, bytes, st>>>(
      (const bf16*)x, (const float*)ls, (const float*)lb, (const bf16*)w0, (const bf16*)b0,
      (const bf16*)w2, (const bf16*)b2, (bf16*)out, R);
  return (int)cudaGetLastError();
}

enum Variant { kPipe, kIlv };

template <int C>
int launch_variant(Variant v, const void* x, const void* ls, const void* lb, const void* w0,
                   const void* b0, const void* w2, const void* b2, void* out, long long R,
                   cudaStream_t st) {
  using Lt = BfLayout<C>;
  if (v == kPipe)
    return launch_fused(ffn_pipe_kernel<C>, Lt::NW * 32, Lt::bytes, x, ls, lb, w0, b0, w2, b2,
                        out, R, st);
  return launch_fused(ffn_ilv_kernel<C>, IlvLayout<C>::NT, IlvLayout<C>::bytes, x, ls, lb, w0,
                      b0, w2, b2, out, R, st);
}

int launch_fused_variant(Variant v, const void* x, const void* ls, const void* lb,
                         const void* w0, const void* b0, const void* w2, const void* b2,
                         void* out, int R, int C, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (C == 320) return launch_variant<320>(v, x, ls, lb, w0, b0, w2, b2, out, R, st);
  if (C == 640) return launch_variant<640>(v, x, ls, lb, w0, b0, w2, b2, out, R, st);
  return (int)cudaErrorInvalidValue;
}

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

template <int C>
int launch_gate(const void* xn, const void* w0, const void* b0, void* h, int R, int gelu,
                cudaStream_t st) {
  if (gelu == 0) return launch_gemm<C, true, 0, false>(xn, w0, b0, nullptr, h, R, st);
  if (gelu == 1) return launch_gemm<C, true, 1, false>(xn, w0, b0, nullptr, h, R, st);
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
               cudaStream_t st) {
  const bool ln = ls != nullptr;
  int err = ln ? launch_ln_rows<C>(x, ls, lb, xn, R, st) : 0;
  if (err == 0) err = launch_gate<C>(ln ? xn : x, w0, b0, h, R, gelu, st);
  if (err == 0) err = launch_out<C>(h, w2, b2, ln ? x : nullptr, out, R, st);
  return err;
}

template <int C>
int launch_f32(const void* x, const void* ls, const void* lb, const void* w0, const void* b0,
               const void* w2, const void* b2, void* out, long long R, cudaStream_t st) {
  if (R <= 0) return (int)cudaGetLastError();
  const long long blocks = (R + F32_BR - 1) / F32_BR;
  ffn_f32_kernel<C><<<(unsigned)blocks, F32_NT, 0, st>>>(
      (const float*)x, (const float*)ls, (const float*)lb, (const float*)w0,
      (const float*)b0, (const float*)w2, (const float*)b2, (float*)out, R);
  return (int)cudaGetLastError();
}

}  // namespace

// Arguments of every entry: x/out [R, C]; ls/lb [C] fp32; w0 [8C, C], b0
// [8C], w2 [C, 4C], b2 [C] in x's dtype; scratch xn [R, C] and h [R, 4C]
// in x's dtype (bf16 only); all contiguous and 32-byte aligned. C in
// {320, 640}; dtype 0 = fp32, 1 = bf16; gelu 0 = erf, 1 = tanh (bf16
// only).
extern "C" int mofa_ln_geglu_ffn(const void* x, const void* ls, const void* lb,
                                 const void* w0, const void* b0, const void* w2,
                                 const void* b2, void* xn, void* h, void* out, int R, int C,
                                 int dtype, int gelu, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (ls == nullptr || lb == nullptr) return (int)cudaErrorInvalidValue;
  if (dtype == mofa::kBF16) {
    if (C == 320)
      return launch_ffn<320>(x, ls, lb, w0, b0, w2, b2, xn, h, out, R, gelu, st);
    if (C == 640)
      return launch_ffn<640>(x, ls, lb, w0, b0, w2, b2, xn, h, out, R, gelu, st);
  } else if (dtype == mofa::kF32 && gelu == 0) {
    if (C == 320) return launch_f32<320>(x, ls, lb, w0, b0, w2, b2, out, R, st);
    if (C == 640) return launch_f32<640>(x, ls, lb, w0, b0, w2, b2, out, R, st);
  }
  return (int)cudaErrorInvalidValue;
}

// geglu_ffn: out = GEGLU-FF(x), no LayerNorm, no residual; bf16 only.
extern "C" int mofa_geglu_ffn(const void* x, const void* w0, const void* b0, const void* w2,
                              const void* b2, void* h, void* out, int R, int C, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (C == 320)
    return launch_ffn<320>(x, nullptr, nullptr, w0, b0, w2, b2, nullptr, h, out, R, 0,
                           st);
  if (C == 640)
    return launch_ffn<640>(x, nullptr, nullptr, w0, b0, w2, b2, nullptr, h, out, R, 0,
                           st);
  return (int)cudaErrorInvalidValue;
}

// The stages one at a time (bf16): xn = LN(x); h = gate(xn W0^T + b0);
// out = h W2^T + b2 (+ resid, which may be null).
extern "C" int mofa_ffn_ln_rows(const void* x, const void* ls, const void* lb, void* xn, int R,
                                int C, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (C == 320) return launch_ln_rows<320>(x, ls, lb, xn, R, st);
  if (C == 640) return launch_ln_rows<640>(x, ls, lb, xn, R, st);
  return (int)cudaErrorInvalidValue;
}
extern "C" int mofa_ffn_gemm_gate(const void* xn, const void* w0, const void* b0, void* h, int R,
                                  int C, int gelu, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (C == 320) return launch_gate<320>(xn, w0, b0, h, R, gelu, st);
  if (C == 640) return launch_gate<640>(xn, w0, b0, h, R, gelu, st);
  return (int)cudaErrorInvalidValue;
}
extern "C" int mofa_ffn_gemm_out(const void* h, const void* w2, const void* b2,
                                 const void* resid, void* out, int R, int C, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (C == 320) return launch_out<320>(h, w2, b2, resid, out, R, st);
  if (C == 640) return launch_out<640>(h, w2, b2, resid, out, R, st);
  return (int)cudaErrorInvalidValue;
}

// The fused schedules, bf16 only, arguments as mofa_ln_geglu_ffn without
// the scratch, dtype and gelu.
extern "C" int mofa_ln_geglu_ffn_pipe(const void* x, const void* ls, const void* lb,
                                      const void* w0, const void* b0, const void* w2,
                                      const void* b2, void* out, int R, int C, void* stream) {
  return launch_fused_variant(kPipe, x, ls, lb, w0, b0, w2, b2, out, R, C, stream);
}
extern "C" int mofa_ln_geglu_ffn_ilv(const void* x, const void* ls, const void* lb,
                                     const void* w0, const void* b0, const void* w2,
                                     const void* b2, void* out, int R, int C, void* stream) {
  return launch_fused_variant(kIlv, x, ls, lb, w0, b0, w2, b2, out, R, C, stream);
}
