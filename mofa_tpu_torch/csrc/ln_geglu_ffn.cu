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
// shared memory, and W0 alone is 6.5 MB at C=640, so here a block puts a
// 64-row tile (normalised, or as it is for geglu_ffn) into shared memory
// once and then walks the 4C inner axis in chunks (32 wide at C=320, 16 at
// C=640): the chunk's W0 rows (a and g) and W2 columns are double-buffered
// in shared memory with `cp.async` (streamed from L2, where both matrices
// stay resident), GEMM1 makes the chunk's [a | g] in registers, the gelu
// gate runs there in fp32 (erff; the TPU's polynomial exists only because
// Mosaic has no erf), and GEMM2 adds into fp32 accumulators held in
// registers for the block's whole [64, C] output, added to the bias (and
// the residual) at the end. The [rows, 8C] intermediate never reaches
// device memory.
//
// bf16 (the main path): `mma.sync.m16n8k16` tensor cores fed by
// `ldmatrix`, bf16 in, fp32 accumulate; 8 warps, two per 16-row tile, each
// owning half of the output columns and half of each chunk's gate columns.
// Bound: tensor-core issue and the L2 reads of the weight tiles (each
// 64-row block reads all of W0 and W2 once: 64 FLOP per byte). Schedules:
// - plain / tanh / geglu_ffn (`ffn_bf16_kernel`): per chunk, GEMM1 -> gate
//   -> GEMM2, three block barriers. The LN stage, the residual and the
//   tanh gate are compile-time flags of the one kernel.
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
// fp32 (composition checks, tests; plain variant only): the same chunked
// schedule in plain FMA, 16 rows per block, exact fp32.
#include "common.cuh"

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
template <bool TANH>
__device__ __forceinline__ float gelu_gate(float a, float g) {
  return a * (TANH ? gelu_tanh(g) : gelu_erf(g));
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

// Rows [row0, row0 + nrows) of bf16 x copied into dst (pitch ldx), zero past R.
template <int C>
__device__ __forceinline__ void copy_rows(bf16* dst, int ldx, const bf16* __restrict__ x,
                                          long long row0, int nrows, long long R, int warp,
                                          int nwarps, int lane) {
  for (int r = warp; r < nrows; r += nwarps) {
    const long long row = row0 + r;
    for (int c = lane * 8; c < C; c += 256) {
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (row < R) v = *reinterpret_cast<const uint4*>(x + row * C + c);
      *reinterpret_cast<uint4*>(dst + r * ldx + c) = v;
    }
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
template <int C, bool TANH>
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
        __floats2bfloat162_rn(gelu_gate<TANH>(ha[j][0] + ba0, hg[j][0] + bg0),
                              gelu_gate<TANH>(ha[j][1] + ba1, hg[j][1] + bg1));
    *reinterpret_cast<__nv_bfloat162*>(r0p + 8 * LDA) =
        __floats2bfloat162_rn(gelu_gate<TANH>(ha[j][2] + ba0, hg[j][2] + bg0),
                              gelu_gate<TANH>(ha[j][3] + ba1, hg[j][3] + bg1));
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

// epilogue of one warp: out rows [rbase, rbase + 16) = acc + b2 (+ x)
template <int C, bool RESID>
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
        float v0 = acc[n][2 * h] + c0, v1 = acc[n][2 * h + 1] + c1;
        if constexpr (RESID) {
          const __nv_bfloat162 xr = *reinterpret_cast<const __nv_bfloat162*>(x + row * C + col);
          v0 += __low2float(xr);
          v1 += __high2float(xr);
        }
        *reinterpret_cast<__nv_bfloat162*>(out + row * C + col) = __floats2bfloat162_rn(v0, v1);
      }
    }
  }
}

// plain / tanh (LN, RESID) and geglu_ffn (neither): GEMM1 -> gate -> GEMM2
// per chunk, the whole block in step
template <int C, bool LN, bool RESID, bool TANH>
__global__ void __launch_bounds__(BfLayout<C>::NW * 32, 1) ffn_bf16_kernel(
    const bf16* __restrict__ x, const float* __restrict__ ls, const float* __restrict__ lb,
    const bf16* __restrict__ w0, const bf16* __restrict__ b0, const bf16* __restrict__ w2,
    const bf16* __restrict__ b2, bf16* __restrict__ out, long long R) {
  using Lt = BfLayout<C>;
  constexpr int BR = Lt::BR, KC = Lt::KC, NW = Lt::NW, NT = NW * 32, NCH = Lt::NCH;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Xs = reinterpret_cast<bf16*>(smem);        // [BR][LDX]: LN(x) or x
  bf16* W0s = Xs + BR * Lt::LDX;                    // 2 x [2KC][LDX]: a rows, g rows
  bf16* W2s = W0s + 2 * Lt::W0T;                    // 2 x [C][LDA]: W2[:, chunk]
  bf16* As = W2s + 2 * Lt::W2T;                     // [BR][LDA]: the gate

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int rt = warp / Lt::CG, cg = warp % Lt::CG;  // row tile, column group
  const long long row0 = (long long)blockIdx.x * BR;
  auto stage = [&](int buf, int j0) {
    stage_w0<C>(W0s + buf * Lt::W0T, w0, j0, tid, NT);
    stage_w2<C>(W2s + buf * Lt::W2T, w2, j0, tid, NT);
    mofa::cp_async_commit();
  };

  stage(0, 0);
  if constexpr (LN)
    layer_norm_rows<bf16, bf16, C>(Xs, Lt::LDX, x, ls, lb, row0, BR, R, warp, NW, lane);
  else
    copy_rows<C>(Xs, Lt::LDX, x, row0, BR, R, warp, NW, lane);

  float acc[Lt::NC / 8][4];                         // out tile 16 x NC, fp32
  zero_acc<C>(acc);
  const bf16* Xw = Xs + rt * 16 * Lt::LDX;
  bf16* Aw = As + rt * 16 * Lt::LDA;
  for (int ch = 0; ch < NCH; ++ch) {
    const int buf = ch & 1;
    if (ch + 1 < NCH) {
      stage(buf ^ 1, (ch + 1) * KC);
      mofa::cp_async_wait<1>();
    } else {
      mofa::cp_async_wait<0>();
    }
    __syncthreads();
    float ha[Lt::KW / 8][4], hg[Lt::KW / 8][4];
    gemm1<C>(ha, hg, Xw, W0s + buf * Lt::W0T, cg, lane);
    gate_store<C, TANH>(ha, hg, b0, ch * KC, Aw, cg, lane);
    __syncthreads();
    gemm2<C>(acc, Aw, W2s + buf * Lt::W2T, cg, lane);
    __syncthreads();                                // buffers are refilled next
  }
  store_out<C, RESID>(acc, b2, x, out, row0 + rt * 16, R, cg, lane);
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
    gate_store<C, false>(ca, cgt, b0, ch * KC, Aw, cg, lane);
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
  gate_store<C, false>(ca, cgt, b0, (NCH - 1) * KC, Aw, cg, lane);
  __syncthreads();
  gemm2<C>(acc, Aw, W2s + ((NCH - 1) & 1) * Lt::W2T, cg, lane);
  store_out<C, true>(acc, b2, x, out, row0 + rt * 16, R, cg, lane);
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
    gate_store<C, false>(ha, hg, b0, ch * KC, Aw, cg, lane);
    mofa::named_bar_sync(bar_id, CG * 32);
    gemm2<C>(acc, Aw, W2s + s * Lt::W2T, cg, lane);
    __syncwarp();
    if (lane == 0) mofa::mbar_arrive(empty + 8 * s);
  }
  store_out<C, true>(acc, b2, x, out, row0 + grp * 16, R, cg, lane);
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
      As[r][j] = gelu_gate<false>(Hs[r][j], Hs[r][KC + j]);
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

template <typename Kernel>
int launch_bf16(Kernel kernel, int threads, size_t bytes, const void* x, const void* ls,
                const void* lb, const void* w0, const void* b0, const void* w2, const void* b2,
                void* out, long long R, cudaStream_t st) {
  if (R <= 0) return (int)cudaGetLastError();
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  const long long blocks = (R + 63) / 64;           // BfLayout::BR rows per block
  kernel<<<(unsigned)blocks, threads, bytes, st>>>(
      (const bf16*)x, (const float*)ls, (const float*)lb, (const bf16*)w0, (const bf16*)b0,
      (const bf16*)w2, (const bf16*)b2, (bf16*)out, R);
  return (int)cudaGetLastError();
}

enum Variant { kPlain, kTanh, kGeglu, kPipe, kIlv };

template <int C>
int launch_variant(Variant v, const void* x, const void* ls, const void* lb, const void* w0,
                   const void* b0, const void* w2, const void* b2, void* out, long long R,
                   cudaStream_t st) {
  using Lt = BfLayout<C>;
  constexpr int NT = Lt::NW * 32;
  switch (v) {
    case kPlain:
      return launch_bf16(ffn_bf16_kernel<C, true, true, false>, NT, Lt::bytes, x, ls, lb, w0,
                         b0, w2, b2, out, R, st);
    case kTanh:
      return launch_bf16(ffn_bf16_kernel<C, true, true, true>, NT, Lt::bytes, x, ls, lb, w0, b0,
                         w2, b2, out, R, st);
    case kGeglu:
      return launch_bf16(ffn_bf16_kernel<C, false, false, false>, NT, Lt::bytes, x, ls, lb, w0,
                         b0, w2, b2, out, R, st);
    case kPipe:
      return launch_bf16(ffn_pipe_kernel<C>, NT, Lt::bytes, x, ls, lb, w0, b0, w2, b2, out, R,
                         st);
    case kIlv:
      return launch_bf16(ffn_ilv_kernel<C>, IlvLayout<C>::NT, IlvLayout<C>::bytes, x, ls, lb,
                         w0, b0, w2, b2, out, R, st);
  }
  return (int)cudaErrorInvalidValue;
}

int launch_bf16_variant(Variant v, const void* x, const void* ls, const void* lb,
                        const void* w0, const void* b0, const void* w2, const void* b2,
                        void* out, int R, int C, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (C == 320) return launch_variant<320>(v, x, ls, lb, w0, b0, w2, b2, out, R, st);
  if (C == 640) return launch_variant<640>(v, x, ls, lb, w0, b0, w2, b2, out, R, st);
  return (int)cudaErrorInvalidValue;
}

template <int C>
int launch_f32(const void* x, const void* ls, const void* lb, const void* w0, const void* b0,
               const void* w2, const void* b2, void* out, long long R, cudaStream_t st) {
  const long long blocks = (R + F32_BR - 1) / F32_BR;
  ffn_f32_kernel<C><<<(unsigned)blocks, F32_NT, 0, st>>>(
      (const float*)x, (const float*)ls, (const float*)lb, (const float*)w0,
      (const float*)b0, (const float*)w2, (const float*)b2, (float*)out, R);
  return (int)cudaGetLastError();
}

}  // namespace

// x/out [R, C]; ls/lb [C] fp32; w0 [8C, C], b0 [8C], w2 [C, 4C], b2 [C] in x's
// dtype; all contiguous and 32-byte aligned. C in {320, 640}; dtype 0 = fp32,
// 1 = bf16.
extern "C" int mofa_ln_geglu_ffn(const void* x, const void* ls, const void* lb,
                                 const void* w0, const void* b0, const void* w2,
                                 const void* b2, void* out, int R, int C, int dtype,
                                 void* stream) {
  if (dtype == mofa::kBF16)
    return launch_bf16_variant(kPlain, x, ls, lb, w0, b0, w2, b2, out, R, C, stream);
  if (dtype == mofa::kF32) {
    cudaStream_t st = (cudaStream_t)stream;
    if (R <= 0) return (int)cudaGetLastError();
    if (C == 320) return launch_f32<320>(x, ls, lb, w0, b0, w2, b2, out, R, st);
    if (C == 640) return launch_f32<640>(x, ls, lb, w0, b0, w2, b2, out, R, st);
  }
  return (int)cudaErrorInvalidValue;
}

// The variants, bf16 only, arguments as mofa_ln_geglu_ffn without dtype.
extern "C" int mofa_ln_geglu_ffn_tanh(const void* x, const void* ls, const void* lb,
                                      const void* w0, const void* b0, const void* w2,
                                      const void* b2, void* out, int R, int C, void* stream) {
  return launch_bf16_variant(kTanh, x, ls, lb, w0, b0, w2, b2, out, R, C, stream);
}
extern "C" int mofa_ln_geglu_ffn_pipe(const void* x, const void* ls, const void* lb,
                                      const void* w0, const void* b0, const void* w2,
                                      const void* b2, void* out, int R, int C, void* stream) {
  return launch_bf16_variant(kPipe, x, ls, lb, w0, b0, w2, b2, out, R, C, stream);
}
extern "C" int mofa_ln_geglu_ffn_ilv(const void* x, const void* ls, const void* lb,
                                     const void* w0, const void* b0, const void* w2,
                                     const void* b2, void* out, int R, int C, void* stream) {
  return launch_bf16_variant(kIlv, x, ls, lb, w0, b0, w2, b2, out, R, C, stream);
}

// geglu_ffn: out = GEGLU-FF(x), no LayerNorm, no residual; bf16 only.
extern "C" int mofa_geglu_ffn(const void* x, const void* w0, const void* b0, const void* w2,
                              const void* b2, void* out, int R, int C, void* stream) {
  return launch_bf16_variant(kGeglu, x, nullptr, nullptr, w0, b0, w2, b2, out, R, C, stream);
}
