// Fused LayerNorm -> GEGLU feed-forward -> residual:
//   out = x + (a * gelu_erf(g)) W2^T + b2,  [a | g] = LN(x) W0^T + b0,
// with C -> 8C -> 4C -> C (torch Linear layouts: W0 [8C, C], W2 [C, 4C]).
//
// Replaces mofa_tpu/kernels/geglu_ffn.py::_ln_ffn_kernel (variant "plain").
// The TPU kernel holds both weight matrices and the whole [rows, 8C]
// intermediate in VMEM; a Hopper block has 227 KB of shared memory, and W0
// alone is 6.5 MB at C=640, so here a block normalises a 64-row tile into
// shared memory once and then walks the 4C inner axis in chunks (32 wide
// at C=320, 16 at C=640): the chunk's W0 rows (a and g) and W2 columns are
// double-buffered in shared memory with `cp.async` (streamed from L2,
// where both matrices stay resident; the next chunk loads during this
// one's math), GEMM1 makes the chunk's [a | g] in registers, the exact erf
// gelu gate runs there in fp32 (erff; the TPU's polynomial exists only
// because Mosaic has no erf), and GEMM2 adds into fp32 accumulators held
// in registers for the block's whole [64, C] output, added to the bias
// and the residual at the end. The [rows, 8C] intermediate never reaches
// device memory.
//
// bf16 path (the main path): `mma.sync.m16n8k16` tensor cores fed by
// `ldmatrix`, bf16 in, fp32 accumulate; 8 warps, two per 16-row tile,
// each owning half of the output columns and half of each chunk's gate
// columns. Bound: tensor-core
// issue and the L2 reads of the weight tiles (each 64-row block reads all
// of W0 and W2 once: 64 FLOP per byte).
// fp32 path (composition checks, tests): the same chunked schedule in
// plain FMA, 16 rows per block, exact fp32.
#include "common.cuh"

using bf16 = __nv_bfloat16;

namespace {

constexpr float LN_EPS = 1e-5f;
constexpr int KC = 32;     // inner chunk of the fp32 path

__device__ __forceinline__ float gelu_gate(float a, float g) {
  return a * (0.5f * g * (1.0f + erff(g * 0.70710678118654752f)));
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

template <int C>
__global__ void __launch_bounds__(BfLayout<C>::NW * 32, 1) ffn_bf16_kernel(
    const bf16* __restrict__ x, const float* __restrict__ ls, const float* __restrict__ lb,
    const bf16* __restrict__ w0, const bf16* __restrict__ b0, const bf16* __restrict__ w2,
    const bf16* __restrict__ b2, bf16* __restrict__ out, long long R) {
  using Lt = BfLayout<C>;
  constexpr int BR = Lt::BR, KC = Lt::KC, CG = Lt::CG, NW = Lt::NW, NT = NW * 32,
                NC = Lt::NC, KW = Lt::KW, LDX = Lt::LDX, LDA = Lt::LDA, I4 = 4 * C;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Xs = reinterpret_cast<bf16*>(smem);        // [BR][LDX]
  bf16* W0s = Xs + BR * LDX;                        // 2 x [2KC][LDX]: a rows, g rows
  bf16* W2s = W0s + 2 * Lt::W0T;                    // 2 x [C][LDA]: W2[:, chunk]
  bf16* As = W2s + 2 * Lt::W2T;                     // [BR][LDA]: the gate

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t = lane & 3;
  const int rt = warp / CG, cg = warp % CG;         // row tile, column group
  const long long row0 = (long long)blockIdx.x * BR;

  auto stage = [&](int buf, int j0) {               // weight tiles of one chunk
    bf16* d0 = W0s + buf * Lt::W0T;
    for (int i = tid; i < 2 * KC * (C / 8); i += NT) {
      const int r = i / (C / 8), c = (i % (C / 8)) * 8;
      const int wrow = r < KC ? j0 + r : I4 + j0 + (r - KC);
      mofa::cp_async16(d0 + r * LDX + c, w0 + (long long)wrow * C + c);
    }
    bf16* d2 = W2s + buf * Lt::W2T;
    for (int i = tid; i < C * (KC / 8); i += NT) {
      const int r = i / (KC / 8), c = (i % (KC / 8)) * 8;
      mofa::cp_async16(d2 + r * LDA + c, w2 + (long long)r * I4 + j0 + c);
    }
    mofa::cp_async_commit();
  };

  stage(0, 0);
  layer_norm_rows<bf16, bf16, C>(Xs, LDX, x, ls, lb, row0, BR, R, warp, NW, lane);

  float acc[NC / 8][4];                             // out tile 16 x NC, fp32
#pragma unroll
  for (int n = 0; n < NC / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.0f;
  const bf16* Xw = Xs + rt * 16 * LDX;

  constexpr int NCH = I4 / KC;
  for (int ch = 0; ch < NCH; ++ch) {
    const int buf = ch & 1, j0 = ch * KC;
    if (ch + 1 < NCH) {
      stage(buf ^ 1, j0 + KC);
      mofa::cp_async_wait<1>();
    } else {
      mofa::cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* W0t = W0s + buf * Lt::W0T;
    const bf16* W2t = W2s + buf * Lt::W2T;

    // GEMM1: this warp's KW gate columns of a and g, contraction over C
    float ha[KW / 8][4], hg[KW / 8][4];
#pragma unroll
    for (int j = 0; j < KW / 8; ++j)
      ha[j][0] = ha[j][1] = ha[j][2] = ha[j][3] = hg[j][0] = hg[j][1] = hg[j][2] =
          hg[j][3] = 0.0f;
#pragma unroll 4
    for (int kk = 0; kk < C / 16; ++kk) {
      uint32_t a[4];
      load_a(a, Xw + kk * 16, LDX, lane);
#pragma unroll
      for (int j = 0; j < KW / 8; ++j) {
        uint32_t b[4];                              // a-rows tile, g-rows tile
        const int row = cg * KW + j * 8;
        load_b2(b, W0t + kk * 16, LDX, row, KC + row, lane);
        mofa::mma_bf16(ha[j], a, b[0], b[1]);
        mofa::mma_bf16(hg[j], a, b[2], b[3]);
      }
    }
    // gate = (a + b0a) * gelu(g + b0g), into shared memory as bf16
#pragma unroll
    for (int j = 0; j < KW / 8; ++j) {
      const int col = cg * KW + j * 8 + 2 * t;
      const float ba0 = __bfloat162float(b0[j0 + col]), ba1 = __bfloat162float(b0[j0 + col + 1]);
      const float bg0 = __bfloat162float(b0[I4 + j0 + col]);
      const float bg1 = __bfloat162float(b0[I4 + j0 + col + 1]);
      bf16* r0p = As + (rt * 16 + g) * LDA + col;
      *reinterpret_cast<__nv_bfloat162*>(r0p) = __floats2bfloat162_rn(
          gelu_gate(ha[j][0] + ba0, hg[j][0] + bg0), gelu_gate(ha[j][1] + ba1, hg[j][1] + bg1));
      *reinterpret_cast<__nv_bfloat162*>(r0p + 8 * LDA) = __floats2bfloat162_rn(
          gelu_gate(ha[j][2] + ba0, hg[j][2] + bg0), gelu_gate(ha[j][3] + ba1, hg[j][3] + bg1));
    }
    __syncthreads();

    // GEMM2: out (16 x NC) += gate (16 x KC) W2[cg cols, chunk]^T
#pragma unroll
    for (int kk = 0; kk < KC / 16; ++kk) {
      uint32_t a[4];
      load_a(a, As + rt * 16 * LDA + kk * 16, LDA, lane);
#pragma unroll
      for (int n = 0; n < NC / 8; n += 2) {
        uint32_t b[4];
        const int row = cg * NC + n * 8;
        load_b2(b, W2t + kk * 16, LDA, row, row + 8, lane);
        mofa::mma_bf16(acc[n], a, b[0], b[1]);
        mofa::mma_bf16(acc[n + 1], a, b[2], b[3]);
      }
    }
    __syncthreads();                                // buffers are refilled next
  }

  // epilogue: + b2 + residual
#pragma unroll
  for (int n = 0; n < NC / 8; ++n) {
    const int col = cg * NC + n * 8 + 2 * t;
    const float c0 = __bfloat162float(b2[col]), c1 = __bfloat162float(b2[col + 1]);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long long row = row0 + rt * 16 + g + 8 * h;
      if (row < R) {
        const __nv_bfloat162 xr = *reinterpret_cast<const __nv_bfloat162*>(x + row * C + col);
        *reinterpret_cast<__nv_bfloat162*>(out + row * C + col) = __floats2bfloat162_rn(
            acc[n][2 * h] + c0 + __low2float(xr), acc[n][2 * h + 1] + c1 + __high2float(xr));
      }
    }
  }
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

template <int C>
int launch_bf16(const void* x, const void* ls, const void* lb, const void* w0, const void* b0,
                const void* w2, const void* b2, void* out, long long R, cudaStream_t st) {
  using Lt = BfLayout<C>;
  cudaFuncSetAttribute(ffn_bf16_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)Lt::bytes);
  const long long blocks = (R + Lt::BR - 1) / Lt::BR;
  ffn_bf16_kernel<C><<<(unsigned)blocks, Lt::NW * 32, Lt::bytes, st>>>(
      (const bf16*)x, (const float*)ls, (const float*)lb, (const bf16*)w0, (const bf16*)b0,
      (const bf16*)w2, (const bf16*)b2, (bf16*)out, R);
  return (int)cudaGetLastError();
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
  cudaStream_t st = (cudaStream_t)stream;
  if (R <= 0) return (int)cudaGetLastError();
  if (dtype == mofa::kBF16) {
    if (C == 320) return launch_bf16<320>(x, ls, lb, w0, b0, w2, b2, out, R, st);
    if (C == 640) return launch_bf16<640>(x, ls, lb, w0, b0, w2, b2, out, R, st);
  } else if (dtype == mofa::kF32) {
    if (C == 320) return launch_f32<320>(x, ls, lb, w0, b0, w2, b2, out, R, st);
    if (C == 640) return launch_f32<640>(x, ls, lb, w0, b0, w2, b2, out, R, st);
  }
  return (int)cudaErrorInvalidValue;
}
