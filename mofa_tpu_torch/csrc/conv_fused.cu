// Fused GroupNorm-apply + SiLU + temporal convolution, channel-last, bf16:
//   out = conv_(3 over T)(silu(x * a + b)) + bias [+ temb] [+ residual]
// with a, b the folded GroupNorm affine per (b, c), and optionally the fp32
// sums of out and out^2 per (b, o) (before the cast), for the next norm.
//
// Replaces mofa_tpu/kernels/conv_fused.py::_fused_tconv_fwd (x [B, T, S,
// C], 3 taps over T). The TPU kernel holds one video's whole [T, S, C]
// slice in VMEM and runs 3 shifted [rows, C] x [C, O] matmuls on an
// activated strip; a Hopper block has 227 KB of shared memory and many
// blocks run at once, so here the conv is one implicit GEMM per video: M =
// output pixels, N = O, K = 3 taps x C. The output pixels are a T x S grid
// (rows R = T, columns Q = S); the 3 taps are rows, S*C elements apart.
// (The 3x3 spatial conv is conv3x3.cu.)
//
// A block computes a 128-pixel output tile, rb = 4 frames x qb = 32
// positions of the grid, for 64 output channels. For each chunk of 32 input
// channels it stages the tile's input WINDOW, (rb + 2) x qb pixels, into
// shared memory once: each thread loads its 16-byte pieces of x into
// registers one chunk ahead, applies the affine and SiLU in fp32 and
// stores bf16. Every tap then reads its shifted view of the window: the
// `ldmatrix` row address of output pixel (r, q) under tap dt is window
// pixel (r + dt, q). Applied per tap instead, the affine and SiLU would run
// 3x per input value and bound the kernel by that arithmetic, not by the
// tensor cores. THE TRAP: the conv's zero padding applies to the ACTIVATED
// tensor, so a window frame outside the video stores 0, not silu(b). The
// weight tile of each (chunk, tap) step, [64 o][32 k] (the wrapper lays
// the weights out as [O, 3*C], K contiguous), is double-buffered with
// cp.async. Eight warps, each a 32 x 32 sub-tile as 2 x 4
// `mma.sync.m16n8k16` (bf16 in, fp32 accumulate). The epilogue adds bias,
// temb (per (b, t, o)) and the residual in fp32, casts, stores, and
// reduces the sums over its rows: warp shuffles, shared-memory atomics,
// then one global atomicAdd per (block, o). A block never straddles two
// videos (grid z is the video), so the sums need no split.
//
// Bound: tensor-core throughput. At [2, 25, 9216, 320] -> 320 the conv is
// 2.83e11 FLOP (0.29 ms at the 989 TFLOP/s bf16 peak); `mma.sync` cannot
// reach that peak (only `wgmma` can), and the window is staged again for
// each 64-wide output tile.
#include "common.cuh"

using bf16 = __nv_bfloat16;

namespace {

constexpr int BM = 128, BN = 64, BK = 32, NT = 256, LDS = BK + 8;
constexpr int MAX_C = 640;
constexpr int TAPS = 3;
constexpr int QB = 32, RB = BM / QB;                // the tile: 4 frames x 32 positions
constexpr int WP = (RB + 2) * QB;                   // window pixels
constexpr int WCH = (WP * (BK / 8) + NT - 1) / NT;  // 16-byte pieces per thread

__global__ void __launch_bounds__(NT) gn_silu_tconv_kernel(
    const bf16* __restrict__ x, const float* __restrict__ fa, const float* __restrict__ fb,
    const bf16* __restrict__ wt, const float* __restrict__ bias,
    const float* __restrict__ temb, const bf16* __restrict__ res, bf16* __restrict__ out,
    float* __restrict__ s1, float* __restrict__ s2, int R, int Q, int C, int O, int silu) {
  __shared__ __align__(16) bf16 Ws[2][WP * LDS];    // activated window, per chunk
  __shared__ __align__(16) bf16 Bs[2][BN * LDS];    // weight tile, per (chunk, tap)
  __shared__ float sa[MAX_C], sb[MAX_C];
  __shared__ float red[2][BN];

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp % 4, wn = warp / 4;           // 32-row / 32-column sub-tile
  const int tiles_q = (Q + QB - 1) / QB;
  const int r0 = (blockIdx.y / tiles_q) * RB, q0 = (blockIdx.y % tiles_q) * QB;
  const int o0 = blockIdx.x * BN;
  const int n = blockIdx.z;
  const long long K = (long long)TAPS * C;
  const bf16* xn = x + (long long)n * R * Q * C;

  for (int c = tid; c < C; c += NT) {
    sa[c] = fa[(long long)n * C + c];
    sb[c] = fb[(long long)n * C + c];
  }
  if (tid < 2 * BN) red[tid / BN][tid % BN] = 0.0f;

  // this thread's 16-byte pieces of the window: pixel idx / 4, channels (idx % 4) * 8
  const int cc = (tid & 3) * 8;
  long long woff[WCH];
  bool wok[WCH];
#pragma unroll
  for (int j = 0; j < WCH; ++j) {
    const int p = (tid + NT * j) >> 2;
    const int ir = r0 + p / QB - 1, iq = q0 + p % QB;
    wok[j] = p < WP && ir >= 0 && ir < R && iq >= 0 && iq < Q;
    woff[j] = wok[j] ? ((long long)ir * Q + iq) * C + cc : 0;
  }
  // the window pixel of each of this lane's ldmatrix rows (tap 0)
  int abase[2];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
    abase[mi] = wm * 32 + mi * 16 + (lane & 15);    // window rows are QB wide, as the tile's
  }
  const int nck = C / BK, NS = TAPS * nck;
  uint4 wreg[WCH];

  auto load_w = [&](int chunk) {                    // raw x of a chunk into registers
#pragma unroll
    for (int j = 0; j < WCH; ++j)
      if (wok[j])
        wreg[j] = __ldg(reinterpret_cast<const uint4*>(xn + woff[j] + chunk * BK));
  };
  auto store_w = [&](int buf, int chunk) {          // silu(x*a + b) -> window, bf16
    const int c0 = chunk * BK + cc;
#pragma unroll
    for (int j = 0; j < WCH; ++j) {
      const int p = (tid + NT * j) >> 2;
      if (p >= WP) continue;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);         // zero padding of the ACTIVATED tensor
      if (wok[j]) {
        const __nv_bfloat162* e = reinterpret_cast<const __nv_bfloat162*>(&wreg[j]);
        uint32_t pk[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float2 f = __bfloat1622float2(e[i]);
          float y0 = fmaf(f.x, sa[c0 + 2 * i], sb[c0 + 2 * i]);
          float y1 = fmaf(f.y, sa[c0 + 2 * i + 1], sb[c0 + 2 * i + 1]);
          if (silu) {
            y0 = __fdividef(y0, 1.0f + __expf(-y0));
            y1 = __fdividef(y1, 1.0f + __expf(-y1));
          }
          pk[i] = mofa::pack_bf16(y0, y1);
        }
        v = make_uint4(pk[0], pk[1], pk[2], pk[3]);
      }
      *reinterpret_cast<uint4*>(&Ws[buf][p * LDS + cc]) = v;
    }
  };
  auto load_b = [&](int buf, int s) {               // weight tile [64 o][32 k], async
    const int tap = s % TAPS, c0 = (s / TAPS) * BK;
    const int r = tid >> 2, kc = (tid & 3) * 8;
    mofa::cp_async16(&Bs[buf][r * LDS + kc],
                     wt + (long long)(o0 + r) * K + (long long)tap * C + c0 + kc);
    mofa::cp_async_commit();
  };

  load_b(0, 0);
  load_w(0);
  __syncthreads();                                  // sa / sb staged
  store_w(0, 0);
  mofa::cp_async_wait<0>();
  __syncthreads();

  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.0f;

  for (int s = 0; s < NS; ++s) {
    const int buf = s & 1, chunk = s / TAPS, tap = s % TAPS, wbuf = chunk & 1;
    const bool more = s + 1 < NS, next_chunk = chunk + 1 < nck;
    if (more) load_b(buf ^ 1, s + 1);
    if (tap == 0 && next_chunk) load_w(chunk + 1);
    const int shift = tap * QB;
    const bf16* Wt = Ws[wbuf];
    const bf16* Bt = Bs[buf] + wn * 32 * LDS;
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t af[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
        mofa::ldsm_x4(af[mi], Wt + (abase[mi] + shift) * LDS + kk * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int nj = 0; nj < 2; ++nj) {
        uint32_t bq[4];                             // n-tiles 2nj and 2nj+1
        const int mat = lane >> 3;
        mofa::ldsm_x4(bq, Bt + (nj * 16 + (mat >> 1) * 8 + (lane & 7)) * LDS + kk * 16 +
                              (mat & 1) * 8);
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          mofa::mma_bf16(acc[mi][2 * nj], af[mi], bq[0], bq[1]);
          mofa::mma_bf16(acc[mi][2 * nj + 1], af[mi], bq[2], bq[3]);
        }
      }
    }
    if (tap == TAPS - 1 && next_chunk) store_w(wbuf ^ 1, chunk + 1);
    if (more) mofa::cp_async_wait<0>();
    __syncthreads();
  }

  // epilogue: + bias [+ temb] [+ residual] in fp32, cast, store; sums
  float c1[4][2], c2[4][2];
#pragma unroll
  for (int j = 0; j < 4; ++j) c1[j][0] = c1[j][1] = c2[j][0] = c2[j][1] = 0.0f;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int rr = wm * 32 + mi * 16 + g + 8 * hh;
      const int orow = r0 + rr / QB, ocol = q0 + rr % QB;
      if (orow >= R || ocol >= Q) continue;
      const long long m = (long long)orow * Q + ocol;
      const long long ooff = ((long long)n * R * Q + m) * O;
      const float* tb = nullptr;
      if (temb) tb = temb + ((long long)n * R + orow) * O;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int o = o0 + wn * 32 + j * 8 + 2 * t;
        float v0 = acc[mi][j][2 * hh] + bias[o];
        float v1 = acc[mi][j][2 * hh + 1] + bias[o + 1];
        if (tb) {
          v0 += tb[o];
          v1 += tb[o + 1];
        }
        if (res) {
          const float2 r2 =
              __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(res + ooff + o));
          v0 += r2.x;
          v1 += r2.y;
        }
        *reinterpret_cast<__nv_bfloat162*>(out + ooff + o) = __floats2bfloat162_rn(v0, v1);
        c1[j][0] += v0;
        c1[j][1] += v1;
        c2[j][0] = fmaf(v0, v0, c2[j][0]);
        c2[j][1] = fmaf(v1, v1, c2[j][1]);
      }
    }
  }
  if (s1) {                                           // uniform over the block
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float u1 = c1[j][e], u2 = c2[j][e];
#pragma unroll
        for (int off = 4; off < 32; off <<= 1) {      // over the 8 row groups g
          u1 += __shfl_xor_sync(0xffffffffu, u1, off);
          u2 += __shfl_xor_sync(0xffffffffu, u2, off);
        }
        if (g == 0) {
          atomicAdd(&red[0][wn * 32 + j * 8 + 2 * t + e], u1);
          atomicAdd(&red[1][wn * 32 + j * 8 + 2 * t + e], u2);
        }
      }
    }
    __syncthreads();
    if (tid < BN) {
      atomicAdd(s1 + (long long)n * O + o0 + tid, red[0][tid]);
      atomicAdd(s2 + (long long)n * O + o0 + tid, red[1][tid]);
    }
  }
}

int launch(const void* x, const void* a, const void* b, const void* wt, const void* bias,
           const void* temb, const void* res, void* out, void* s1, void* s2, int N, int R,
           int Q, int C, int O, int silu, cudaStream_t st) {
  if (C % BK || O % BN || C > MAX_C || C <= 0 || O <= 0) return (int)cudaErrorInvalidValue;
  const long long tiles = (long long)((R + RB - 1) / RB) * ((Q + QB - 1) / QB);
  if (N > 0 && tiles > 0)
    gn_silu_tconv_kernel<<<dim3(O / BN, (unsigned)tiles, N), NT, 0, st>>>(
        (const bf16*)x, (const float*)a, (const float*)b, (const bf16*)wt,
        (const float*)bias, (const float*)temb, (const bf16*)res, (bf16*)out, (float*)s1,
        (float*)s2, R, Q, C, O, silu);
  return (int)cudaGetLastError();
}

}  // namespace

// x [B, T, S, C] bf16; a, b [B, C] fp32; wt [O, 3*C] bf16 (the [3, C, O]
// taps re-laid out as rows of O); bias [O] fp32; temb [B, T, O] fp32 or
// null; res [B, T, S, O] bf16 or null; out [B, T, S, O] bf16; s1/s2 [B, O]
// fp32 zero-filled, or null. All contiguous and 16-byte aligned; C % 32 ==
// 0, C <= 640, O % 64 == 0.
extern "C" int mofa_gn_silu_tconv3(const void* x, const void* a, const void* b,
                                   const void* wt, const void* bias, const void* temb,
                                   const void* res, void* out, void* s1, void* s2, int B,
                                   int T, int S, int C, int O, int silu, void* stream) {
  return launch(x, a, b, wt, bias, temb, res, out, s1, s2, B, T, S, C, O, silu,
                (cudaStream_t)stream);
}
