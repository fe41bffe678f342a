// Fused GroupNorm-apply + SiLU + convolution, channel-last, bf16:
//   out = conv(silu(x * a + b)) + bias [+ temb] [+ residual]
// with a, b the folded GroupNorm affine per (n, c), and optionally the fp32
// sums of out and out^2 per (n, o) (before the cast), for the next norm.
// The conv is the 3x3 spatial one over [N, H, W, C], or the (3, 1, 1)
// temporal one over [B, T, S, C], seen here as [N = B, H = T, W = S, C].
//
// Replaces mofa_tpu/kernels/conv_fused.py::_fused_conv_fwd (3x3) and
// ::_fused_tconv_fwd (temporal). The TPU kernels hold one image's [H, W,
// C] (one video's [T, S, C]) slice in VMEM, round the activated strip to
// the output dtype and run 9 (3) shifted [rows, C] x [C, O] matmuls. That
// rounding point splits each function into two kernels here, and nothing
// rounds where the TPU kernels do not:
//
// - `act_kernel`: y = silu(x * a + b) in fp32, rounded to bf16, one pass
//   over [N, H, W, C] with 16-byte loads and stores, so that every input
//   element goes through the affine and SiLU once. Bound: bytes, 2 N H W
//   C x 2 (0.18 ms at [50, 72, 128, 320] on 3.35 TB/s).
// - `conv_gemm_kernel<TN, TAPS>`: the conv as an implicit GEMM on `wgmma`,
//   M = output pixels, N = O, K = TAPS x C, one template for both tap
//   geometries: TAPS = 9, tap (dy, dx) = (tap / 3 - 1, tap % 3 - 1); TAPS =
//   3, tap dt at (dt - 1, 0), the frame before, the frame itself and the
//   frame after. A tile is 256 output pixels, a TH x TW rectangle of one
//   image (TW = 128 at /8, 64 at /16, ...; for the temporal conv TH frames
//   of TW positions), for TN output channels (160, 128 or 64: the widest
//   that divides O). A producer warp issues, per k-tile (one tap, 64
//   channels), a TMA load of the tap's shifted view of y, the box of a 4-D
//   [N, H, W, C] tensor map at pixel (h0 + dy, w0 + dx), and of the weight
//   tile [TN, 64] of a 2-D map over wt [O, TAPS C] (K-major: column tap * C
//   + c). TMA's zero fill of coordinates outside the tensor IS the conv's
//   zero padding of the ACTIVATED tensor, the frames t = -1 and t = T
//   included (THE TRAP: padding with silu(b) would be wrong), and also
//   zeroes the channels past C when C % 64 != 0 (the weight box then runs
//   into the next tap's columns, which multiply those zeros). Two consumer
//   warpgroups, 128 pixels each, accumulate 128 x TN in fp32 with two
//   `wgmma.m64nTNk16` per k16 (one per 64-pixel block, sharing the weight
//   tile) from the 128-byte swizzled ring stages.
//   The grid is persistent (a block per SM walks the tiles, output-channel
//   tile fastest, so a pixel tile's taps are re-read from L2), and the
//   producer runs into the next tile while the consumers run the epilogue,
//   32 columns at a time: acc + bias + temb staged in fp32 through shared
//   memory (temb per (n, o) for the 3x3; per (b, t, o) for the temporal
//   conv, read at each output row's own frame: a tile of TH > 1 frames
//   spans several), then written as row-contiguous 4-column pieces with
//   the residual (its loads issued before the staging) added in fp32 and
//   rounded once; the sums reduced over the tile's pixels (warp shuffles,
//   each warp's partials stored to shared memory and summed in order by
//   one thread per column, one global atomic per (tile, column);
//   shared-memory float atomics there cost more than all the stores). A
//   tile never straddles two images. Bound: operations, 2 N H W O TAPS C
//   (0.86 ms at [50, 72, 128, 320] -> 320, 3x3; 0.29 ms at [2, 25, 9216,
//   320] -> 320, temporal; on the 989 TFLOP/s bf16 peak).
//   Measured slower on the H100: a 128-pixel tile (one m64 block a
//   warpgroup), and storing the fragments directly instead of staging.
//   The temporal conv's activation is not fused into the GEMM's window:
//   a window of TH + 2 frames activated per k-tile per output tile would
//   run the affine and SiLU about 3 times per element inside the
//   compute-bound kernel, where the separate pass runs them once.
#include <algorithm>

#include "hopper.cuh"

using bf16 = __nv_bfloat16;

namespace {

constexpr int BM = 256;             // output pixels per tile
constexpr int MI = BM / 128;        // m64 row blocks per consumer warpgroup
constexpr int KTILE = 64;           // channels per k-tile: one 128-byte swizzled row
constexpr int THREADS = 384;        // two consumer warpgroups, one producer
constexpr int SMEM_LIMIT = 232448;  // a block's shared memory on sm_90
constexpr int MAX_TN = 160;
constexpr int STATIC_SMEM = 2 * 8 * MAX_TN * 4 + 1024;   // the sums' partials, the barriers
constexpr int OUT_CH = 32;          // output columns per staged chunk of the epilogue
constexpr int OUT_PITCH = 40;       // its fp32 row pitch: conflict-free float2 / float4
constexpr int EPI_WG_BYTES = BM / 2 * OUT_PITCH * 4;     // a warpgroup's staged chunk

// a tile: BM output pixels (two consumer warpgroups of MI m64 row blocks)
// x TN output channels
template <int TN>
struct ConvCfg {
  static constexpr int A_BYTES = BM * 128;
  static constexpr int B_BYTES = TN * 128;
  static constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
  static constexpr int EPI_BYTES = 2 * EPI_WG_BYTES;
  static constexpr int STAGES_FIT = (SMEM_LIMIT - 1024 - STATIC_SMEM - EPI_BYTES) / STAGE_BYTES;
  static constexpr int STAGES = STAGES_FIT < 8 ? STAGES_FIT : 8;
  static constexpr int SMEM = STAGES * STAGE_BYTES + EPI_BYTES + 1024;   // + alignment
  static constexpr int ACC = MI * TN / 2;                    // fp32 accumulators a thread
  static_assert(B_BYTES % 1024 == 0, "stages keep the 1024-byte swizzle atoms");
  static_assert(STAGES >= 3, "a ring");
};

template <int TN>
__device__ __forceinline__ void wgmma_tile(float* acc, uint64_t da, uint64_t db, int accumulate) {
  if constexpr (TN == 160) mofa::wgmma_m64n160k16_ss(acc, da, db, accumulate);
  else if constexpr (TN == 128) mofa::wgmma_m64n128k16_ss(acc, da, db, accumulate);
  else mofa::wgmma_m64n64k16_ss(acc, da, db, accumulate);
}

// ---- the activation pass: y = silu(x * a + b), bf16; 8 channels a thread
__global__ void __launch_bounds__(256) act_kernel(const bf16* __restrict__ x,
                                                  const float* __restrict__ fa,
                                                  const float* __restrict__ fb,
                                                  bf16* __restrict__ y, long long img, int C,
                                                  long long pieces, int silu) {
  for (long long i = (long long)blockIdx.x * 256 + threadIdx.x; i < pieces;
       i += (long long)gridDim.x * 256) {
    const long long e = i * 8;
    const int c = (int)(e % C);
    const long long nc = e / img * C + c;           // (image, channel) of the piece
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(x + e));
    const float4 a0 = __ldg(reinterpret_cast<const float4*>(fa + nc));
    const float4 a1 = __ldg(reinterpret_cast<const float4*>(fa + nc + 4));
    const float4 b0 = __ldg(reinterpret_cast<const float4*>(fb + nc));
    const float4 b1 = __ldg(reinterpret_cast<const float4*>(fb + nc + 4));
    const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
    const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
    const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&v);
    uint32_t pk[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float2 f = __bfloat1622float2(p[k]);
      float y0 = fmaf(f.x, av[2 * k], bv[2 * k]);
      float y1 = fmaf(f.y, av[2 * k + 1], bv[2 * k + 1]);
      if (silu) {
        y0 = __fdividef(y0, 1.0f + __expf(-y0));
        y1 = __fdividef(y1, 1.0f + __expf(-y1));
      }
      pk[k] = mofa::pack_bf16(y0, y1);
    }
    *reinterpret_cast<uint4*>(y + e) = make_uint4(pk[0], pk[1], pk[2], pk[3]);
  }
}

// ---- the implicit GEMM over the activated tensor: TAPS = 9 (3x3) or 3 (over H)
template <int TN, int TAPS>
__global__ void __launch_bounds__(THREADS, 1) conv_gemm_kernel(
    const __grid_constant__ CUtensorMap ty, const __grid_constant__ CUtensorMap tw,
    const float* __restrict__ bias, const float* __restrict__ temb,
    const bf16* __restrict__ res, bf16* __restrict__ out, float* __restrict__ s1,
    float* __restrict__ s2, int N, int H, int W, int C, int O, int TW) {
  using G = ConvCfg<TN>;
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t bars[2 * G::STAGES];
  __shared__ __align__(16) float part[2][8][MAX_TN];  // the sums' partials per consumer warp
  // swizzled tiles start on 1024-byte boundaries (the 8-row swizzle atom)
  const uint32_t base = (mofa::smem_addr(smem_raw) + 1023) & ~1023u;
  auto sa = [&](int s) { return base + s * G::STAGE_BYTES; };
  auto sb = [&](int s) { return base + s * G::STAGE_BYTES + G::A_BYTES; };
  auto full = [&](int s) { return mofa::smem_addr(&bars[s]); };
  auto empty = [&](int s) { return mofa::smem_addr(&bars[G::STAGES + s]); };

  const int tid = threadIdx.x, wg = tid / 128;
  const int TH = BM / TW;
  const int tiles_w = (W + TW - 1) / TW, tiles_h = (H + TH - 1) / TH, tiles_o = O / TN;
  const int tiles = N * tiles_h * tiles_w * tiles_o;
  const int KT = TAPS * ((C + KTILE - 1) / KTILE);  // k-tiles: 64 channels of one tap
  // tile -> (image, first output row, first output column, first output channel)
  auto coords = [&](int tile, int& n, int& h0, int& w0, int& o0) {
    o0 = tile % tiles_o * TN;
    const int m = tile / tiles_o;
    w0 = m % tiles_w * TW;
    h0 = m / tiles_w % tiles_h * TH;
    n = m / (tiles_w * tiles_h);
  };
  if (tid == 0) {
    for (int s = 0; s < G::STAGES; ++s) {
      mofa::mbar_init(full(s), 1);
      mofa::mbar_init(empty(s), 8);                 // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {
    // ---- producer: one thread issues every copy, up to STAGES k-tiles
    // ahead of the consumers, across tiles
    mofa::setmaxnreg_dec<24>();
    if (tid == 256) {
      int it = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        int n, h0, w0, o0;
        coords(tile, n, h0, w0, o0);
        for (int kt = 0; kt < KT; ++kt, ++it) {
          const int s = it % G::STAGES, round = it / G::STAGES;
          const int tap = kt % TAPS, c0 = kt / TAPS * KTILE;
          const int dy = TAPS == 9 ? tap / 3 - 1 : tap - 1, dx = TAPS == 9 ? tap % 3 - 1 : 0;
          if (round > 0) mofa::mbar_wait(empty(s), (round - 1) & 1);
          mofa::mbar_arrive_expect_tx(full(s), G::STAGE_BYTES);
          mofa::tma_load_4d(sa(s), &ty, full(s), c0, w0 + dx, h0 + dy, n);
          mofa::tma_load_2d(sb(s), &tw, full(s), tap * C + c0, o0);
        }
      }
    }
    return;
  }

  // ---- consumers: MI row blocks of 64 pixels each
  mofa::setmaxnreg_inc<240>();
  const int warp = (tid % 128) / 32, lane = tid % 32, t = lane & 3, g = lane >> 2;
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
    int n, h0, w0, o0;
    coords(tile, n, h0, w0, o0);
    for (int kt = 0; kt < KT; ++kt, ++it) {
      const int s = it % G::STAGES;
      mofa::mbar_wait(full(s), (it / G::STAGES) & 1);
      const uint32_t a = sa(s) + wg * MI * 64 * 128;
      fence_acc();
      mofa::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < KTILE / 16; ++kk) {     // a k16 step is 32 bytes of the row
        const uint64_t db = mofa::gmma_desc_sw128(sb(s) + kk * 32, 16, 1024);
#pragma unroll
        for (int mi = 0; mi < MI; ++mi) {
          const uint64_t da = mofa::gmma_desc_sw128(a + mi * 64 * 128 + kk * 32, 16, 1024);
          wgmma_tile<TN>(acc + mi * TN / 2, da, db, kt > 0 || kk > 0);
        }
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

    // ---- epilogue: fragment (warp, lane) of row block mi holds rows
    // 64 mi + 16 warp + g (+ 8) of every n8 block j at columns 8j + 2t (+ 1)
    // temb: per (n, o) for the 3x3; per (n, frame, o) for the temporal conv,
    // where fragment row r = (mi, hh) of this thread reads its own frame's
    // row, tb + temb_row(r) (with TW >= 128 a warpgroup's rows are one frame)
    const float* tb = temb ? temb + (long long)n * (TAPS == 3 ? H : 1) * O : nullptr;
    const bool one_row = TAPS == 9 || TW >= BM / 2;
    auto temb_row = [&](int r) {                    // rows past H are never stored
      const int rt = wg * (BM / 2) + r / 2 * 64 + warp * 16 + g + 8 * (r % 2);
      return TAPS == 3 ? min(h0 + rt / TW, H - 1) * O : 0;
    };
    const int row0 = temb_row(0);
    // OUT_CH columns at a time: acc + bias + temb in fp32 into shared
    // memory, then rows of 4-column pieces (eight lanes to a row's 64
    // bytes) with the residual added, rounded once, and the sums
    float* const stage_out = reinterpret_cast<float*>(
        smem_raw + (base - mofa::smem_addr(smem_raw)) + G::STAGES * G::STAGE_BYTES +
        wg * EPI_WG_BYTES);
    const int wt = tid % 128, c4 = 4 * (wt % 8);
    constexpr int PIECES = BM / 2 * OUT_CH / 4 / 128;   // 4-column pieces a thread
    long long q[PIECES];                          // this thread's pieces' offsets, or -1
#pragma unroll
    for (int i = 0; i < PIECES; ++i) {
      const int rt = wg * (BM / 2) + wt / 8 + 16 * i;
      const int ph = h0 + rt / TW, pw = w0 + rt % TW;
      q[i] = ph < H && pw < W ? (((long long)n * H + ph) * W + pw) * O + o0 + c4 : -1;
    }
#pragma unroll
    for (int ch = 0; ch < TN / OUT_CH; ++ch) {
      uint2 xr[PIECES];                           // the residual, loaded before the staging
#pragma unroll
      for (int i = 0; i < PIECES; ++i)
        xr[i] = res && q[i] >= 0
                    ? __ldg(reinterpret_cast<const uint2*>(res + q[i] + ch * OUT_CH))
                    : make_uint2(0u, 0u);
      mofa::named_bar_sync(2 + wg, 128);          // the last chunk's copy-out is done
#pragma unroll
      for (int jj = 0; jj < OUT_CH / 8; ++jj) {
        const int o = o0 + ch * OUT_CH + 8 * jj + 2 * t;
        const int j = ch * OUT_CH / 8 + jj;
        const float2 bb = *reinterpret_cast<const float2*>(bias + o);
        const float2 te0 = tb ? *reinterpret_cast<const float2*>(tb + row0 + o)
                              : make_float2(0.f, 0.f);
#pragma unroll
        for (int mi = 0; mi < MI; ++mi)
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const float2 te =
                one_row || !tb ? te0
                               : *reinterpret_cast<const float2*>(tb + temb_row(2 * mi + hh) + o);
            *reinterpret_cast<float2*>(stage_out + (mi * 64 + warp * 16 + g + 8 * hh) * OUT_PITCH +
                                       8 * jj + 2 * t) =
                make_float2(acc[mi * TN / 2 + 4 * j + 2 * hh] + bb.x + te.x,
                            acc[mi * TN / 2 + 4 * j + 2 * hh + 1] + bb.y + te.y);
          }
      }
      mofa::named_bar_sync(2 + wg, 128);
      float u1[4] = {0.f, 0.f, 0.f, 0.f}, u2[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int i = 0; i < PIECES; ++i) {
        if (q[i] < 0) continue;
        float4 v = *reinterpret_cast<const float4*>(stage_out + (wt / 8 + 16 * i) * OUT_PITCH + c4);
        const float2 x01 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&xr[i].x));
        const float2 x23 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&xr[i].y));
        v.x += x01.x;                             // + 0 without a residual
        v.y += x01.y;
        v.z += x23.x;
        v.w += x23.y;
        *reinterpret_cast<uint2*>(out + q[i] + ch * OUT_CH) =
            make_uint2(mofa::pack_bf16(v.x, v.y), mofa::pack_bf16(v.z, v.w));
        u1[0] += v.x;
        u1[1] += v.y;
        u1[2] += v.z;
        u1[3] += v.w;
        u2[0] = fmaf(v.x, v.x, u2[0]);
        u2[1] = fmaf(v.y, v.y, u2[1]);
        u2[2] = fmaf(v.z, v.z, u2[2]);
        u2[3] = fmaf(v.w, v.w, u2[3]);
      }
      if (s1) {                                   // over the lanes of one column piece
#pragma unroll
        for (int k = 0; k < 4; ++k) {
#pragma unroll
          for (int off = 8; off < 32; off <<= 1) {
            u1[k] += __shfl_xor_sync(0xffffffffu, u1[k], off);
            u2[k] += __shfl_xor_sync(0xffffffffu, u2[k], off);
          }
        }
        if (lane < 8) {
          *reinterpret_cast<float4*>(&part[0][wg * 4 + warp][ch * OUT_CH + c4]) =
              make_float4(u1[0], u1[1], u1[2], u1[3]);
          *reinterpret_cast<float4*>(&part[1][wg * 4 + warp][ch * OUT_CH + c4]) =
              make_float4(u2[0], u2[1], u2[2], u2[3]);
        }
      }
    }
    if (s1) {
      mofa::named_bar_sync(1, 256);                 // every consumer warp's partials are in
      if (tid < TN) {                               // a column's 8 partials, in order
        float a1 = 0.0f, a2 = 0.0f;
#pragma unroll
        for (int w = 0; w < 8; ++w) {
          a1 += part[0][w][tid];
          a2 += part[1][w][tid];
        }
        atomicAdd(s1 + (long long)n * O + o0 + tid, a1);
        atomicAdd(s2 + (long long)n * O + o0 + tid, a2);
      }
      mofa::named_bar_sync(1, 256);                 // read before the next tile writes
    }
  }
}

int sm_count() {
  int dev = 0, n = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  return n;
}

int launch_act(const void* x, const void* a, const void* b, void* y, int N, int H, int W, int C,
               int silu, cudaStream_t st) {
  if (C % 8) return (int)cudaErrorInvalidValue;
  const long long img = (long long)H * W * C, pieces = N * img / 8;
  if (pieces > 0) {
    const long long blocks = std::min((pieces + 255) / 256, (long long)sm_count() * 8);
    act_kernel<<<(unsigned)blocks, 256, 0, st>>>((const bf16*)x, (const float*)a,
                                                 (const float*)b, (bf16*)y, img, C, pieces,
                                                 silu);
  }
  return (int)cudaGetLastError();
}

template <int TN, int TAPS>
int launch_gemm_tn(const void* y, const void* wt, const void* bias, const void* temb,
                   const void* res, void* out, void* s1, void* s2, int N, int H, int W, int C,
                   int O, cudaStream_t st) {
  using G = ConvCfg<TN>;
  // the pixel tile: TW = the power of two >= W, from 8 to 128; TH = BM / TW
  int TW = 8;
  while (TW < W && TW < 128) TW *= 2;
  const int TH = BM / TW;
  CUtensorMap ty, tw;
  if (!mofa::bf16_nhwc_map(&ty, y, N, H, W, C, TW, TH) ||
      !mofa::bf16_rows_map(&tw, wt, O, TAPS * C, TN))
    return (int)cudaErrorNotSupported;
  auto kernel = conv_gemm_kernel<TN, TAPS>;
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, G::SMEM);
  const long long tiles = (long long)N * ((H + TH - 1) / TH) * ((W + TW - 1) / TW) * (O / TN);
  kernel<<<(unsigned)std::min(tiles, (long long)sm_count()), THREADS, G::SMEM, st>>>(
      ty, tw, (const float*)bias, (const float*)temb, (const bf16*)res, (bf16*)out, (float*)s1,
      (float*)s2, N, H, W, C, O, TW);
  return (int)cudaGetLastError();
}

template <int TAPS>
int launch_gemm(const void* y, const void* wt, const void* bias, const void* temb,
                const void* res, void* out, void* s1, void* s2, int N, int H, int W, int C, int O,
                cudaStream_t st) {
  if (C % 8 || O % 64 || C <= 0 || O <= 0) return (int)cudaErrorInvalidValue;
  if ((long long)N * H * W <= 0) return (int)cudaGetLastError();
  if (O % 160 == 0)
    return launch_gemm_tn<160, TAPS>(y, wt, bias, temb, res, out, s1, s2, N, H, W, C, O, st);
  if (O % 128 == 0)
    return launch_gemm_tn<128, TAPS>(y, wt, bias, temb, res, out, s1, s2, N, H, W, C, O, st);
  return launch_gemm_tn<64, TAPS>(y, wt, bias, temb, res, out, s1, s2, N, H, W, C, O, st);
}

}  // namespace

// x, y [N, H, W, C] bf16; a, b [N, C] fp32. y = silu(x * a + b) (silu = 0:
// x * a + b). All contiguous and 16-byte aligned; C % 8 == 0.
extern "C" int mofa_gn_silu_act(const void* x, const void* a, const void* b, void* y, int N,
                                int H, int W, int C, int silu, void* stream) {
  return launch_act(x, a, b, y, N, H, W, C, silu, (cudaStream_t)stream);
}

// y [N, H, W, C] bf16 (activated); wt [O, 9*C] bf16 (HWIO re-laid out as
// rows of O); bias [O] fp32; temb [N, O] fp32 or null; res [N, H, W, O]
// bf16 or null; out [N, H, W, O] bf16; s1/s2 [N, O] fp32 zero-filled, or
// null. All contiguous and 16-byte aligned; C % 8 == 0, O % 64 == 0.
extern "C" int mofa_conv3x3_gemm(const void* y, const void* wt, const void* bias,
                                 const void* temb, const void* res, void* out, void* s1, void* s2,
                                 int N, int H, int W, int C, int O, void* stream) {
  return launch_gemm<9>(y, wt, bias, temb, res, out, s1, s2, N, H, W, C, O,
                        (cudaStream_t)stream);
}

// The temporal conv: y [B, T, S, C] bf16 (activated); wt [O, 3*C] bf16 (the
// [3, C, O] taps re-laid out as rows of O); temb [B, T, O] fp32 or null;
// res, out [B, T, S, O]; the rest as mofa_conv3x3_gemm.
extern "C" int mofa_tconv3_gemm(const void* y, const void* wt, const void* bias,
                                const void* temb, const void* res, void* out, void* s1, void* s2,
                                int B, int T, int S, int C, int O, void* stream) {
  return launch_gemm<3>(y, wt, bias, temb, res, out, s1, s2, B, T, S, C, O,
                        (cudaStream_t)stream);
}

// The two stages in turn, through the scratch y [N, H, W, C] bf16.
extern "C" int mofa_gn_silu_conv3x3(const void* x, const void* a, const void* b, const void* wt,
                                    const void* bias, const void* temb, const void* res, void* y,
                                    void* out, void* s1, void* s2, int N, int H, int W, int C,
                                    int O, int silu, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int err = launch_act(x, a, b, y, N, H, W, C, silu, st);
  return err ? err : launch_gemm<9>(y, wt, bias, temb, res, out, s1, s2, N, H, W, C, O, st);
}

// The same for the temporal conv, x and y [B, T, S, C].
extern "C" int mofa_gn_silu_tconv3(const void* x, const void* a, const void* b, const void* wt,
                                   const void* bias, const void* temb, const void* res, void* y,
                                   void* out, void* s1, void* s2, int B, int T, int S, int C,
                                   int O, int silu, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int err = launch_act(x, a, b, y, B, T, S, C, silu, st);
  return err ? err : launch_gemm<3>(y, wt, bias, temb, res, out, s1, s2, B, T, S, C, O, st);
}
