// Attention over short sequences (L <= 32) on tensor cores.
//
// Two layouts, one body. Frame t of sequence (b, s), head h, lies at
//   q[((b * L + t) * S + s) * H * D + h * D + d],
// so frames sit S*H*D elements apart:
// - spatial-major ("tmajor") rows [B*T, S, H*D], the projections' natural
//   output, attention over the frame axis for every (b, spatial slot s,
//   head): replaces mofa_tpu/kernels/short_attention.py::_tmajor_fwd
//   (C entry mofa_tmajor_attention);
// - the classic layout [B, L, H, D] is the same with S = 1: replaces
//   ::_short_attn_fwd (C entry mofa_short_attention).
// The TPU kernels pack many sequences under a block-diagonal mask so that
// the MXU gets a large tile; on Hopper one (sequence, head) is one warp's
// 32 x 32 x D problem for `mma.sync.m16n8k16`.
//
// Bound: device memory (one read of q/k/v, one write of out; the
// products are 2 L^2 D operations per L D values, far under the card's
// ridge). What the design does about it:
// - every warp walks its own (sequence, head) tasks, grid-stride, and
//   double-buffers them: the 16-byte `cp.async` copies of the next task's
//   q/k/v rows (D contiguous values per frame) are in flight while the
//   warp computes this one, and a block of 4 warps keeps 2 x 4 tasks'
//   rows in shared memory (bf16, padded to 32 rows; the padded rows are
//   zeroed once and never loaded);
// - QK^T and PV run on tensor cores from `ldmatrix` fragments (V through
//   the transposed form), the exact max-subtracted softmax with fp32
//   logits on the accumulator fragments, the keys past L masked to -inf,
//   P normalised in fp32 and rounded to bf16 as the A operand of PV;
// - the output goes back through shared memory as 16-byte row writes.
// The fp32 path (composition checks, tests; not timed) runs the same body
// on each operand split into three bf16 terms (hi + mid + lo, 24 bits of
// mantissa), summing the six products whose terms are not both small:
// fp32 accuracy from the bf16 tensor-core instruction.
#include "common.cuh"

using bf16 = __nv_bfloat16;

namespace {

constexpr int ROWS = 32;                      // frames padded to one tile
constexpr int BF16_WARPS = 4, F32_WARPS = 2;  // warps per block

template <int D>
struct ShortCfg {
  static constexpr int PITCH = D + 8;         // bf16; ldmatrix rows hit distinct banks
  static constexpr int TILE = ROWS * PITCH;   // one of q / k / v, elements
  static constexpr int BLOCKS_PER_SM = D == 64 ? 2 : 1;   // bf16, by shared memory
};

// O[32 x D] (rows < L meaningful) of one (sequence, head) from tiles in
// shared memory; q[i] / k[i] / v[i] are the NSPLIT bf16 terms of each
// operand. o[mi][n][e]: row 16 mi + lane/4 + 8 (e/2), column 8n + 2 (lane%4) + e%2.
template <int D, int NSPLIT>
__device__ __forceinline__ void attend(const bf16* const* q, const bf16* const* k,
                                       const bf16* const* v, int L, float scale_log2,
                                       int lane, float (&o)[2][D / 8][4]) {
  constexpr int P = ShortCfg<D>::PITCH;
  float s[2][4][4];                           // S[32 x 32]: m-tile, 8-key tile
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int n = 0; n < 4; ++n) s[mi][n][0] = s[mi][n][1] = s[mi][n][2] = s[mi][n][3] = 0.0f;
#pragma unroll
  for (int qi = 0; qi < NSPLIT; ++qi)
#pragma unroll
    for (int kj = 0; kj + qi < NSPLIT; ++kj)
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t a[2][4], b[2][4];
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
          mofa::ldsm_x4(a[mi], q[qi] + (16 * mi + (lane & 15)) * P + kk * 16 + (lane >> 4) * 8);
#pragma unroll
        for (int np = 0; np < 2; ++np)
          mofa::ldsm_x4(b[np], k[kj] + (16 * np + ((lane >> 4) << 3) + (lane & 7)) * P +
                                   kk * 16 + ((lane >> 3) & 1) * 8);
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
          for (int n = 0; n < 4; ++n)
            mofa::mma_bf16(s[mi][n], a[mi], b[n / 2][(n & 1) * 2], b[n / 2][(n & 1) * 2 + 1]);
      }

  // exact softmax per row: keys >= L masked, max-subtracted, normalised
  // in fp32, then each probability split into NSPLIT bf16 terms packed as
  // the A operand of PV (n-tile n is half n % 2 of k-step n / 2)
  const int t = lane & 3;
  uint32_t pa[NSPLIT][2][2][4];               // split, m-tile, k-step, register
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (8 * n + 2 * t + (e & 1) >= L) s[mi][n][e] = -INFINITY;
        if (e < 2) mx0 = fmaxf(mx0, s[mi][n][e]);
        else mx1 = fmaxf(mx1, s[mi][n][e]);
      }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    const float ms0 = mx0 * scale_log2, ms1 = mx1 * scale_log2;
    float sum0 = 0.0f, sum1 = 0.0f;
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[mi][n][e] = exp2f(fmaf(s[mi][n][e], scale_log2, e < 2 ? -ms0 : -ms1));
        if (e < 2) sum0 += s[mi][n][e];
        else sum1 += s[mi][n][e];
      }
    sum0 += __shfl_xor_sync(0xffffffffu, sum0, 1);
    sum0 += __shfl_xor_sync(0xffffffffu, sum0, 2);
    sum1 += __shfl_xor_sync(0xffffffffu, sum1, 1);
    sum1 += __shfl_xor_sync(0xffffffffu, sum1, 2);
    const float inv0 = 1.0f / sum0, inv1 = 1.0f / sum1;
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      float r[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) r[e] = s[mi][n][e] * (e < 2 ? inv0 : inv1);
#pragma unroll
      for (int sp = 0; sp < NSPLIT; ++sp) {
        float term[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          term[e] = __bfloat162float(__float2bfloat16(r[e]));
          r[e] -= term[e];
        }
        pa[sp][mi][n / 2][(n & 1) * 2] = mofa::pack_bf16(term[0], term[1]);      // row g
        pa[sp][mi][n / 2][(n & 1) * 2 + 1] = mofa::pack_bf16(term[2], term[3]);  // row g + 8
      }
    }
  }

  // O = P V over 32 keys (two k-steps); V's B fragments via ldmatrix.trans
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int n = 0; n < D / 8; ++n) o[mi][n][0] = o[mi][n][1] = o[mi][n][2] = o[mi][n][3] = 0.0f;
#pragma unroll
  for (int sp = 0; sp < NSPLIT; ++sp)
#pragma unroll
    for (int vj = 0; vj + sp < NSPLIT; ++vj)
#pragma unroll
      for (int ks = 0; ks < 2; ++ks)
#pragma unroll
        for (int np = 0; np < D / 16; ++np) {
          uint32_t b[4];
          mofa::ldsm_x4_trans(b, v[vj] + (16 * ks + (lane & 15)) * P + np * 16 + (lane >> 4) * 8);
#pragma unroll
          for (int mi = 0; mi < 2; ++mi) {
            mofa::mma_bf16(o[mi][2 * np], pa[sp][mi][ks], b[0], b[1]);
            mofa::mma_bf16(o[mi][2 * np + 1], pa[sp][mi][ks], b[2], b[3]);
          }
        }
}

// element offset of frame 0 of task (b, s, h), h fastest; frames are
// S * H * D apart
__device__ __forceinline__ long long task_base(long long task, int L, int S, int H, int D) {
  const int h = (int)(task % H);
  const long long bs = task / H;
  const int s = (int)(bs % S);
  const long long b = bs / S;
  return ((b * L) * S + s) * (long long)H * D + (long long)h * D;
}

// bf16: each warp walks tasks gw, gw + nw, ... with the next task's rows
// in flight (cp.async, double buffer) while it computes this one
template <int D>
__global__ void __launch_bounds__(BF16_WARPS * 32, ShortCfg<D>::BLOCKS_PER_SM)
    short_attn_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                           const bf16* __restrict__ v, bf16* __restrict__ out,
                           long long ntasks, int L, int S, int H, float scale_log2) {
  constexpr int P = ShortCfg<D>::PITCH, TILE = ShortCfg<D>::TILE, CPR = D / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  bf16* const mine = reinterpret_cast<bf16*>(smem_raw) + warp * 6 * TILE;  // 2 x (q, k, v)
  const long long row_stride = (long long)S * H * D;
  const long long nw = (long long)gridDim.x * BF16_WARPS;

  // the padded rows L..31 stay zero: finite logits (masked) and zero V rows
  for (int i = lane; i < 6 * (ROWS - L) * CPR; i += 32) {
    const int tile = i / ((ROWS - L) * CPR), r = i % ((ROWS - L) * CPR);
    *reinterpret_cast<uint4*>(mine + tile * TILE + (L + r / CPR) * P + (r % CPR) * 8) =
        make_uint4(0, 0, 0, 0);
  }
  auto load = [&](bf16* buf, long long task) {
    const long long base = task_base(task, L, S, H, D);
    for (int i = lane; i < L * CPR; i += 32) {
      const int f = i / CPR, c = (i % CPR) * 8;
      const long long g = base + f * row_stride + c;
      mofa::cp_async16(buf + f * P + c, q + g);
      mofa::cp_async16(buf + TILE + f * P + c, k + g);
      mofa::cp_async16(buf + 2 * TILE + f * P + c, v + g);
    }
  };

  long long task = (long long)blockIdx.x * BF16_WARPS + warp;
  if (task < ntasks) load(mine, task);
  mofa::cp_async_commit();
  for (int it = 0; task < ntasks; ++it, task += nw) {
    bf16* const buf = mine + (it & 1) * 3 * TILE;
    if (task + nw < ntasks) load(mine + ((it + 1) & 1) * 3 * TILE, task + nw);
    mofa::cp_async_commit();
    mofa::cp_async_wait<1>();
    __syncwarp();
    const bf16* qs[1] = {buf};
    const bf16* ks[1] = {buf + TILE};
    const bf16* vs[1] = {buf + 2 * TILE};
    float o[2][D / 8][4];
    attend<D, 1>(qs, ks, vs, L, scale_log2, lane, o);
    // O's rows < L -> the q tile (free now) -> 16-byte row writes
    __syncwarp();
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int n = 0; n < D / 8; ++n)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf)
          if (16 * mi + g + 8 * hf < L)
            *reinterpret_cast<uint32_t*>(buf + (16 * mi + g + 8 * hf) * P + 8 * n + 2 * t) =
                mofa::pack_bf16(o[mi][n][2 * hf], o[mi][n][2 * hf + 1]);
    __syncwarp();
    const long long base = task_base(task, L, S, H, D);
    for (int i = lane; i < L * CPR; i += 32) {
      const int f = i / CPR, c = (i % CPR) * 8;
      *reinterpret_cast<uint4*>(out + base + f * row_stride + c) =
          *reinterpret_cast<const uint4*>(buf + f * P + c);
    }
    __syncwarp();                             // before this buffer is refilled
  }
  mofa::cp_async_wait<0>();
}

// fp32 (not timed): the same walk without the pipeline; each operand is
// split into three bf16 terms on its way into shared memory
template <int D>
__global__ void __launch_bounds__(F32_WARPS * 32)
    short_attn_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                          const float* __restrict__ v, float* __restrict__ out,
                          long long ntasks, int L, int S, int H, float scale_log2) {
  constexpr int P = ShortCfg<D>::PITCH, TILE = ShortCfg<D>::TILE;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  bf16* const mine = reinterpret_cast<bf16*>(smem_raw) + warp * 9 * TILE;  // (q, k, v) x 3 terms
  const long long row_stride = (long long)S * H * D;
  const long long nw = (long long)gridDim.x * F32_WARPS;
  for (int i = lane; i < 9 * ROWS * P / 8; i += 32)
    reinterpret_cast<uint4*>(mine)[i] = make_uint4(0, 0, 0, 0);
  const float* src[3] = {q, k, v};
  for (long long task = (long long)blockIdx.x * F32_WARPS + warp; task < ntasks; task += nw) {
    const long long base = task_base(task, L, S, H, D);
    __syncwarp();
    for (int i = lane; i < 3 * L * D / 4; i += 32) {
      const int which = i / (L * D / 4), r = i % (L * D / 4);
      const int f = r / (D / 4), c = (r % (D / 4)) * 4;
      float x[4];
      *reinterpret_cast<float4*>(x) =
          *reinterpret_cast<const float4*>(src[which] + base + f * row_stride + c);
#pragma unroll
      for (int sp = 0; sp < 3; ++sp) {
        bf16* dst = mine + (which * 3 + sp) * TILE + f * P + c;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          dst[e] = __float2bfloat16(x[e]);
          x[e] -= __bfloat162float(dst[e]);
        }
      }
    }
    __syncwarp();
    const bf16* qs[3] = {mine, mine + TILE, mine + 2 * TILE};
    const bf16* ks[3] = {mine + 3 * TILE, mine + 4 * TILE, mine + 5 * TILE};
    const bf16* vs[3] = {mine + 6 * TILE, mine + 7 * TILE, mine + 8 * TILE};
    float o[2][D / 8][4];
    attend<D, 3>(qs, ks, vs, L, scale_log2, lane, o);
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int n = 0; n < D / 8; ++n)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int f = 16 * mi + g + 8 * hf;
          if (f < L)
            *reinterpret_cast<float2*>(out + base + f * row_stride + 8 * n + 2 * t) =
                make_float2(o[mi][n][2 * hf], o[mi][n][2 * hf + 1]);
        }
  }
}

int sm_count() {
  int dev = 0, n = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  return n;
}

template <int D>
int launch_bf16(const void* q, const void* k, const void* v, void* out, long long ntasks,
                int L, int S, int H, cudaStream_t st) {
  const int smem = BF16_WARPS * 6 * ShortCfg<D>::TILE * (int)sizeof(bf16);
  cudaFuncSetAttribute(short_attn_bf16_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       smem);
  const long long want = (ntasks + BF16_WARPS - 1) / BF16_WARPS;
  const long long cap = (long long)sm_count() * ShortCfg<D>::BLOCKS_PER_SM;
  short_attn_bf16_kernel<D><<<(unsigned)(want < cap ? want : cap), BF16_WARPS * 32, smem, st>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)out, ntasks, L, S, H,
      1.4426950408889634f / sqrtf((float)D));
  return (int)cudaGetLastError();
}

template <int D>
int launch_f32(const void* q, const void* k, const void* v, void* out, long long ntasks,
               int L, int S, int H, cudaStream_t st) {
  const int smem = F32_WARPS * 9 * ShortCfg<D>::TILE * (int)sizeof(bf16);
  cudaFuncSetAttribute(short_attn_f32_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       smem);
  const long long want = (ntasks + F32_WARPS - 1) / F32_WARPS;
  const long long cap = (long long)sm_count() * 8;
  short_attn_f32_kernel<D><<<(unsigned)(want < cap ? want : cap), F32_WARPS * 32, smem, st>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)out, ntasks, L, S, H,
      1.4426950408889634f / sqrtf((float)D));
  return (int)cudaGetLastError();
}

int dispatch(const void* q, const void* k, const void* v, void* out, int B, int T, int S,
             int H, int D, int dtype, cudaStream_t st) {
  if (T < 1 || T > ROWS) return (int)cudaErrorInvalidValue;
  const long long ntasks = (long long)B * S * H;
  if (ntasks == 0) return (int)cudaGetLastError();
  if (dtype == mofa::kBF16) {
    if (D == 64) return launch_bf16<64>(q, k, v, out, ntasks, T, S, H, st);
    if (D == 128) return launch_bf16<128>(q, k, v, out, ntasks, T, S, H, st);
  } else if (dtype == mofa::kF32) {
    if (D == 64) return launch_f32<64>(q, k, v, out, ntasks, T, S, H, st);
    if (D == 128) return launch_f32<128>(q, k, v, out, ntasks, T, S, H, st);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// q/k/v/out [B*T, S, H*D] contiguous, 16-byte aligned; T <= 32, D in {64, 128}.
extern "C" int mofa_tmajor_attention(const void* q, const void* k, const void* v,
                                     void* out, int B, int T, int S, int H, int D,
                                     int dtype, void* stream) {
  return dispatch(q, k, v, out, B, T, S, H, D, dtype, (cudaStream_t)stream);
}

// q/k/v/out [B, L, H, D] contiguous, 16-byte aligned; L <= 32, D in {64, 128}.
extern "C" int mofa_short_attention(const void* q, const void* k, const void* v,
                                    void* out, int B, int L, int H, int D, int dtype,
                                    void* stream) {
  return dispatch(q, k, v, out, B, L, 1, H, D, dtype, (cudaStream_t)stream);
}
