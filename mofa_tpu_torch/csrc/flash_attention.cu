// Flash attention forward: softmax(Q K^T / sqrt(D)) V over [B, L, H, D].
//
// Replaces mofa_tpu/kernels/flash_attention.py::_flash_fwd_kernel. The TPU
// kernel keeps one head's whole K/V in VMEM and runs a clamped fixed-max
// softmax by default; here one block of 4 warps takes 64 query rows of one
// (batch, head) and loops over 64-key K/V tiles, with the EXACT online-max
// softmax (running max and sum per row).
//
// bf16 path (the main path), FlashAttention-2 style on tensor cores with
// `mma.sync.m16n8k16` (bf16 in, fp32 accumulate). Each warp owns 16 query
// rows: its Q fragments, the S = Q K^T tile, the running max / sum and the
// fp32 output accumulator all stay in registers (the mma fragment layout
// is documented, so the softmax runs on the accumulator registers, and the
// S accumulators are re-packed in place as the A operand of P V). K/V
// tiles are double-buffered in shared memory with `cp.async`, so the next
// tile's load overlaps this tile's math; V's B operand comes through
// `ldmatrix.trans`. Bound: tensor-core issue and the exp2 of the softmax;
// device memory sees one read of q/k/v and one write of out. D in {64,
// 128}; a ragged L is zero-filled by the copy and masked in the softmax.
//
// fp32 path (composition checks, tests): one thread per query row with q
// and the accumulator in registers, K/V tiles broadcast from shared memory.
// Plain FMA, exact fp32; not meant to be fast.
#include "common.cuh"

using bf16 = __nv_bfloat16;

namespace {

constexpr int BQ = 64, BK = 64, NWARPS = 4;

// async copy of rows [r0, r0 + 64) of one head into a [64][D + 8] tile
template <int D>
__device__ __forceinline__ void load_tile_async(bf16* dst, const bf16* src, int r0, int L,
                                                long long ld, int tid) {
  constexpr int VPR = D / 8, LDT = D + 8;
  for (int i = tid; i < 64 * VPR; i += NWARPS * 32) {
    const int r = i / VPR, c = (i % VPR) * 8;
    const bool ok = r0 + r < L;
    const bf16* g = src + (long long)(ok ? r0 + r : 0) * ld + c;
    mofa::cp_async16(dst + r * LDT + c, g, ok ? 16 : 0);
  }
}

template <int D>
__global__ void __launch_bounds__(NWARPS * 32) flash_bf16_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    bf16* __restrict__ out, int Lq, int Lk, int H, float scale_log2) {
  constexpr int LDT = D + 8;                    // bf16 pitch of every tile
  constexpr int TILE = 64 * LDT;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* Ks = Qs + TILE;                         // 2 buffers
  bf16* Vs = Ks + 2 * TILE;                     // 2 buffers

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t = lane & 3;        // mma group / thread in group
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int q0 = blockIdx.x * BQ;
  const long long ld = (long long)H * D;
  const bf16* qb = q + (long long)b * Lq * ld + (long long)h * D;
  const bf16* kb = k + (long long)b * Lk * ld + (long long)h * D;
  const bf16* vb = v + (long long)b * Lk * ld + (long long)h * D;
  const int ntiles = (Lk + BK - 1) / BK;

  load_tile_async<D>(Qs, qb, q0, Lq, ld, tid);
  load_tile_async<D>(Ks, kb, 0, Lk, ld, tid);
  load_tile_async<D>(Vs, vb, 0, Lk, ld, tid);
  mofa::cp_async_commit();

  uint32_t qf[D / 16][4];                       // Q as A fragments
  float o[D / 8][4];                            // O accumulator (16 x D)
#pragma unroll
  for (int n = 0; n < D / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.0f;
  float m0 = -INFINITY, m1 = -INFINITY;         // running max, rows g / g+8
  float l0 = 0.0f, l1 = 0.0f;                   // running sum (this thread's part)
  const int wr = warp * 16;

  for (int it = 0; it < ntiles; ++it) {
    const int buf = it & 1;
    if (it + 1 < ntiles) {
      load_tile_async<D>(Ks + (buf ^ 1) * TILE, kb, (it + 1) * BK, Lk, ld, tid);
      load_tile_async<D>(Vs + (buf ^ 1) * TILE, vb, (it + 1) * BK, Lk, ld, tid);
      mofa::cp_async_commit();
      mofa::cp_async_wait<1>();
    } else {
      mofa::cp_async_wait<0>();
    }
    __syncthreads();
    if (it == 0) {
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const bf16* r0 = Qs + (wr + g) * LDT + kk * 16 + 2 * t;
        const bf16* r8 = r0 + 8 * LDT;
        qf[kk][0] = *reinterpret_cast<const uint32_t*>(r0);
        qf[kk][1] = *reinterpret_cast<const uint32_t*>(r8);
        qf[kk][2] = *reinterpret_cast<const uint32_t*>(r0 + 8);
        qf[kk][3] = *reinterpret_cast<const uint32_t*>(r8 + 8);
      }
    }
    const bf16* Kt = Ks + buf * TILE;
    const bf16* Vt = Vs + buf * TILE;

    // S = Q K^T (16 x 64 per warp), 8 n-tiles of 16x8
    float s[BK / 8][4];
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.0f;
      const bf16* kr = Kt + (j * 8 + g) * LDT + 2 * t;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(kr + kk * 16);
        const uint32_t b1 = *reinterpret_cast<const uint32_t*>(kr + kk * 16 + 8);
        mofa::mma_bf16(s[j], qf[kk], b0, b1);
      }
    }

    // online softmax in base 2 on the accumulator registers
    const int kbase = it * BK + 2 * t;
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool valid = kbase + j * 8 + (e & 1) < Lk;
        s[j][e] = valid ? s[j][e] * scale_log2 : -INFINITY;
      }
      mx0 = fmaxf(mx0, fmaxf(s[j][0], s[j][1]));
      mx1 = fmaxf(mx1, fmaxf(s[j][2], s[j][3]));
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float c0 = exp2f(m0 - mn0), c1 = exp2f(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    float sum0 = 0.0f, sum1 = 0.0f;
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      s[j][0] = exp2f(s[j][0] - mn0);
      s[j][1] = exp2f(s[j][1] - mn0);
      s[j][2] = exp2f(s[j][2] - mn1);
      s[j][3] = exp2f(s[j][3] - mn1);
      sum0 += s[j][0] + s[j][1];
      sum1 += s[j][2] + s[j][3];
    }
    l0 = l0 * c0 + sum0;
    l1 = l1 * c1 + sum1;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      o[n][0] *= c0;
      o[n][1] *= c0;
      o[n][2] *= c1;
      o[n][3] *= c1;
    }

    // O += P V: the S accumulators of n-tiles (2kk, 2kk+1) are the A
    // fragment of k-chunk kk; V's B fragments via ldmatrix.trans
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint32_t pa[4] = {mofa::pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                              mofa::pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              mofa::pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              mofa::pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
      const bf16* vrow = Vt + (kk * 16 + (lane & 15)) * LDT;
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        uint32_t b0, b1;
        mofa::ldsm_x2_trans(b0, b1, vrow + n * 8);
        mofa::mma_bf16(o[n], pa, b0, b1);
      }
    }
    __syncthreads();                            // this buffer is refilled next
  }

  // finish the row sums across the 4 threads of each group, normalise, store
  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float inv0 = 1.0f / l0, inv1 = 1.0f / l1;
  bf16* ob = out + (long long)b * Lq * ld + (long long)h * D;
  const int row0 = q0 + wr + g, row1 = row0 + 8;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    const int col = n * 8 + 2 * t;
    if (row0 < Lq)
      *reinterpret_cast<__nv_bfloat162*>(ob + (long long)row0 * ld + col) =
          __floats2bfloat162_rn(o[n][0] * inv0, o[n][1] * inv0);
    if (row1 < Lq)
      *reinterpret_cast<__nv_bfloat162*>(ob + (long long)row1 * ld + col) =
          __floats2bfloat162_rn(o[n][2] * inv1, o[n][3] * inv1);
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

template <int D>
int launch_bf16(const void* q, const void* k, const void* v, void* out, int B, int Lq,
                int Lk, int H, cudaStream_t st) {
  const size_t smem = (size_t)5 * 64 * (D + 8) * sizeof(bf16);   // Q + 2 K + 2 V
  cudaFuncSetAttribute(flash_bf16_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  const dim3 grid((Lq + BQ - 1) / BQ, B * H);
  const float scale_log2 = 1.4426950408889634f / sqrtf((float)D);
  flash_bf16_kernel<D><<<grid, NWARPS * 32, smem, st>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)out, Lq, Lk, H, scale_log2);
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
    if (D == 64) return launch_bf16<64>(q, k, v, out, B, Lq, Lk, H, st);
    if (D == 128) return launch_bf16<128>(q, k, v, out, B, Lq, Lk, H, st);
  } else if (dtype == mofa::kF32) {
    if (D == 64) return launch_f32<64>(q, k, v, out, B, Lq, Lk, H, st);
    if (D == 128) return launch_f32<128>(q, k, v, out, B, Lq, Lk, H, st);
  }
  return (int)cudaErrorInvalidValue;
}
