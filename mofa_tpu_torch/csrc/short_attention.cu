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
// 32 x 32 x D problem for `mma.sync`.
//
// Bound: device memory (one read of q/k/v, one write of out; the
// products are 2 L^2 D operations per L D values, far under the card's
// ridge). What the design does about it, in both dtypes: every warp walks
// its own (sequence, head) tasks, grid-stride, with the next task's q/k/v
// rows (D contiguous values per frame) in flight through 16-byte
// `cp.async` copies while it computes this one; the exact max-subtracted
// softmax runs in fp32 on S's accumulator fragments, the keys past L
// masked to -inf; the output goes out as 16-byte row writes.
// - bf16 (inference): a block of 4 warps keeps 2 x 4 tasks' rows in
//   shared memory (a double buffer, padded to 32 rows; the padded rows are
//   zeroed once and never loaded); QK^T and PV run on
//   `mma.sync.m16n8k16` from `ldmatrix` fragments (V through the
//   transposed form), P normalised in fp32 and rounded to bf16 as the A
//   operand of PV; O goes back through shared memory.
// - fp32 (training): each warp keeps one task's fp32 q, k and v rows in
//   shared memory (L rows of D + 4 floats, so that the fragment loads hit
//   32 distinct banks: 20 KB a warp at L = 25, D = 64, a block of 4 warps
//   and 2 blocks an SM) in a software pipeline: the next task's q and k
//   are copied in as soon as this task's S = QK^T is taken, while its
//   softmax and PV run, and its v as soon as PV is taken, while the next
//   QK^T runs. Fragment rows past L read row L - 1 (finite: masked keys,
//   zero probabilities, queries never written), so no row past L is
//   loaded or zeroed. Each operand is split in registers into big =
//   tf32(x) and small = tf32(x - big) (`split_tf32`) and each product is
//   taken as small * big + big * small + big * big on
//   `mma.sync.m16n8k8.tf32`, a k-step's three products in a fresh
//   accumulator added in fp32 (the tensor cores' own accumulation
//   truncates): about 22 of fp32's 24 bits. P's accumulator fragment
//   holds keys 2t, 2t + 1 of each 8 where the tf32 A operand wants t,
//   t + 4, so PV takes each step's keys in that order (V's B fragment
//   reads rows 2t and 2t + 1) and P is the A operand as it lies. O goes
//   out from the fragments, lanes t and t ^ 1 trading halves so that each
//   holds 4 consecutive values of one row.
#include "hopper.cuh"

using bf16 = __nv_bfloat16;

namespace {

constexpr int ROWS = 32;                      // frames padded to one tile
constexpr int BF16_WARPS = 4, F32_WARPS = 4;  // warps per block

template <int D>
struct ShortCfg {
  static constexpr int PITCH = D + 8;         // bf16; ldmatrix rows hit distinct banks
  static constexpr int TILE = ROWS * PITCH;   // one of q / k / v, elements
  static constexpr int BLOCKS_PER_SM = D == 64 ? 2 : 1;   // bf16, by shared memory
  static constexpr int F32_PITCH = D + 4;     // fp32; fragment loads hit distinct banks
};

// The exact softmax of S's rows in place: keys >= L masked, max-subtracted,
// normalised in fp32. s[mi][n][e]: row 16 mi + lane/4 + 8 (e/2), key
// 8n + 2 (lane%4) + e%2 (an m16n8 accumulator fragment).
__device__ __forceinline__ void softmax_rows(float (&s)[2][4][4], int L, float scale_log2,
                                             int lane) {
  const int t = lane & 3;
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
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[mi][n][e] *= e < 2 ? inv0 : inv1;
  }
}

// O[32 x D] (rows < L meaningful) of one (sequence, head) from bf16 tiles
// in shared memory. o[mi][n][e]: row 16 mi + lane/4 + 8 (e/2), column
// 8n + 2 (lane%4) + e%2.
template <int D>
__device__ __forceinline__ void attend(const bf16* q, const bf16* k, const bf16* v, int L,
                                       float scale_log2, int lane, float (&o)[2][D / 8][4]) {
  constexpr int P = ShortCfg<D>::PITCH;
  float s[2][4][4];                           // S[32 x 32]: m-tile, 8-key tile
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int n = 0; n < 4; ++n) s[mi][n][0] = s[mi][n][1] = s[mi][n][2] = s[mi][n][3] = 0.0f;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t a[2][4], b[2][4];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
      mofa::ldsm_x4(a[mi], q + (16 * mi + (lane & 15)) * P + kk * 16 + (lane >> 4) * 8);
#pragma unroll
    for (int np = 0; np < 2; ++np)
      mofa::ldsm_x4(b[np], k + (16 * np + ((lane >> 4) << 3) + (lane & 7)) * P + kk * 16 +
                               ((lane >> 3) & 1) * 8);
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int n = 0; n < 4; ++n)
        mofa::mma_bf16(s[mi][n], a[mi], b[n / 2][(n & 1) * 2], b[n / 2][(n & 1) * 2 + 1]);
  }
  softmax_rows(s, L, scale_log2, lane);

  // P rounded to bf16 as the A operand of PV (n-tile n is half n % 2 of
  // k-step n / 2)
  uint32_t pa[2][2][4];                       // m-tile, k-step, register
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      pa[mi][n / 2][(n & 1) * 2] = mofa::pack_bf16(s[mi][n][0], s[mi][n][1]);      // row g
      pa[mi][n / 2][(n & 1) * 2 + 1] = mofa::pack_bf16(s[mi][n][2], s[mi][n][3]);  // row g + 8
    }

  // O = P V over 32 keys (two k-steps); V's B fragments via ldmatrix.trans
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int n = 0; n < D / 8; ++n) o[mi][n][0] = o[mi][n][1] = o[mi][n][2] = o[mi][n][3] = 0.0f;
#pragma unroll
  for (int ks = 0; ks < 2; ++ks)
#pragma unroll
    for (int np = 0; np < D / 16; ++np) {
      uint32_t b[4];
      mofa::ldsm_x4_trans(b, v + (16 * ks + (lane & 15)) * P + np * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        mofa::mma_bf16(o[mi][2 * np], pa[mi][ks], b[0], b[1]);
        mofa::mma_bf16(o[mi][2 * np + 1], pa[mi][ks], b[2], b[3]);
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
    float o[2][D / 8][4];
    attend<D>(buf, buf + TILE, buf + 2 * TILE, L, scale_log2, lane, o);
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

// one operand's L fp32 rows of a task into shared memory (pitch F32_PITCH)
template <int D>
__device__ __forceinline__ void load_f32_rows(float* dst, const float* __restrict__ src,
                                              long long base, long long row_stride, int L,
                                              int lane) {
  constexpr int P = ShortCfg<D>::F32_PITCH, CPR = D / 4;
  for (int i = lane; i < L * CPR; i += 32) {
    const int f = i / CPR, c = (i % CPR) * 4;
    mofa::cp_async16(dst + f * P + c, src + base + f * row_stride + c);
  }
}

// fp32: split TF32 on mma.sync (the source note); each warp walks tasks
// gw, gw + nw, ... through the pipeline of one q / k / v buffer
template <int D>
__global__ void __launch_bounds__(F32_WARPS * 32)
    short_attn_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                          const float* __restrict__ v, float* __restrict__ out,
                          long long ntasks, int L, int S, int H, float scale_log2) {
  constexpr int P = ShortCfg<D>::F32_PITCH;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  float* const qs = reinterpret_cast<float*>(smem_raw) + warp * 3 * L * P;
  float* const ks = qs + L * P;
  float* const vs = ks + L * P;
  const long long row_stride = (long long)S * H * D;
  const long long nw = (long long)gridDim.x * F32_WARPS;
  // shared-memory offsets of this lane's fragment rows, past L read as
  // row L - 1: query / key g + 8i, and the keys 8i + 2t, 8i + 2t + 1 of
  // PV's k-step i
  int rows[4], vrows[4][2];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    rows[i] = min(g + 8 * i, L - 1) * P;
    vrows[i][0] = min(8 * i + 2 * t, L - 1) * P;
    vrows[i][1] = min(8 * i + 2 * t + 1, L - 1) * P;
  }

  long long task = (long long)blockIdx.x * F32_WARPS + warp;
  long long base = task < ntasks ? task_base(task, L, S, H, D) : 0;
  if (task < ntasks) {
    load_f32_rows<D>(qs, q, base, row_stride, L, lane);
    load_f32_rows<D>(ks, k, base, row_stride, L, lane);
  }
  mofa::cp_async_commit();                    // group: the first task's q, k
  if (task < ntasks) load_f32_rows<D>(vs, v, base, row_stride, L, lane);
  mofa::cp_async_commit();                    // group: its v
  for (; task < ntasks; task += nw) {
    const long long next = task + nw;
    const long long next_base = next < ntasks ? task_base(next, L, S, H, D) : 0;
    mofa::cp_async_wait<1>();                 // this task's q, k (its v may be in flight)
    __syncwarp();

    // S = Q K^T, 8 dims a k-step
    float s[2][4][4];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int n = 0; n < 4; ++n) s[mi][n][0] = s[mi][n][1] = s[mi][n][2] = s[mi][n][3] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < D / 8; ++kk) {
      uint32_t qb[2][4], qsm[2][4], kb[4][2], ksm[4][2];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int r = 0; r < 4; ++r)           // a0..a3: rows g, g + 8, g, g + 8; dims t, t, t + 4, t + 4
          mofa::split_tf32(qs[rows[2 * mi + (r & 1)] + 8 * kk + t + 4 * (r >> 1)], qb[mi][r],
                           qsm[mi][r]);
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int r = 0; r < 2; ++r)           // b0, b1: key 8n + g; dims t, t + 4
          mofa::split_tf32(ks[rows[n] + 8 * kk + t + 4 * r], kb[n][r], ksm[n][r]);
      // each product over all 8 tiles before the next: 8 independent
      // accumulators between dependent instructions
      float c[2][4][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          c[mi][n][0] = c[mi][n][1] = c[mi][n][2] = c[mi][n][3] = 0.0f;
          mofa::mma_tf32(c[mi][n], qsm[mi], kb[n][0], kb[n][1]);
        }
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int n = 0; n < 4; ++n) mofa::mma_tf32(c[mi][n], qb[mi], ksm[n][0], ksm[n][1]);
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          mofa::mma_tf32(c[mi][n], qb[mi], kb[n][0], kb[n][1]);
#pragma unroll
          for (int e = 0; e < 4; ++e) s[mi][n][e] += c[mi][n][e];
        }
    }
    __syncwarp();                             // every lane has read q and k
    if (next < ntasks) {
      load_f32_rows<D>(qs, q, next_base, row_stride, L, lane);
      load_f32_rows<D>(ks, k, next_base, row_stride, L, lane);
    }
    mofa::cp_async_commit();

    softmax_rows(s, L, scale_log2, lane);
    // P as the A operand of PV's k-step n: key 8n + 2t as column t, key
    // 8n + 2t + 1 as column t + 4
    uint32_t pb[2][4][4], psm[2][4][4];       // m-tile, k-step, register
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        mofa::split_tf32(s[mi][n][0], pb[mi][n][0], psm[mi][n][0]);   // row g, key 2t
        mofa::split_tf32(s[mi][n][2], pb[mi][n][1], psm[mi][n][1]);   // row g + 8, key 2t
        mofa::split_tf32(s[mi][n][1], pb[mi][n][2], psm[mi][n][2]);   // row g, key 2t + 1
        mofa::split_tf32(s[mi][n][3], pb[mi][n][3], psm[mi][n][3]);   // row g + 8, key 2t + 1
      }
    mofa::cp_async_wait<1>();                 // this task's v (the next q, k may be in flight)
    __syncwarp();

    // O = P V, 8 columns at a time, each written as it is done; a fresh
    // accumulator for each of the 4 k-steps and 2 m-tiles, each product
    // over all 8 before the next
#pragma unroll
    for (int np = 0; np < D / 8; ++np) {
      uint32_t vb[4][2], vsm[4][2];           // k-step; b0, b1: keys 8st + 2t, + 1; column g
#pragma unroll
      for (int st = 0; st < 4; ++st)
#pragma unroll
        for (int r = 0; r < 2; ++r)
          mofa::split_tf32(vs[vrows[st][r] + 8 * np + g], vb[st][r], vsm[st][r]);
      float c[4][2][4];
#pragma unroll
      for (int st = 0; st < 4; ++st)
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          c[st][mi][0] = c[st][mi][1] = c[st][mi][2] = c[st][mi][3] = 0.0f;
          mofa::mma_tf32(c[st][mi], psm[mi][st], vb[st][0], vb[st][1]);
        }
#pragma unroll
      for (int st = 0; st < 4; ++st)
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
          mofa::mma_tf32(c[st][mi], pb[mi][st], vsm[st][0], vsm[st][1]);
#pragma unroll
      for (int st = 0; st < 4; ++st)
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
          mofa::mma_tf32(c[st][mi], pb[mi][st], vb[st][0], vb[st][1]);
      float o[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          o[mi][e] = ((c[0][mi][e] + c[1][mi][e]) + c[2][mi][e]) + c[3][mi][e];
      // lanes t and t ^ 1 trade halves: even t holds row g, columns 2t ..
      // 2t + 3; odd t row g + 8, columns 2t - 2 .. 2t + 1
      const bool odd = t & 1;
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const float x0 = __shfl_xor_sync(0xffffffffu, odd ? o[mi][0] : o[mi][2], 1);
        const float x1 = __shfl_xor_sync(0xffffffffu, odd ? o[mi][1] : o[mi][3], 1);
        const int f = 16 * mi + g + (odd ? 8 : 0);
        if (f < L)
          *reinterpret_cast<float4*>(out + base + f * row_stride + 8 * np + 2 * (t & 2)) =
              odd ? make_float4(x0, x1, o[mi][2], o[mi][3])
                  : make_float4(o[mi][0], o[mi][1], x0, x1);
      }
    }
    __syncwarp();                             // every lane has read v
    if (next < ntasks) load_f32_rows<D>(vs, v, next_base, row_stride, L, lane);
    mofa::cp_async_commit();
    base = next_base;
  }
  mofa::cp_async_wait<0>();
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

// fp32: shared memory grows with L (3 L rows a warp), so the grid is as
// many blocks as the SMs hold at this L
template <int D>
int launch_f32(const void* q, const void* k, const void* v, void* out, long long ntasks,
               int L, int S, int H, cudaStream_t st) {
  const int smem = F32_WARPS * 3 * L * ShortCfg<D>::F32_PITCH * (int)sizeof(float);
  cudaFuncSetAttribute(short_attn_f32_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       smem);
  int per_sm = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, short_attn_f32_kernel<D>,
                                                F32_WARPS * 32, smem);
  const long long want = (ntasks + F32_WARPS - 1) / F32_WARPS;
  const long long cap = (long long)sm_count() * (per_sm > 0 ? per_sm : 1);
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
