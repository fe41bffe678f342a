// Temporal self-attention over the frame axis, read in the natural
// spatial-major rows [B*T, S, H*D] (no spatial<->temporal transposes).
//
// Replaces mofa_tpu/kernels/short_attention.py::_tmajor_kernel. The TPU
// kernel packs BN spatial slots x T frames into one [rows, rows] masked
// matmul per head so the MXU has a large tile; on Hopper the T x T problem
// (T <= 32) maps onto one warp directly: one warp per (b, spatial slot,
// head) stages its T rows of q/k/v (stride S*H*D apart, D contiguous
// values each) in shared memory as fp32, lane u computes the logit
// against key u, the softmax is a warp reduction (exact, max-subtracted),
// and lanes then sweep D for the P*V product.
//
// Bound: device memory (one read of q/k/v and one write of out; about
// T*D FMAs per loaded element pair is small). The row pitch D+1 keeps the
// lane-per-key reads of K free of bank conflicts.
#include "common.cuh"

namespace {

template <typename T, int D>
__global__ void __launch_bounds__(32) tmajor_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ out, int nf, int S, int H, float scale) {
  extern __shared__ float smem[];
  constexpr int P = D + 1;                    // padded row pitch
  float* Qs = smem;
  float* Ks = Qs + nf * P;
  float* Vs = Ks + nf * P;

  const int lane = threadIdx.x;
  const long long g = blockIdx.x;             // (b, s, h) flat, h fastest
  const int h = (int)(g % H);
  const long long bs = g / H;
  const int s = (int)(bs % S);
  const long long b = bs / S;
  const long long HD = (long long)H * D;
  const long long row_stride = (long long)S * HD;   // one frame apart
  const long long base = (b * nf * S + s) * HD + (long long)h * D;

  for (int i = lane; i < nf * D; i += 32) {
    const int t = i / D, d = i % D;
    const long long off = base + t * row_stride + d;
    Qs[t * P + d] = mofa::to_f32(q[off]);
    Ks[t * P + d] = mofa::to_f32(k[off]);
    Vs[t * P + d] = mofa::to_f32(v[off]);
  }
  __syncwarp();

  for (int t = 0; t < nf; ++t) {
    float logit = -INFINITY;
    if (lane < nf) {
      float acc = 0.0f;
#pragma unroll 16
      for (int d = 0; d < D; ++d) acc = fmaf(Qs[t * P + d], Ks[lane * P + d], acc);
      logit = acc * scale;
    }
    const float m = mofa::warp_max(logit);
    float p = lane < nf ? expf(logit - m) : 0.0f;
    p /= mofa::warp_sum(p);
    float o[D / 32];
#pragma unroll
    for (int j = 0; j < D / 32; ++j) o[j] = 0.0f;
    for (int u = 0; u < nf; ++u) {
      const float pu = __shfl_sync(0xffffffffu, p, u);
#pragma unroll
      for (int j = 0; j < D / 32; ++j) o[j] = fmaf(pu, Vs[u * P + lane + 32 * j], o[j]);
    }
    const long long orow = base + t * row_stride;
#pragma unroll
    for (int j = 0; j < D / 32; ++j) out[orow + lane + 32 * j] = mofa::from_f32<T>(o[j]);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* out, int B, int nf,
           int S, int H, cudaStream_t stream) {
  const size_t smem = (size_t)3 * nf * (D + 1) * sizeof(float);
  cudaFuncSetAttribute(tmajor_kernel<T, D>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  const long long blocks = (long long)B * S * H;
  if (blocks > 0)
    tmajor_kernel<T, D><<<(unsigned)blocks, 32, smem, stream>>>(
        (const T*)q, (const T*)k, (const T*)v, (T*)out, nf, S, H,
        1.0f / sqrtf((float)D));
  return (int)cudaGetLastError();
}

}  // namespace

// q/k/v/out [B*T, S, H*D] contiguous; T <= 32, D in {64, 128}.
extern "C" int mofa_tmajor_attention(const void* q, const void* k, const void* v,
                                     void* out, int B, int T, int S, int H, int D,
                                     int dtype, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (T < 1 || T > 32) return (int)cudaErrorInvalidValue;
  if (dtype == mofa::kBF16) {
    if (D == 64) return launch<__nv_bfloat16, 64>(q, k, v, out, B, T, S, H, st);
    if (D == 128) return launch<__nv_bfloat16, 128>(q, k, v, out, B, T, S, H, st);
  } else if (dtype == mofa::kF32) {
    if (D == 64) return launch<float, 64>(q, k, v, out, B, T, S, H, st);
    if (D == 128) return launch<float, 128>(q, k, v, out, B, T, S, H, st);
  }
  return (int)cudaErrorInvalidValue;
}
