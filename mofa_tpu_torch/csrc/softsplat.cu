// Raw bilinear forward splat (softsplat's scatter), fp32, channel-last.
//
// Replaces mofa_tpu/kernels/softsplat_pallas.py::_splat_kernel (the TPU's
// one-hot-matmul splat). The TPU formulation exists only because the TPU
// has no atomics; Hopper has fp32 atomicAdd in L2, so this is the reference
// CUDA design: one thread per (source pixel, channel) scatters w * x into
// the 4 floor/ceil taps of (x + dx, y + dy). Out-of-bounds taps and
// non-finite flow are dropped.
//
// Bound: the atomics into L2 (4 per element) and the read of the input;
// consecutive threads take consecutive channels of one pixel, so both the
// reads and the 4 atomic streams are coalesced. Sum order is run-dependent
// (atomics), so results agree with a serial sum to fp32 rounding only.
#include <cuda_runtime.h>

namespace {

__global__ void splat_kernel(const float* __restrict__ inp,
                             const float* __restrict__ flow,
                             float* __restrict__ out,
                             int H, int W, int C, long long total) {
  long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const int c = (int)(idx % C);
  const long long p = idx / C;                  // b*H*W + y*W + x
  const int x = (int)(p % W);
  const int y = (int)((p / W) % H);
  const long long img = p / ((long long)H * W) * (long long)H * W;

  const float tx = (float)x + flow[2 * p];
  const float ty = (float)y + flow[2 * p + 1];
  if (!isfinite(tx) || !isfinite(ty)) return;
  const float x0 = floorf(tx), y0 = floorf(ty);
  const float x1 = x0 + 1.0f, y1 = y0 + 1.0f;
  const float v = inp[idx];
  const float xs[4] = {x0, x1, x0, x1};
  const float ys[4] = {y0, y0, y1, y1};
  const float ws[4] = {(x1 - tx) * (y1 - ty), (tx - x0) * (y1 - ty),
                       (x1 - tx) * (ty - y0), (tx - x0) * (ty - y0)};
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    if (xs[t] >= 0.0f && xs[t] < (float)W && ys[t] >= 0.0f && ys[t] < (float)H) {
      const long long q = img + (long long)ys[t] * W + (long long)xs[t];
      atomicAdd(out + q * C + c, v * ws[t]);
    }
  }
}

}  // namespace

extern "C" int mofa_softsplat_f32(const void* inp, const void* flow, void* out,
                                  int B, int H, int W, int C, void* stream) {
  const long long total = (long long)B * H * W * C;
  if (total > 0) {
    const int threads = 256;
    const long long blocks = (total + threads - 1) / threads;
    splat_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
        (const float*)inp, (const float*)flow, (float*)out, H, W, C, total);
  }
  return (int)cudaGetLastError();
}
