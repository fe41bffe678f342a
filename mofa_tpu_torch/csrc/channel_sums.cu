// Per-(N, C) fp32 sums of x and x^2 over the middle axis of x3 [N, S, C]:
// the statistics pass of GroupNorm.
//
// Replaces mofa_tpu/kernels/group_norm.py::_stats_kernel (`_channel_sums`).
// The TPU kernel walks S sequentially on one core and carries the [1, C]
// sums in a revisited output block; Hopper blocks run in parallel and in no
// order, so here each block reduces one slab of S rows of one n and the
// slabs meet in fp32 atomicAdds on the zero-filled [N, C] outputs (the sum
// order therefore changes from run to run, in the last bits).
//
// Layout of a block: C / VEC threads along C, each reading 16 bytes (VEC
// channels) of a row, so a warp reads contiguous 512-byte runs; K such
// groups of threads take rows r, r + K, ... of the slab, four loads in
// flight each, and keep their 2 x VEC partial sums in registers. The K
// partial rows meet in shared memory, and one atomicAdd per channel and
// statistic leaves the block.
//
// Bound: device memory, one read of x (at [50, 9216, 320] bf16, 295 MB:
// 0.088 ms at 3.35 TB/s); the FLOPs (two per element) and the atomics
// (2*C per block) are small beside it.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;       // target threads per block
constexpr int ROWS_PER_THREAD = 32;

template <typename T>
__device__ __forceinline__ void accumulate(const uint4& v, float* s1, float* s2) {
  constexpr int VEC = 16 / sizeof(T);
  const T* e = reinterpret_cast<const T*>(&v);
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    const float f = mofa::to_f32(e[i]);
    s1[i] += f;
    s2[i] = fmaf(f, f, s2[i]);
  }
}

template <typename T>
__global__ void channel_sums_kernel(const T* __restrict__ x, float* __restrict__ s1,
                                    float* __restrict__ s2, long long S, int C, int K,
                                    long long slab) {
  constexpr int VEC = 16 / sizeof(T);
  extern __shared__ float red[];             // [2][K][C]
  const int CH = C / VEC;
  const int tid = threadIdx.x, chunk = tid % CH, ry = tid / CH;
  const int n = blockIdx.y;
  const long long r0 = (long long)blockIdx.x * slab;
  const long long r1 = r0 + slab < S ? r0 + slab : S;
  const T* base = x + (long long)n * S * C + chunk * VEC;

  float a1[VEC], a2[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) a1[i] = a2[i] = 0.0f;
  long long r = r0 + ry;
  for (; r + 3LL * K < r1; r += 4LL * K) {
    const uint4 v0 = __ldg(reinterpret_cast<const uint4*>(base + r * C));
    const uint4 v1 = __ldg(reinterpret_cast<const uint4*>(base + (r + K) * C));
    const uint4 v2 = __ldg(reinterpret_cast<const uint4*>(base + (r + 2LL * K) * C));
    const uint4 v3 = __ldg(reinterpret_cast<const uint4*>(base + (r + 3LL * K) * C));
    accumulate<T>(v0, a1, a2);
    accumulate<T>(v1, a1, a2);
    accumulate<T>(v2, a1, a2);
    accumulate<T>(v3, a1, a2);
  }
  for (; r < r1; r += K) accumulate<T>(__ldg(reinterpret_cast<const uint4*>(base + r * C)), a1, a2);

#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    red[ry * C + chunk * VEC + i] = a1[i];
    red[(K + ry) * C + chunk * VEC + i] = a2[i];
  }
  __syncthreads();
  for (int c = tid; c < C; c += blockDim.x) {
    float t1 = 0.0f, t2 = 0.0f;
    for (int j = 0; j < K; ++j) {
      t1 += red[j * C + c];
      t2 += red[(K + j) * C + c];
    }
    atomicAdd(s1 + (long long)n * C + c, t1);
    atomicAdd(s2 + (long long)n * C + c, t2);
  }
}

template <typename T>
int launch(const void* x, void* s1, void* s2, int N, long long S, int C, cudaStream_t st) {
  constexpr int VEC = 16 / sizeof(T);
  if (C % VEC || C / VEC > THREADS) return (int)cudaErrorInvalidValue;
  const int CH = C / VEC;
  const int K = THREADS / CH;                // row groups per block
  const long long slab = (long long)K * ROWS_PER_THREAD;
  const size_t smem = (size_t)2 * K * C * sizeof(float);
  const long long slabs = (S + slab - 1) / slab;
  if (N > 0 && slabs > 0)
    channel_sums_kernel<T><<<dim3((unsigned)slabs, (unsigned)N), K * CH, smem, st>>>(
        (const T*)x, (float*)s1, (float*)s2, S, C, K, slab);
  return (int)cudaGetLastError();
}

}  // namespace

// x [N, S, C] contiguous, 16-byte aligned; s1/s2 [N, C] fp32, zero-filled by
// the caller. dtype 0 = fp32, 1 = bf16; C a multiple of 16 bytes' worth of
// values, at most 256 such loads.
extern "C" int mofa_channel_sums(const void* x, void* s1, void* s2, int N, int S, int C,
                                 int dtype, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == mofa::kBF16) return launch<__nv_bfloat16>(x, s1, s2, N, S, C, st);
  if (dtype == mofa::kF32) return launch<float>(x, s1, s2, N, S, C, st);
  return (int)cudaErrorInvalidValue;
}
