// Forward splat (softsplat's scatter) and its normalisation, channel-last.
//
// Replaces mofa_tpu/kernels/softsplat_pallas.py::splat_pallas (the TPU's
// one-hot-matmul splat). The TPU formulation exists only because the TPU
// has no atomics; Hopper reduces into device memory from every SM, so the
// splat is a scatter: each source pixel adds w * m * x into the 4
// floor/ceil taps of (x + dx, y + dy), and w * m into a separate [B, H, W]
// fp32 normaliser plane (m = 1 for 'avg', the metric for 'linear' /
// 'soft'; no plane for 'sum'). Out-of-bounds taps and non-finite flow are
// dropped, in the TPU kernel's tap order.
//
// The main path splats one [h, w, C] feature map of each of the two CFG
// halves along the 24 flows of a video ([48, 72, 128, 320] at /8), so the
// source is read where it lies, in its own dtype (bf16 there): output
// frame b reads source frame b / fps. The 24 frames of a half share one
// 5.9 MB source, which stays in L2, instead of a 566 MB fp32 copy with a
// ones channel appended (C + 1 = 321, no row 16-byte aligned).
//
// `splat_kernel`: one thread per (output frame, source pixel, piece of VEC
// channels), pieces fastest, so consecutive lanes take consecutive 16-byte
// pieces of a pixel's row and every tap's reduction is one coalesced run
// of vector reductions (`atomicAdd` on float4, `red.global.add.v4.f32` on
// sm_90) into the fp32 accumulator; VEC = 1 (scalar atomics) takes a C
// that is not a multiple of 4. The piece-0 thread of a pixel also adds
// the tap's w * m to the normaliser plane. Bound: the accumulator's
// traffic (zeroed by the wrapper, then read and written once per tap
// through L2: it does not fit there at /8) against 8 * C flop per pixel.
// `normalize_kernel`: out = acc / f(norm) with the wrapper's eps policy
// ('-addeps' norm + 1e-7, '-zeroeps' 1 where norm == 0, '-clipeps'
// max(norm, 1e-7); none for 'sum'), cast to the source dtype, one pass.
// Sum order is run-dependent (atomics), so results agree with a serial sum
// to fp32 rounding only.
#include <algorithm>

#include "common.cuh"

namespace {

constexpr int NT = 256;

template <typename T, int VEC>
struct Piece;
template <>
struct Piece<float, 4> {
  static __device__ __forceinline__ void load(const float* p, float* v) {
    const float4 q = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
  }
};
template <>
struct Piece<__nv_bfloat16, 4> {
  static __device__ __forceinline__ void load(const __nv_bfloat16* p, float* v) {
    const uint2 q = __ldg(reinterpret_cast<const uint2*>(p));
    const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&q.x));
    const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&q.y));
    v[0] = a.x, v[1] = a.y, v[2] = b.x, v[3] = b.y;
  }
};
template <typename T>
struct Piece<T, 1> {
  static __device__ __forceinline__ void load(const T* p, float* v) { v[0] = mofa::to_f32(p[0]); }
};

template <int VEC>
__device__ __forceinline__ void reduce_add(float* dst, const float* v, float w);
template <>
__device__ __forceinline__ void reduce_add<4>(float* dst, const float* v, float w) {
  atomicAdd(reinterpret_cast<float4*>(dst), make_float4(v[0] * w, v[1] * w, v[2] * w, v[3] * w));
}
template <>
__device__ __forceinline__ void reduce_add<1>(float* dst, const float* v, float w) {
  atomicAdd(dst, v[0] * w);
}

// grid (pixel-piece blocks, B); src [B / fps, H, W, C], flow [B, H, W, 2],
// metric [B, H, W] or null (m = 1), acc [B, H, W, C], norm [B, H, W] or null
template <typename T, int VEC>
__global__ void __launch_bounds__(NT) splat_kernel(
    const T* __restrict__ src, const float* __restrict__ flow, const float* __restrict__ metric,
    float* __restrict__ acc, float* __restrict__ norm, int H, int W, int C, int fps) {
  const int pieces = C / VEC;
  const long long HW = (long long)H * W;
  const long long idx = (long long)blockIdx.x * NT + threadIdx.x;
  if (idx >= HW * pieces) return;
  const int b = blockIdx.y;
  const int j = (int)(idx % pieces);
  const long long p = idx / pieces;                 // y * W + x
  const int y = (int)(p / W), x = (int)(p % W);
  const long long bp = (long long)b * HW + p;

  const float tx = (float)x + flow[2 * bp];
  const float ty = (float)y + flow[2 * bp + 1];
  if (!isfinite(tx) || !isfinite(ty)) return;
  const float m = metric ? metric[bp] : 1.0f;
  float v[VEC];
  Piece<T, VEC>::load(src + ((long long)(b / fps) * HW + p) * C + j * VEC, v);
#pragma unroll
  for (int i = 0; i < VEC; ++i) v[i] *= m;          // x * m, then * w: the wrapper's order

  const float x0 = floorf(tx), y0 = floorf(ty);
  const float x1 = x0 + 1.0f, y1 = y0 + 1.0f;
  const float xs[4] = {x0, x1, x0, x1};
  const float ys[4] = {y0, y0, y1, y1};
  const float ws[4] = {(x1 - tx) * (y1 - ty), (tx - x0) * (y1 - ty), (x1 - tx) * (ty - y0),
                       (tx - x0) * (ty - y0)};
  float* const acc_b = acc + (long long)b * HW * C;
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    if (xs[t] >= 0.0f && xs[t] < (float)W && ys[t] >= 0.0f && ys[t] < (float)H) {
      const long long q = (long long)ys[t] * W + (long long)xs[t];
      reduce_add<VEC>(acc_b + q * C + j * VEC, v, ws[t]);
      if (norm != nullptr && j == 0) atomicAdd(norm + (long long)b * HW + q, m * ws[t]);
    }
  }
}

// out [R, C] = acc / f(norm[R]) in T; eps: 0 addeps, 1 zeroeps, 2 clipeps,
// -1 no normaliser ('sum': a cast)
template <typename T, int VEC>
__global__ void __launch_bounds__(NT) normalize_kernel(const float* __restrict__ acc,
                                                       const float* __restrict__ norm,
                                                       T* __restrict__ out, int R, int C,
                                                       int eps) {
  const int pieces = C / VEC;
  for (long long i = (long long)blockIdx.x * NT + threadIdx.x; i < (long long)R * pieces;
       i += (long long)gridDim.x * NT) {
    const long long r = i / pieces;
    float d = 1.0f;
    if (eps >= 0) {
      d = norm[r];
      d = eps == 0 ? d + 1e-7f : eps == 1 ? (d == 0.0f ? 1.0f : d) : fmaxf(d, 1e-7f);
    }
    const float* a = acc + i * VEC;
    T* o = out + i * VEC;
    if constexpr (VEC == 4) {
      const float4 q = *reinterpret_cast<const float4*>(a);
      if constexpr (sizeof(T) == 4) {
        *reinterpret_cast<float4*>(o) = make_float4(q.x / d, q.y / d, q.z / d, q.w / d);
      } else {
        *reinterpret_cast<uint2*>(o) =
            make_uint2(mofa::pack_bf16(q.x / d, q.y / d), mofa::pack_bf16(q.z / d, q.w / d));
      }
    } else {
      o[0] = mofa::from_f32<T>(a[0] / d);
    }
  }
}

template <typename T, int VEC>
int launch_splat(const void* src, const void* flow, const void* metric, void* acc, void* norm,
                 int B, int H, int W, int C, int fps, cudaStream_t st) {
  const long long work = (long long)H * W * (C / VEC);
  if (B > 0 && work > 0)
    splat_kernel<T, VEC><<<dim3((unsigned)((work + NT - 1) / NT), B), NT, 0, st>>>(
        (const T*)src, (const float*)flow, (const float*)metric, (float*)acc, (float*)norm, H,
        W, C, fps);
  return (int)cudaGetLastError();
}

template <typename T, int VEC>
int launch_normalize(const void* acc, const void* norm, void* out, int R, int C, int eps,
                     cudaStream_t st) {
  const long long work = (long long)R * (C / VEC);
  if (work > 0) {
    const long long blocks = std::min((work + NT - 1) / NT, 132LL * 16);
    normalize_kernel<T, VEC><<<(unsigned)blocks, NT, 0, st>>>((const float*)acc, (const float*)norm,
                                                             (T*)out, R, C, eps);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// src [B / fps, H, W, C] in `dtype` (0 fp32, 1 bf16); flow [B, H, W, 2]
// fp32; metric [B, H, W] fp32 or null; acc [B, H, W, C] and norm [B, H, W]
// (or null) fp32, zero-filled. C % 4 == 0 with 16-byte aligned acc and
// 8-byte (bf16) / 16-byte (fp32) aligned src takes the vector route.
extern "C" int mofa_softsplat(const void* src, const void* flow, const void* metric, void* acc,
                              void* norm, int B, int H, int W, int C, int fps, int dtype,
                              void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (fps <= 0 || B % fps) return (int)cudaErrorInvalidValue;
  const bool vec = C % 4 == 0;
  if (dtype == mofa::kF32)
    return vec ? launch_splat<float, 4>(src, flow, metric, acc, norm, B, H, W, C, fps, st)
               : launch_splat<float, 1>(src, flow, metric, acc, norm, B, H, W, C, fps, st);
  if (dtype == mofa::kBF16)
    return vec ? launch_splat<__nv_bfloat16, 4>(src, flow, metric, acc, norm, B, H, W, C, fps, st)
               : launch_splat<__nv_bfloat16, 1>(src, flow, metric, acc, norm, B, H, W, C, fps, st);
  return (int)cudaErrorInvalidValue;
}

// acc [R, C] fp32, norm [R] fp32 (null with eps = -1) -> out [R, C] in dtype
extern "C" int mofa_softsplat_normalize(const void* acc, const void* norm, void* out, int R,
                                        int C, int eps, int dtype, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const bool vec = C % 4 == 0;
  if (dtype == mofa::kF32)
    return vec ? launch_normalize<float, 4>(acc, norm, out, R, C, eps, st)
               : launch_normalize<float, 1>(acc, norm, out, R, C, eps, st);
  if (dtype == mofa::kBF16)
    return vec ? launch_normalize<__nv_bfloat16, 4>(acc, norm, out, R, C, eps, st)
               : launch_normalize<__nv_bfloat16, 1>(acc, norm, out, R, C, eps, st);
  return (int)cudaErrorInvalidValue;
}
