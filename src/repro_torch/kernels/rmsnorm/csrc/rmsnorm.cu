// Fused RMSNorm for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `rmsnorm` of src/repro/kernels/rmsnorm/
// kernel.py, the same math as `models.common.rms_norm`:
//   out = cast(x * rsqrt(mean(x^2) + eps), dtype(x)) * w
// with the sum of squares and the normalisation in f32, a rounding to x's
// dtype before the weight multiply, and a second rounding after it.
//
// Bound on the card: bytes.  Per element it reads x and w and writes out, and
// does about four operations.  The design: one block per row (any row count,
// any width); the f32 sum of squares is a block reduction (warp shuffles, one
// shared-memory pass); threads stride the row so accesses coalesce.  The
// second pass over x reads it back from L1/L2, so device memory sees x once.
// Vectorised 16-byte loads are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
enum { kF32 = 0, kBF16 = 1 };

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
// round an f32 value to T and back: the cast the reference makes to x's dtype
__device__ __forceinline__ float round_as(float v, const float*) { return v; }
__device__ __forceinline__ float round_as(float v, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(v));
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// Sum over the block; every thread gets the result.
__device__ float block_sum(float v) {
  __shared__ float warp_sum[kThreads / 32];
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warp_sum[warp] = v;
  __syncthreads();
  v = lane < kThreads / 32 ? warp_sum[lane] : 0.0f;
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
rmsnorm_kernel(const T* __restrict__ x, const T* __restrict__ w,
               T* __restrict__ out, int D, float eps) {
  const int64_t row = blockIdx.x;
  const T* xr = x + row * D;
  T* orow = out + row * D;
  float ss = 0.0f;
  for (int i = threadIdx.x; i < D; i += kThreads) {
    const float v = to_f32(xr[i]);
    ss += v * v;
  }
  ss = block_sum(ss);
  const float inv = rsqrtf(ss / static_cast<float>(D) + eps);
  for (int i = threadIdx.x; i < D; i += kThreads) {
    const float n = round_as(to_f32(xr[i]) * inv, xr);
    store(orow + i, n * to_f32(w[i]));
  }
}

}  // namespace

extern "C" int rmsnorm_forward(const void* x, const void* w, void* out, int N,
                               int D, float eps, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kBF16)
    rmsnorm_kernel<<<N, kThreads, 0, st>>>(static_cast<const __nv_bfloat16*>(x),
                                           static_cast<const __nv_bfloat16*>(w),
                                           static_cast<__nv_bfloat16*>(out), D, eps);
  else if (dtype == kF32)
    rmsnorm_kernel<<<N, kThreads, 0, st>>>(static_cast<const float*>(x),
                                           static_cast<const float*>(w),
                                           static_cast<float*>(out), D, eps);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
