// Partition-boundary int8 quantization for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels `quantize` (`_quant_kernel`) and
// `dequantize` (`_dequant_kernel`) of src/repro/kernels/boundary_quant/
// kernel.py.  Symmetric per-row int8:
//   scale = max|x| / 127 + 1e-12            (f32, one per row)
//   q     = clip(rint(x / scale), -127, 127) (round half to even)
//   out   = (q * scale) cast to the target dtype
//
// Bound on the card: bytes.  Each element is read once and written once as a
// byte (quantize) or 2-4 bytes (dequantize), a handful of operations per
// element.  The design: one block per row, so any row count N works with no
// divisor-block search; the row's max is a block reduction (warp shuffles,
// then one shared-memory pass); threads stride the row so neighbouring
// threads touch neighbouring addresses.  The second pass over the row hits
// L1/L2, so device memory sees each input byte about once.
//
// Bit-exactness with the plain version: the scale is `amax / 127.0f +
// 1e-12f` in f32, `x / scale` is an IEEE divide (built with -prec-div=true,
// never with fast math), and rounding is rintf (half to even), as
// torch.round and jnp.round are.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
enum { kF32 = 0, kBF16 = 1 };

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// Max over the block; every thread gets the result.  Inputs are >= 0.
__device__ float block_max(float v) {
  __shared__ float warp_max[kThreads / 32];
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warp_max[warp] = v;
  __syncthreads();
  v = lane < kThreads / 32 ? warp_max[lane] : 0.0f;
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
quantize_kernel(const T* __restrict__ x, int8_t* __restrict__ q,
                float* __restrict__ scale, int D) {
  const int64_t row = blockIdx.x;
  const T* xr = x + row * D;
  int8_t* qr = q + row * D;
  float amax = 0.0f;
  for (int i = threadIdx.x; i < D; i += kThreads) amax = fmaxf(amax, fabsf(to_f32(xr[i])));
  amax = block_max(amax);
  const float s = amax / 127.0f + 1e-12f;
  for (int i = threadIdx.x; i < D; i += kThreads) {
    const float r = rintf(to_f32(xr[i]) / s);
    qr[i] = static_cast<int8_t>(fminf(fmaxf(r, -127.0f), 127.0f));
  }
  if (threadIdx.x == 0) scale[row] = s;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
dequantize_kernel(const int8_t* __restrict__ q, const float* __restrict__ scale,
                  T* __restrict__ out, int D) {
  const int64_t row = blockIdx.x;
  const float s = scale[row];
  const int8_t* qr = q + row * D;
  T* orow = out + row * D;
  for (int i = threadIdx.x; i < D; i += kThreads)
    store(orow + i, static_cast<float>(qr[i]) * s);
}

}  // namespace

extern "C" int bq_quantize(const void* x, void* q, void* scale, int N, int D,
                           int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kBF16)
    quantize_kernel<<<N, kThreads, 0, st>>>(static_cast<const __nv_bfloat16*>(x),
                                            static_cast<int8_t*>(q),
                                            static_cast<float*>(scale), D);
  else if (dtype == kF32)
    quantize_kernel<<<N, kThreads, 0, st>>>(static_cast<const float*>(x),
                                            static_cast<int8_t*>(q),
                                            static_cast<float*>(scale), D);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int bq_dequantize(const void* q, const void* scale, void* out, int N,
                             int D, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kBF16)
    dequantize_kernel<<<N, kThreads, 0, st>>>(static_cast<const int8_t*>(q),
                                              static_cast<const float*>(scale),
                                              static_cast<__nv_bfloat16*>(out), D);
  else if (dtype == kF32)
    dequantize_kernel<<<N, kThreads, 0, st>>>(static_cast<const int8_t*>(q),
                                              static_cast<const float*>(scale),
                                              static_cast<float*>(out), D);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
