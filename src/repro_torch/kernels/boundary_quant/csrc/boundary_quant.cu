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
// element.  At (1024, 2560) bf16 quantize moves 7.9 MB: 2.349 us at 3.35
// TB/s.  After the loads, the limit is the IEEE divide x / scale, a few
// dozen instructions an element (2.6 M divides a call at that shape):
// diagnostic builds, not committed, ran markedly faster with a multiply by
// the reciprocal in its place, which is not bit-equal and is not taken.
//
// quantize.  A row is read once: each thread holds its chunks of the row (8
// elements a chunk, one 16-byte load in bf16, two in f32) in registers from
// the row's max to its write, and writes each chunk as one packed 8-byte
// store of int8.  The launch shape follows D (`ops.launch_plan`, from shapes
// only), as rmsnorm's does:
//  - narrow rows (at most 128 chunks: D <= 1024): a group of up to 32 lanes
//    a row, several rows a block of up to 256 threads (fewer when the rows
//    are few, so that they reach every SM), the max a shuffle within the
//    group; but where the group would be 32 lanes of several chunks and the
//    rows are fewer than four an SM, a block a row of one chunk a thread,
//    so that each SM still runs several warps of divides;
//  - wide rows (D = 2560 at the boundary; up to 4096 chunks, D <= 32768, in
//    bf16, 2048 in f32): a block a row, two chunks a thread (up to eight in
//    bf16 and four in f32 past 1024 chunks), the max a shuffle then one
//    shared-memory pass.
// Blocks walk the rows with a stride of the grid, at most one resident
// wave, each thread loading its chunks of the next row before it reduces
// the current one.  A D that is not a multiple of 8, or a base address off
// the 16-byte grid (a view at an element offset), takes the same kernel
// with element-wise loads and stores in the same register layout.  Wider
// rows (D > 32768 in bf16, D > 16384 in f32) take `quantize_rows_kernel`: a
// block a row, the row read twice (the max, then the divides).  Nothing
// falls back to the plain version.  The version before this one was that
// kernel for every D: one block a row, scalar loads, two passes, byte
// stores (6.478 us at the boundary shape, chip_smoke.py; NVIDIA H100 80GB
// HBM3, 700.00 W).
//
// dequantize: one block a row, threads striding the row.
//
// Bit-exactness with the plain version: the scale is `amax / 127.0f +
// 1e-12f` in f32, `x / scale` is an IEEE divide (`__fdiv_rn`; the library
// is built with -prec-div=true, never with fast math), and rounding is half
// to even, as torch.round and jnp.round are (rintf in the two-pass kernel;
// `quantize_bits`, the same function, in the other).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
enum { kF32 = 0, kBF16 = 1 };

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
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

// Rows past the widest launch plan: a block a row, the row read twice.
template <typename T>
__global__ void __launch_bounds__(kThreads)
quantize_rows_kernel(const T* __restrict__ x, int8_t* __restrict__ q,
                     float* __restrict__ scale, int D) {
  const int64_t row = blockIdx.x;
  const T* xr = x + row * D;
  int8_t* qr = q + row * D;
  float amax = 0.0f;
  for (int i = threadIdx.x; i < D; i += kThreads) amax = fmaxf(amax, fabsf(to_f32(xr[i])));
  amax = block_max(amax);
  const float s = __fdiv_rn(amax, 127.0f) + 1e-12f;
  for (int i = threadIdx.x; i < D; i += kThreads) {
    const float r = rintf(__fdiv_rn(to_f32(xr[i]), s));
    qr[i] = static_cast<int8_t>(fminf(fmaxf(r, -127.0f), 127.0f));
  }
  if (threadIdx.x == 0) scale[row] = s;
}

// q of one element, in the low byte of the result: the IEEE quotient
// clamped to [-127, 127], then rounded half to even by adding 1.5 * 2^23
// (round to nearest even, the float's last place then being 1), which is
// rintf exactly for |v| <= 2^22 and leaves the integer in the low bits as
// two's complement.  Clamping before rounding gives what rounding before
// clamping does, for the clamp's integer bounds, infinities and NaN alike.
// This takes the place of rintf, a float-to-int conversion and a byte pack
// (one quarter-rate conversion each) at no change to a bit.
__device__ __forceinline__ uint32_t quantize_bits(float x, float s) {
  const float v = fminf(fmaxf(__fdiv_rn(x, s), -127.0f), 127.0f);
  return __float_as_uint(__fadd_rn(v, 12582912.0f));
}

// A chunk: 8 consecutive elements of a row, 16 bytes in bf16, 32 in f32.
constexpr int kChunk = 8;
template <typename T>
struct Chunk {
  uint4 v[sizeof(T) / 2];
  __device__ __forceinline__ T& operator[](int e) { return reinterpret_cast<T*>(v)[e]; }
};

// this lane's CPT chunks of a row (elements (j L + i) 8 + e of chunk j);
// outside [0, D) reads as zero
template <typename T, int CPT, bool VEC>
__device__ __forceinline__ void load_row(Chunk<T> (&r)[CPT], const T* p, int D, int i, int L,
                                         bool active) {
#pragma unroll
  for (int j = 0; j < CPT; ++j) {
    const int col = (j * L + i) * kChunk;
    if (VEC) {
#pragma unroll
      for (int k = 0; k < static_cast<int>(sizeof(T) / 2); ++k)
        r[j].v[k] = active && col < D ? reinterpret_cast<const uint4*>(p + col)[k]
                                      : make_uint4(0, 0, 0, 0);
    } else {
#pragma unroll
      for (int e = 0; e < kChunk; ++e)
        r[j][e] = active && col + e < D ? p[col + e] : from_f32<T>(0.0f);
    }
  }
}

// L lanes a row: a power of two up to 32 (blockDim.x / L rows a block), or
// blockDim.x itself, a multiple of 32 up to 512 (one row a block)
template <typename T, int CPT, bool VEC>
__global__ void __launch_bounds__(512)
quantize_kernel(const T* __restrict__ x, int8_t* __restrict__ q, float* __restrict__ scale,
                int64_t N, int D, int L) {
  __shared__ float partial[32];
  const int R = blockDim.x / L;
  const int i = threadIdx.x % L, grp = threadIdx.x / L;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  Chunk<T> xr[CPT], xn[CPT];
  const int64_t stride = static_cast<int64_t>(gridDim.x) * R;
  int64_t row = static_cast<int64_t>(blockIdx.x) * R + grp;
  load_row<T, CPT, VEC>(xn, x + row * D, D, i, L, row < N);
  // `base` is the same for every thread of the block: the reductions below
  // see every lane, active or not.  The next row's loads are issued before
  // this row's max, so one row's latency hides behind the other's divides
  for (int64_t base = static_cast<int64_t>(blockIdx.x) * R; base < N; base += stride) {
    row = base + grp;
    const bool active = row < N;
#pragma unroll
    for (int j = 0; j < CPT; ++j) xr[j] = xn[j];
    if (base + stride < N)
      load_row<T, CPT, VEC>(xn, x + (row + stride) * D, D, i, L, row + stride < N);
    float amax = 0.0f;
#pragma unroll
    for (int j = 0; j < CPT; ++j)
#pragma unroll
      for (int e = 0; e < kChunk; ++e) amax = fmaxf(amax, fabsf(to_f32(xr[j][e])));
    if (L <= 32) {
      for (int o = L / 2; o > 0; o >>= 1) amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
    } else {
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
      if (lane == 0) partial[warp] = amax;
      __syncthreads();
      amax = lane < static_cast<int>(blockDim.x / 32) ? partial[lane] : 0.0f;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
      __syncthreads();  // partial is free for the next row
    }
    const float s = __fdiv_rn(amax, 127.0f) + 1e-12f;
    if (!active) continue;
    if (i == 0) scale[row] = s;
    int8_t* qrow = q + row * D;
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      const int col = (j * L + i) * kChunk;
      if (col >= D) continue;
      union { uint2 u; int8_t b[kChunk]; } o;
      uint32_t w[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        uint32_t b[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) b[e] = quantize_bits(to_f32(xr[j][4 * h + e]), s);
        // the four low bytes, in order
        w[h] = __byte_perm(__byte_perm(b[0], b[1], 0x0040), __byte_perm(b[2], b[3], 0x0040),
                           0x5410);
      }
      o.u = make_uint2(w[0], w[1]);
      if (VEC) {
        *reinterpret_cast<uint2*>(qrow + col) = o.u;
      } else {
#pragma unroll
        for (int e = 0; e < kChunk; ++e)
          if (col + e < D) qrow[col + e] = o.b[e];
      }
    }
  }
}

template <typename T, int CPT, bool VEC>
int launch_quantize(const void* x, void* q, void* scale, int64_t N, int D, int L,
                    cudaStream_t st) {
  int dev = 0, n_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  // narrow rows: as many warps a block (up to 8) as keep every SM busy, so
  // a few rows still spread over the card (the divides are the slow part)
  const int64_t rows_per_warp = L <= 32 ? 32 / L : 1;
  int64_t warps = (N + rows_per_warp * n_sm - 1) / (rows_per_warp * n_sm);
  warps = warps < 1 ? 1 : (warps > kThreads / 32 ? kThreads / 32 : warps);
  const int threads = L <= 32 ? static_cast<int>(warps * 32) : L;
  const int64_t rows_per_block = threads / L;
  const int64_t blocks = (N + rows_per_block - 1) / rows_per_block;
  const int64_t wave = static_cast<int64_t>(n_sm) * (2048 / threads);
  const int grid = static_cast<int>(blocks < wave ? blocks : wave);
  quantize_kernel<T, CPT, VEC><<<grid, threads, 0, st>>>(
      static_cast<const T*>(x), static_cast<int8_t*>(q), static_cast<float*>(scale), N, D, L);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool VEC>
int dispatch_quantize(const void* x, void* q, void* scale, int64_t N, int D, int L, int cpt,
                      cudaStream_t st) {
  switch (cpt) {
    case 1: return launch_quantize<T, 1, VEC>(x, q, scale, N, D, L, st);
    case 2: return launch_quantize<T, 2, VEC>(x, q, scale, N, D, L, st);
    case 3: return launch_quantize<T, 3, VEC>(x, q, scale, N, D, L, st);
    case 4: return launch_quantize<T, 4, VEC>(x, q, scale, N, D, L, st);
    case 8:  // bf16 only: eight f32 chunks and the next row's would spill
      if constexpr (sizeof(T) == 2) return launch_quantize<T, 8, VEC>(x, q, scale, N, D, L, st);
      return static_cast<int>(cudaErrorInvalidValue);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T>
int quantize_as(const void* x, void* q, void* scale, int64_t N, int D, int L, int cpt, int vec,
                cudaStream_t st) {
  if (L == 0) {  // rows past the widest plan
    if (N > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
    quantize_rows_kernel<<<static_cast<int>(N), kThreads, 0, st>>>(
        static_cast<const T*>(x), static_cast<int8_t*>(q), static_cast<float*>(scale), D);
    return static_cast<int>(cudaGetLastError());
  }
  return vec ? dispatch_quantize<T, true>(x, q, scale, N, D, L, cpt, st)
             : dispatch_quantize<T, false>(x, q, scale, N, D, L, cpt, st);
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

// lanes: threads a row (a power of two <= 32, or a multiple of 32 <= 512),
// or 0 for the two-pass kernel of rows past the widest plan; cpt: chunks a
// lane; vec: 16-byte loads and 8-byte stores (aligned bases, D a multiple
// of 8) or element-wise ones
extern "C" int bq_quantize(const void* x, void* q, void* scale, int64_t N, int D, int dtype,
                           int lanes, int cpt, int vec, void* stream) {
  const bool pow2 = lanes >= 1 && lanes <= 32 && (lanes & (lanes - 1)) == 0;
  const bool whole = lanes > 32 && lanes <= 512 && lanes % 32 == 0;
  if (N < 1 || D < 1 || !(pow2 || whole || lanes == 0))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kBF16) return quantize_as<__nv_bfloat16>(x, q, scale, N, D, lanes, cpt, vec, st);
  if (dtype == kF32) return quantize_as<float>(x, q, scale, N, D, lanes, cpt, vec, st);
  return static_cast<int>(cudaErrorInvalidValue);
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
