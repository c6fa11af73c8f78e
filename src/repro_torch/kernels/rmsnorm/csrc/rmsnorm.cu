// Fused RMSNorm for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `rmsnorm` (`_rmsnorm_kernel`) of
// src/repro/kernels/rmsnorm/kernel.py, the same math as
// `models.common.rms_norm`:
//   out = cast(x * rsqrt(mean(x^2) + eps), dtype(x)) * w
// with the sum of squares and the normalisation in f32, a rounding to x's
// dtype before the weight multiply, and a second rounding after it.
//
// Bound on the card: bytes.  Per element it reads x and w and writes out,
// about four operations for four bytes in bf16.  At the serve shape (1024,
// 2560) bf16 that is 10.5 MB, 3.13 us at 3.35 TB/s.
//
// Design.  Every access is a 16-byte vector (8 bf16 or 4 f32 a thread),
// and a row is read once: each thread keeps its vectors of the row in
// registers from the sum of squares to the write.  The launch shape follows
// D (`ops.launch_plan`, from shapes only):
//  - narrow rows (at most 128 vectors: D <= 1024 in bf16, e.g. qwen3-14b's
//    qk_norm over 128-wide heads): a group of up to 32 lanes a row, several
//    rows a 256-thread block, the sum a shuffle within the group;
//  - wide rows (D = 2560 and 5120 in bf16): a block a row, two vectors a
//    thread (about D/16 threads: 160 and 320), the sum a shuffle then one
//    shared-memory pass; past 1024 vectors (D > 8192 in bf16), up to 512
//    threads of up to 8 vectors each.
// Blocks walk the rows with a stride of the grid, which is at most one
// resident wave, each thread loading its vectors of the next row before it
// reduces the current one; each thread loads its vectors of w once, before
// the first row.  The decode shapes (4-8 rows) get one block a row.  A D that
// is not a multiple of the vector, or a base address that is not 16-byte
// aligned (a view at an element offset), takes the same kernel with
// element-wise loads and stores in the same register layout; nothing falls
// back to the plain version.  Sums run in a fixed order: bit-identical run
// to run.
//
// Measured (chip_smoke.py --parent; NVIDIA H100 80GB HBM3, 700.00 W; hot
// L2): 4.988 us at the serve shape against F.rms_norm's 5.428 us and the
// 3.132 us bound (the one-block-a-row scalar kernel it replaces: 5.688
// us); 14.735 us at zamba2-2.7b's gated norm (2048, 5120), level with
// F.rms_norm's 15.124 us within the run-to-run spread (bound 12.523 us);
// 2.6-2.9 us at the 4-8 decode rows against 4.1-5.9 us; 6.741 us at
// qwen3-14b's qk_norm (40960, 128) against 27.432 us.  One vector a
// thread (D/8 threads) was slower at the prefill-sized rows.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRowBlock = 256;  // threads a block when a group of <= 32 lanes takes a row
enum { kF32 = 0, kBF16 = 1 };
using bf16 = __nv_bfloat16;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }
template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ bf16 from_f32<bf16>(float v) { return __float2bfloat16_rn(v); }

template <typename T>
__device__ __forceinline__ T& elem(uint4& r, int e) { return reinterpret_cast<T*>(&r)[e]; }

// this lane's VPT vectors of a row (element (j L + i) V + e of vector j);
// outside [0, D) reads as zero
template <typename T, int VPT, bool VEC>
__device__ __forceinline__ void load_row(uint4 (&r)[VPT], const T* p, int D, int i, int L,
                                         bool active) {
  constexpr int V = 16 / sizeof(T);
#pragma unroll
  for (int j = 0; j < VPT; ++j) {
    const int col = (j * L + i) * V;
    if (VEC) {
      r[j] = active && col < D ? *reinterpret_cast<const uint4*>(p + col) : make_uint4(0, 0, 0, 0);
    } else {
#pragma unroll
      for (int e = 0; e < V; ++e)
        elem<T>(r[j], e) = active && col + e < D ? p[col + e] : from_f32<T>(0.0f);
    }
  }
}

// L lanes a row: a power of two up to 32 (blockDim.x / L rows a block), or
// blockDim.x itself, a multiple of 32 (one row a block).  Past one vector a
// thread, a block has at most 512 threads: up to 128 registers each hold
// the row and w without spilling
template <typename T, int VPT, bool VEC>
__global__ void __launch_bounds__(VPT == 1 ? 1024 : 512)
rmsnorm_kernel(const T* __restrict__ x, const T* __restrict__ w, T* __restrict__ out, int64_t N,
               int D, float eps, int L) {
  constexpr int V = 16 / sizeof(T);
  __shared__ float partial[32];
  const int R = blockDim.x / L;
  const int i = threadIdx.x % L, grp = threadIdx.x / L;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  uint4 wr[VPT], xr[VPT], xn[VPT];
  load_row<T, VPT, VEC>(wr, w, D, i, L, true);
  const int64_t stride = static_cast<int64_t>(gridDim.x) * R;
  int64_t row = static_cast<int64_t>(blockIdx.x) * R + grp;
  load_row<T, VPT, VEC>(xn, x + row * D, D, i, L, row < N);
  // `base` is the same for every thread of the block: the reductions below
  // see every lane, active or not.  The next row's loads are issued before
  // this row's sum, so one row's latency hides behind the other's work
  for (int64_t base = static_cast<int64_t>(blockIdx.x) * R; base < N; base += stride) {
    row = base + grp;
    const bool active = row < N;
#pragma unroll
    for (int j = 0; j < VPT; ++j) xr[j] = xn[j];
    if (base + stride < N) load_row<T, VPT, VEC>(xn, x + (row + stride) * D, D, i, L, row + stride < N);
    float ss = 0.0f;
#pragma unroll
    for (int j = 0; j < VPT; ++j)
#pragma unroll
      for (int e = 0; e < V; ++e) {
        const float f = to_f32(elem<T>(xr[j], e));
        ss += f * f;
      }
    if (L <= 32) {
      for (int o = L / 2; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
    } else {
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
      if (lane == 0) partial[warp] = ss;
      __syncthreads();
      ss = lane < static_cast<int>(blockDim.x / 32) ? partial[lane] : 0.0f;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
      __syncthreads();  // partial is free for the next row
    }
    const float inv = rsqrtf(ss / static_cast<float>(D) + eps);
    if (!active) continue;
    T* orow = out + row * D;
#pragma unroll
    for (int j = 0; j < VPT; ++j) {
      const int col = (j * L + i) * V;
      if (col >= D) continue;
      uint4 o;
#pragma unroll
      for (int e = 0; e < V; ++e) {
        // round to x's dtype, then multiply by w and round again
        const float n = to_f32(from_f32<T>(to_f32(elem<T>(xr[j], e)) * inv));
        elem<T>(o, e) = from_f32<T>(n * to_f32(elem<T>(wr[j], e)));
      }
      if (VEC) {
        *reinterpret_cast<uint4*>(orow + col) = o;
      } else {
#pragma unroll
        for (int e = 0; e < V; ++e)
          if (col + e < D) orow[col + e] = elem<T>(o, e);
      }
    }
  }
}

template <typename T, int VPT, bool VEC>
int launch(const void* x, const void* w, void* out, int64_t N, int D, float eps, int L,
           cudaStream_t st) {
  int dev = 0, n_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int threads = L <= 32 ? kRowBlock : L;
  const int64_t rows_per_block = threads / L;
  const int64_t blocks = (N + rows_per_block - 1) / rows_per_block;
  const int64_t wave = static_cast<int64_t>(n_sm) * (2048 / threads);
  const int grid = static_cast<int>(blocks < wave ? blocks : wave);
  rmsnorm_kernel<T, VPT, VEC><<<grid, threads, 0, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<T*>(out), N, D, eps, L);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool VEC>
int dispatch(const void* x, const void* w, void* out, int64_t N, int D, float eps, int L, int vpt,
             cudaStream_t st) {
  switch (vpt) {
    case 1: return launch<T, 1, VEC>(x, w, out, N, D, eps, L, st);
    case 2: return launch<T, 2, VEC>(x, w, out, N, D, eps, L, st);
    case 3: return launch<T, 3, VEC>(x, w, out, N, D, eps, L, st);
    case 4: return launch<T, 4, VEC>(x, w, out, N, D, eps, L, st);
    case 8: return launch<T, 8, VEC>(x, w, out, N, D, eps, L, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T>
int dispatch(const void* x, const void* w, void* out, int64_t N, int D, float eps, int L, int vpt,
             int vec, cudaStream_t st) {
  return vec ? dispatch<T, true>(x, w, out, N, D, eps, L, vpt, st)
             : dispatch<T, false>(x, w, out, N, D, eps, L, vpt, st);
}


// ------------------------------------------------------------- backward
//
// The gradient of the forward above, as `jax.grad` takes it through the
// reference's `rms_norm`: with r = rsqrt(mean(x^2) + eps), n = x r and
// dn = dy w (f32),
//   dx = r dn - x r^3 mean(dn x)      (cast to x's dtype)
//   dw = sum over rows of cast(n) dy  (f32 sums, cast to w's dtype).
// No Pallas kernel has a backward: the reference differentiates its plain
// XLA math; this is the port's, so that a norm on the card keeps its
// gradient.  Bound: bytes (x and dy read, dx written, per element).
//
// Pass 1 (`rmsnorm_bwd_kernel`) takes the forward's launch plan (lanes a
// row, vectors a lane) and recomputes r from the row, so the forward keeps
// nothing for it; each thread keeps its columns' share of dw in f32
// registers over the rows it walks and writes it, once, as a row of a
// per-(block, row group) f32 partial.  Pass 2 (`rmsnorm_dw_kernel`) sums
// the partials' rows in a fixed order: dw is deterministic, with no atomics.

template <typename T, int VPT, bool VEC>
__global__ void __launch_bounds__(VPT == 1 ? 1024 : 512)
rmsnorm_bwd_kernel(const T* __restrict__ x, const T* __restrict__ w, const T* __restrict__ dy,
                   T* __restrict__ dx, float* __restrict__ partial, int64_t N, int D, float eps,
                   int L) {
  constexpr int V = 16 / sizeof(T);
  __shared__ float red[2][32];
  const int R = blockDim.x / L;
  const int i = threadIdx.x % L, grp = threadIdx.x / L;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  uint4 wr[VPT], xr[VPT], gr[VPT];
  float dw[VPT][V];
#pragma unroll
  for (int j = 0; j < VPT; ++j)
#pragma unroll
    for (int e = 0; e < V; ++e) dw[j][e] = 0.0f;
  load_row<T, VPT, VEC>(wr, w, D, i, L, true);
  const int64_t stride = static_cast<int64_t>(gridDim.x) * R;
  for (int64_t base = static_cast<int64_t>(blockIdx.x) * R; base < N; base += stride) {
    const int64_t row = base + grp;
    const bool active = row < N;
    const int64_t off = active ? row * D : 0;
    load_row<T, VPT, VEC>(xr, x + off, D, i, L, active);
    load_row<T, VPT, VEC>(gr, dy + off, D, i, L, active);
    float ss = 0.0f, sd = 0.0f;
#pragma unroll
    for (int j = 0; j < VPT; ++j)
#pragma unroll
      for (int e = 0; e < V; ++e) {
        const float f = to_f32(elem<T>(xr[j], e));
        ss += f * f;
        sd += to_f32(elem<T>(gr[j], e)) * to_f32(elem<T>(wr[j], e)) * f;
      }
    if (L <= 32) {
      for (int o = L / 2; o > 0; o >>= 1) {
        ss += __shfl_xor_sync(0xffffffffu, ss, o);
        sd += __shfl_xor_sync(0xffffffffu, sd, o);
      }
    } else {
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        ss += __shfl_xor_sync(0xffffffffu, ss, o);
        sd += __shfl_xor_sync(0xffffffffu, sd, o);
      }
      if (lane == 0) {
        red[0][warp] = ss;
        red[1][warp] = sd;
      }
      __syncthreads();
      const bool in = lane < static_cast<int>(blockDim.x / 32);
      ss = in ? red[0][lane] : 0.0f;
      sd = in ? red[1][lane] : 0.0f;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        ss += __shfl_xor_sync(0xffffffffu, ss, o);
        sd += __shfl_xor_sync(0xffffffffu, sd, o);
      }
      __syncthreads();  // red is free for the next row
    }
    const float r = rsqrtf(ss / static_cast<float>(D) + eps);
    const float c = r * r * r * (sd / static_cast<float>(D));
    if (!active) continue;
    T* drow = dx + row * D;
#pragma unroll
    for (int j = 0; j < VPT; ++j) {
      const int col = (j * L + i) * V;
      if (col >= D) continue;
      uint4 o;
#pragma unroll
      for (int e = 0; e < V; ++e) {
        const float f = to_f32(elem<T>(xr[j], e));
        const float g = to_f32(elem<T>(gr[j], e));
        elem<T>(o, e) = from_f32<T>(r * (g * to_f32(elem<T>(wr[j], e))) - f * c);
        dw[j][e] += to_f32(from_f32<T>(f * r)) * g;  // the forward's rounding of n
      }
      if (VEC) {
        *reinterpret_cast<uint4*>(drow + col) = o;
      } else {
#pragma unroll
        for (int e = 0; e < V; ++e)
          if (col + e < D) drow[col + e] = elem<T>(o, e);
      }
    }
  }
  float* prow = partial + (static_cast<int64_t>(blockIdx.x) * R + grp) * D;
#pragma unroll
  for (int j = 0; j < VPT; ++j)
#pragma unroll
    for (int e = 0; e < V; ++e) {
      const int col = (j * L + i) * V + e;
      if (col < D) prow[col] = dw[j][e];
    }
}

// dw[c] = sum of the `rows` partial rows at column c: 32 columns a block,
// eight row slices summed in turn, then the slices in order
template <typename T>
__global__ void __launch_bounds__(256)
rmsnorm_dw_kernel(const float* __restrict__ partial, T* __restrict__ dw, int rows, int D) {
  __shared__ float s[8][33];
  const int lane = threadIdx.x % 32, sl = threadIdx.x / 32;
  const int c = blockIdx.x * 32 + lane;
  float acc = 0.0f;
  if (c < D)
    for (int r = sl; r < rows; r += 8) acc += partial[static_cast<int64_t>(r) * D + c];
  s[sl][lane] = acc;
  __syncthreads();
  if (sl == 0 && c < D) {
    float t = 0.0f;
#pragma unroll
    for (int k = 0; k < 8; ++k) t += s[k][lane];
    dw[c] = from_f32<T>(t);
  }
}

template <typename T, int VPT, bool VEC>
int launch_bwd(const void* x, const void* w, const void* dy, void* dx, void* dw, float* partial,
               int64_t N, int D, float eps, int L, int grid, cudaStream_t st) {
  const int threads = L <= 32 ? kRowBlock : L;
  rmsnorm_bwd_kernel<T, VPT, VEC><<<grid, threads, 0, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<const T*>(dy),
      static_cast<T*>(dx), partial, N, D, eps, L);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int rows = grid * (threads / L);
  rmsnorm_dw_kernel<T><<<(D + 31) / 32, 256, 0, st>>>(partial, static_cast<T*>(dw), rows, D);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool VEC>
int dispatch_bwd(const void* x, const void* w, const void* dy, void* dx, void* dw,
                 float* partial, int64_t N, int D, float eps, int L, int vpt, int grid,
                 cudaStream_t st) {
  switch (vpt) {
    case 1: return launch_bwd<T, 1, VEC>(x, w, dy, dx, dw, partial, N, D, eps, L, grid, st);
    case 2: return launch_bwd<T, 2, VEC>(x, w, dy, dx, dw, partial, N, D, eps, L, grid, st);
    case 3: return launch_bwd<T, 3, VEC>(x, w, dy, dx, dw, partial, N, D, eps, L, grid, st);
    case 4: return launch_bwd<T, 4, VEC>(x, w, dy, dx, dw, partial, N, D, eps, L, grid, st);
    case 8: return launch_bwd<T, 8, VEC>(x, w, dy, dx, dw, partial, N, D, eps, L, grid, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// lanes: threads a row (a power of two <= 32, or a multiple of 32 <= 1024);
// vpt: vectors a lane; vec: 16-byte accesses (aligned bases, D a multiple
// of the vector) or element-wise ones
extern "C" int rmsnorm_forward(const void* x, const void* w, void* out, int64_t N, int D,
                               float eps, int dtype, int lanes, int vpt, int vec, void* stream) {
  const bool pow2 = lanes >= 1 && lanes <= 32 && (lanes & (lanes - 1)) == 0;
  const bool whole = lanes > 32 && lanes <= (vpt == 1 ? 1024 : 512) && lanes % 32 == 0;
  if (N < 1 || D < 1 || !(pow2 || whole)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kBF16) return dispatch<bf16>(x, w, out, N, D, eps, lanes, vpt, vec, st);
  if (dtype == kF32) return dispatch<float>(x, w, out, N, D, eps, lanes, vpt, vec, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The backward: dx (N, D) and dw (D,) from x, w and dy, through `partial`,
// an f32 scratch of grid * (rows a block) rows of D (`ops.backward_plan`).
// lanes, vpt and vec as for the forward; grid: the blocks of pass 1.
extern "C" int rmsnorm_backward(const void* x, const void* w, const void* dy, void* dx,
                                void* dw, void* partial, int64_t N, int D, float eps, int dtype,
                                int lanes, int vpt, int vec, int grid, void* stream) {
  const bool pow2 = lanes >= 1 && lanes <= 32 && (lanes & (lanes - 1)) == 0;
  const bool whole = lanes > 32 && lanes <= (vpt == 1 ? 1024 : 512) && lanes % 32 == 0;
  if (N < 1 || D < 1 || grid < 1 || !(pow2 || whole))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* p = static_cast<float*>(partial);
  if (dtype == kBF16)
    return vec ? dispatch_bwd<bf16, true>(x, w, dy, dx, dw, p, N, D, eps, lanes, vpt, grid, st)
               : dispatch_bwd<bf16, false>(x, w, dy, dx, dw, p, N, D, eps, lanes, vpt, grid, st);
  if (dtype == kF32)
    return vec ? dispatch_bwd<float, true>(x, w, dy, dx, dw, p, N, D, eps, lanes, vpt, grid, st)
               : dispatch_bwd<float, false>(x, w, dy, dx, dw, p, N, D, eps, lanes, vpt, grid, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
