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
// One cooperative launch (`rmsnorm_bwd_kernel`), in two phases:
//  1. A row group of L lanes takes a row, each lane VPT 16-byte vectors of
//     it (`ops.backward_plan`): a warp a row up to 256 vectors (D = 2048 in
//     bf16: qwen2-1.5b's 1536 is 6 vectors a lane), fewer lanes for narrow
//     rows, W warps past it (a named barrier a row, its warps' sums read in
//     warp order).  The sums of a row are shuffles within its warp: no
//     __syncthreads in the row loop.  The grid is persistent, at most the
//     blocks the card holds at once; a block walks a contiguous band of
//     rows, its row groups in turn, recomputing each row's r (the forward
//     keeps nothing).  Each lane keeps its columns' share of dw in f32
//     registers; at the end each row group stores its share in a slot of
//     shared memory of its own, and each column is summed over the slots in
//     group order into the block's row of the f32 `partial` (grid rows: 0.8
//     MB at qwen2-1.5b's rows).  A slot a group, not one row the groups
//     add into in turn: that is a chain of dependent shared-memory updates
//     a group, slower than the row loop itself.
//  2. After a grid-wide barrier, block b sums 32-column chunks b, b + grid,
//     ... of the partial rows: warp k the rows k, k + 8, ... in order (eight
//     loads in flight), then the warps' sums in warp order.  dw is
//     deterministic: no atomics take part in any sum (the barrier counts
//     arrivals with one atomic add a block on a counter whose low 31 bits
//     are zero between launches).
// The cooperative launch guarantees the blocks are resident together; it is
// captured into a CUDA graph like any launch.

constexpr int kBwdThreads = 256;  // threads a block, at most

__device__ __forceinline__ unsigned int load_acquire(const unsigned int* p) {
  unsigned int v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}

// a block-wide barrier that counts threads, not warps (`barrier.sync`, not
// the aligned `bar.sync`): thread 0 reaches it after spinning alone
__device__ __forceinline__ void block_barrier() { asm volatile("barrier.sync 0;\n" ::: "memory"); }

// every block of the (cooperative) grid waits here for all the others: the
// blocks add 2^31 to *ctr together (block 0 the rest of it), so its top bit
// flips once all have arrived
__device__ __forceinline__ void grid_barrier(unsigned int* ctr) {
  block_barrier();
  if (threadIdx.x == 0) {
    const unsigned int add = blockIdx.x == 0 ? 0x80000000u - (gridDim.x - 1) : 1u;
    __threadfence();
    const unsigned int old = atomicAdd(ctr, add);
    while (((old ^ load_acquire(ctr)) & 0x80000000u) == 0) {
    }
    __threadfence();
  }
  block_barrier();
}

// dynamic shared memory of the backward's fold: a slot of D floats (rounded
// up to 4) for each of the block's row groups, none with one group
__host__ __device__ inline int bwd_fold_floats(int D, int groups) {
  return groups > 1 ? groups * ((D + 3) / 4 * 4) : 0;
}
constexpr int kBwdMaxFold = 64 * 1024;  // bytes: G D <= 256 x 8 vectors of 16 bytes

// L lanes a row: a power of two up to 32, or a multiple of 32 up to 256;
// blockDim.x a multiple of L (blockDim.x / L row groups a block)
template <typename T, int VPT, bool VEC>
__global__ void __launch_bounds__(kBwdThreads)
rmsnorm_bwd_kernel(const T* __restrict__ x, const T* __restrict__ w, const T* __restrict__ dy,
                   T* __restrict__ dx, T* __restrict__ dwo, float* __restrict__ partial,
                   unsigned int* ctr, int64_t N, int D, float eps, int L) {
  constexpr int V = 16 / sizeof(T);
  extern __shared__ __align__(16) float fold[];    // a slot a row group (`bwd_fold_floats`)
  __shared__ float red[2][kBwdThreads / 32][2];     // a row's warp sums past 32 lanes, by parity
  __shared__ float colsum[kBwdThreads / 32][32];    // phase 2: each warp's sum of a chunk
  const int G = blockDim.x / L;
  const int i = threadIdx.x % L, grp = threadIdx.x / L;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int nw = blockDim.x / 32;
  uint4 wr[VPT], xr[VPT], gr[VPT];
  float dw[VPT][V];
#pragma unroll
  for (int j = 0; j < VPT; ++j)
#pragma unroll
    for (int e = 0; e < V; ++e) dw[j][e] = 0.0f;
  load_row<T, VPT, VEC>(wr, w, D, i, L, true);
  const int64_t per = (N + gridDim.x - 1) / gridDim.x;
  const int64_t lo = blockIdx.x * per, hi = min(N, lo + per);
  int parity = 0;
  // `base` is the same for every thread of the block, so every lane of a
  // warp takes part in each shuffle, active or not
  for (int64_t base = lo; base < hi; base += G, parity ^= 1) {
    const int64_t row = base + grp;
    const bool active = row < hi;
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
    const int span = L < 32 ? L : 32;
    for (int o = span / 2; o > 0; o >>= 1) {
      ss += __shfl_xor_sync(0xffffffffu, ss, o);
      sd += __shfl_xor_sync(0xffffffffu, sd, o);
    }
    if (L > 32) {
      const int W = L / 32, w0 = grp * W;
      if (lane == 0) {
        red[parity][warp][0] = ss;
        red[parity][warp][1] = sd;
      }
      asm volatile("barrier.sync %0, %1;\n" ::"r"(1 + grp), "r"(L) : "memory");
      ss = sd = 0.0f;
      for (int k = 0; k < W; ++k) {
        ss += red[parity][w0 + k][0];
        sd += red[parity][w0 + k][1];
      }
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
  // the block's row of the partial: each row group stores its share in its
  // own slot, then each column is summed over the slots in group order
  float* prow = partial + static_cast<int64_t>(blockIdx.x) * D;
  const int ds = (D + 3) / 4 * 4;
  float* slot = G == 1 ? prow : fold + grp * ds;
#pragma unroll
  for (int j = 0; j < VPT; ++j) {
    const int col = (j * L + i) * V;
#pragma unroll
    for (int e = 0; e < V; e += 4) {
      if (G > 1 && col + e + 4 <= D) {
        *reinterpret_cast<float4*>(slot + col + e) =
            make_float4(dw[j][e], dw[j][e + 1], dw[j][e + 2], dw[j][e + 3]);
      } else {
#pragma unroll
        for (int k = 0; k < 4; ++k)
          if (col + e + k < D) slot[col + e + k] = dw[j][e + k];
      }
    }
  }
  if (G > 1) {
    __syncthreads();
    for (int col = threadIdx.x; col < D; col += blockDim.x) {
      float t = 0.0f;
      for (int g = 0; g < G; ++g) t += fold[g * ds + col];
      prow[col] = t;
    }
  }
  grid_barrier(ctr);
  // phase 2: dw[c] = the partial rows' sum at column c, warp k summing rows
  // k, k + nw, ... (eight loads in flight, added in row order)
  const int rows = gridDim.x;
  for (int ch = blockIdx.x; ch < (D + 31) / 32; ch += gridDim.x) {
    const int col = ch * 32 + lane;
    float acc = 0.0f;
    if (col < D) {
      int rr = warp;
      for (; rr + 7 * nw < rows; rr += 8 * nw) {
        float v[8];
#pragma unroll
        for (int k = 0; k < 8; ++k)
          v[k] = __ldcg(partial + static_cast<int64_t>(rr + k * nw) * D + col);
#pragma unroll
        for (int k = 0; k < 8; ++k) acc += v[k];
      }
      for (; rr < rows; rr += nw) acc += __ldcg(partial + static_cast<int64_t>(rr) * D + col);
    }
    colsum[warp][lane] = acc;
    __syncthreads();
    if (warp == 0 && col < D) {
      float t = 0.0f;
      for (int k = 0; k < nw; ++k) t += colsum[k][lane];
      dwo[col] = from_f32<T>(t);
    }
    __syncthreads();
  }
}

// the fold's shared memory past the 48 KB a launch has by default (with
// the static arrays, D = 1536 in bf16 already needs it): opted in once per
// instance and device
template <typename T, int VPT, bool VEC>
cudaError_t bwd_opt_in() {
  static bool attr_set[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || (dev < 64 && attr_set[dev])) return err;
  err = cudaFuncSetAttribute(rmsnorm_bwd_kernel<T, VPT, VEC>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, kBwdMaxFold);
  if (err == cudaSuccess && dev < 64) attr_set[dev] = true;
  return err;
}

template <typename T, int VPT, bool VEC>
cudaError_t launch_bwd(const void* x, const void* w, const void* dy, void* dx, void* dw,
                       float* partial, unsigned int* ctr, int64_t N, int D, float eps, int L,
                       int threads, int grid, cudaStream_t st) {
  cudaError_t err = bwd_opt_in<T, VPT, VEC>();
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = bwd_fold_floats(D, threads / L) * sizeof(float);
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, rmsnorm_bwd_kernel<T, VPT, VEC>, static_cast<const T*>(x),
                           static_cast<const T*>(w), static_cast<const T*>(dy), static_cast<T*>(dx),
                           static_cast<T*>(dw), partial, ctr, N, D, eps, L);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// blocks of the instance an SM holds at once
template <typename T, int VPT, bool VEC>
cudaError_t occupancy_bwd(int D, int L, int threads, int* out) {
  cudaError_t err = bwd_opt_in<T, VPT, VEC>();
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      out, rmsnorm_bwd_kernel<T, VPT, VEC>, threads,
      bwd_fold_floats(D, threads / L) * sizeof(float));
}

// calls F<T, VPT, VEC>::run(args...) for the instance of (dtype, vpt, vec):
// up to 8 vectors a lane with 16-byte loads, up to 4 element-wise (more
// spill: every element is its own load)
template <template <typename, int, bool> class F, typename... A>
int with_bwd(int dtype, int vpt, int vec, A... args) {
#define RMS_BWD_CASE(T, N, VEC) \
  case N: return static_cast<int>(F<T, N, VEC>::run(args...));
#define RMS_BWD_VPT(T)                                                                 \
  if (vec) {                                                                           \
    switch (vpt) {                                                                     \
      RMS_BWD_CASE(T, 1, true) RMS_BWD_CASE(T, 2, true) RMS_BWD_CASE(T, 3, true)       \
      RMS_BWD_CASE(T, 4, true) RMS_BWD_CASE(T, 5, true) RMS_BWD_CASE(T, 6, true)       \
      RMS_BWD_CASE(T, 7, true) RMS_BWD_CASE(T, 8, true)                                \
      default: return static_cast<int>(cudaErrorInvalidValue);                         \
    }                                                                                  \
  }                                                                                    \
  switch (vpt) {                                                                       \
    RMS_BWD_CASE(T, 1, false) RMS_BWD_CASE(T, 2, false) RMS_BWD_CASE(T, 3, false)      \
    RMS_BWD_CASE(T, 4, false)                                                          \
    default: return static_cast<int>(cudaErrorInvalidValue);                           \
  }
  if (dtype == kBF16) {
    RMS_BWD_VPT(bf16)
  }
  if (dtype == kF32) {
    RMS_BWD_VPT(float)
  }
#undef RMS_BWD_VPT
#undef RMS_BWD_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T, int VPT, bool VEC>
struct LaunchBwd {
  template <typename... A>
  static cudaError_t run(A... args) { return launch_bwd<T, VPT, VEC>(args...); }
};
template <typename T, int VPT, bool VEC>
struct OccupancyBwd {
  template <typename... A>
  static cudaError_t run(A... args) { return occupancy_bwd<T, VPT, VEC>(args...); }
};

// lanes a row and threads a block the backward takes: L a power of two up
// to 32, or a multiple of 32 up to kBwdThreads, dividing `threads`; its
// fold within kBwdMaxFold
bool bwd_shape_ok(int D, int lanes, int vpt, int threads) {
  const bool pow2 = lanes >= 1 && lanes <= 32 && (lanes & (lanes - 1)) == 0;
  const bool warps = lanes > 32 && lanes <= kBwdThreads && lanes % 32 == 0;
  return (pow2 || warps) && vpt >= 1 && vpt <= 8 && threads >= lanes &&
         threads <= kBwdThreads && threads % lanes == 0 && threads % 32 == 0 &&
         bwd_fold_floats(D, threads / lanes) * static_cast<int>(sizeof(float)) <= kBwdMaxFold;
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

// The backward: dx (N, D) and dw (D,) from x, w and dy, in one cooperative
// launch of `grid` blocks of `threads` threads (`ops.backward_plan`; at
// most the blocks the card holds at once), through `partial`, an f32
// scratch of grid rows of D, and `counter`, a 32-bit word whose low 31
// bits are zero (they are again when the launch ends; a caller keeps one
// for each stream).  lanes: threads a row; vpt: vectors a lane; vec as for
// the forward.
extern "C" int rmsnorm_backward(const void* x, const void* w, const void* dy, void* dx,
                                void* dw, void* partial, void* counter, int64_t N, int D,
                                float eps, int dtype, int lanes, int vpt, int vec, int threads,
                                int grid, void* stream) {
  if (N < 1 || D < 1 || grid < 1 || !bwd_shape_ok(D, lanes, vpt, threads) ||
      static_cast<int64_t>(lanes) * vpt * (16 / (dtype == kBF16 ? 2 : 4)) < D)
    return static_cast<int>(cudaErrorInvalidValue);
  return with_bwd<LaunchBwd>(dtype, vpt, vec, x, w, dy, dx, dw, static_cast<float*>(partial),
                             static_cast<unsigned int*>(counter), N, D, eps, lanes, threads,
                             grid, static_cast<cudaStream_t>(stream));
}

// *out: blocks of the backward's instance for (D, dtype, lanes, vpt, vec) of
// `threads` threads that one SM of the current device holds at once.
extern "C" int rmsnorm_backward_blocks_per_sm(int D, int dtype, int lanes, int vpt, int vec,
                                              int threads, int* out) {
  if (D < 1 || !bwd_shape_ok(D, lanes, vpt, threads))
    return static_cast<int>(cudaErrorInvalidValue);
  return with_bwd<OccupancyBwd>(dtype, vpt, vec, D, lanes, threads, out);
}
