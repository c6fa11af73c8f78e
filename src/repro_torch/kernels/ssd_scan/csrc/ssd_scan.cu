// Chunked linear attention with decay (the Mamba2 SSD scan) for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel `ssd_scan` (`_ssd_kernel`) of
// src/repro/kernels/ssd_scan/kernel.py, whose oracle is the reference
// model's `ssm.chunked_linear_attention`.  Per chunk of Q steps, in f32:
//   cum_t  = cumsum(log_g) over the chunk, total = cum at its last step
//   y_t    = sum_{s<=t} (q_t.k_s) exp(clip(cum_t - cum_s + li_s)) v_s
//          + exp(clip(cum_t)) q_t . S
//   S'     = exp(clip(total)) S + sum_s exp(clip(total - cum_s + li_s)) k_s v_s^T
// with every clip at +-30 where the Pallas kernel puts it, li = log_i or 0,
// y cast to v's dtype and the final S written in f32.
//
// Bound on the card: operations.  At zamba2's shapes (DK = DV = 64, Q =
// 256) a chunk does ~21 MFLOP on ~100 KB of inputs, over 200 operations a
// byte.  The products are f32 and the tolerance is f32 (TF32 tensor cores
// keep 10 mantissa bits), so this first version runs them on the CUDA cores.
//
// Design.  On the TPU the state rides across a sequential grid axis in
// VMEM; here one block of 256 threads owns one (batch, head) and loops over
// the chunks in order, the 64 x 64 f32 state resident in shared memory.
// The (Q x Q) f32 score block of a 256-step chunk is 256 KB, more than a
// block's shared memory, so the intra-chunk products are tiled in 64 x 64
// sub-blocks: for each 64-row block of outputs, the inter-chunk term first,
// then one (scores, scores.V) pair per key block on or below the diagonal
// (blocks above it are skipped, not masked).  The chunk boundaries, where
// the clips apply and the state is carried, stay those of the `chunk`
// argument; a short last chunk takes any T, which equals the reference's
// zero padding.  Each thread computes a 4 x 4 register tile of every 64 x 64
// product out of shared memory (operands stored transposed and padded to a
// 65-float pitch so a warp's reads fall in distinct banks).  DK and DV up to
// 64 are zero-padded (exact).  The chunk's cumulative decay is a warp
// shuffle scan.  q, k, v and the gates are read through (batch, time,
// head) strides, so Mamba2's head broadcast of q and k (stride 0) and the
// model's (B, T, NH, D) layout need no copy.  Tensor cores (3xTF32 or a
// bf16 split), a cp.async ring, and splitting a head's chunks over blocks
// are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // 16 x 16 threads, a 4 x 4 tile each
constexpr int kTile = 64;      // rows of an output block and of a key block
constexpr int kDP = 64;        // DK and DV padded
constexpr int kPitch = kTile + 1;
constexpr float kClip = 30.0f;
enum { kF32 = 0, kBF16 = 1 };

// shared-memory layout, in floats
constexpr int kOffS = 0;                           // state S[d][v], pitch kDP
constexpr int kOffQT = kOffS + kDP * kDP;          // q^T[d][t], pitch kPitch
constexpr int kOffKT = kOffQT + kDP * kPitch;      // k^T[d][s] (x w_s in the update)
constexpr int kOffV = kOffKT + kDP * kPitch;       // v[s][v], pitch kDP
constexpr int kOffPT = kOffV + kTile * kDP;        // scores^T[s][t], pitch kPitch
constexpr int kOffCum = kOffPT + kTile * kPitch;   // cum[chunk], then li[chunk]
constexpr int kFixedFloats = kOffCum;

struct Strides {
  int64_t b, t, h;  // element strides; the feature dim is contiguous
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }
__device__ __forceinline__ float clip(float x) { return fminf(fmaxf(x, -kClip), kClip); }

// rows x kDP tile of a (time, feature) slice into dst[f * pitch + r]
// (transposed) or dst[r * kDP + f]; zero outside [0, rows) x [0, width).
template <typename T, bool kTransposed>
__device__ void load_tile(float* dst, const T* src, int64_t row_stride, int rows, int width,
                          const float* row_scale) {
  for (int idx = threadIdx.x; idx < kTile * kDP; idx += kThreads) {
    const int r = idx / kDP, f = idx % kDP;
    float x = 0.0f;
    if (r < rows && f < width) {
      x = to_f32(src[r * row_stride + f]);
      if (row_scale != nullptr) x *= row_scale[r];
    }
    if (kTransposed)
      dst[f * kPitch + r] = x;
    else
      dst[r * kDP + f] = x;
  }
}

// two blocks an SM: 2 x 83 KB of shared memory, at most 128 registers a thread
template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
ssd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
           const float* __restrict__ log_g, const float* __restrict__ log_i,
           T* __restrict__ y, float* __restrict__ state,
           Strides sq, Strides sk, Strides sv, Strides sg, Strides si, Strides sy, int T_len,
           int NH, int DK, int DV, int chunk) {
  extern __shared__ __align__(16) float smem[];
  float* Ss = smem + kOffS;
  float* qT = smem + kOffQT;
  float* kT = smem + kOffKT;
  float* vs = smem + kOffV;
  float* PT = smem + kOffPT;
  float* cum = smem + kOffCum;
  float* li = cum + chunk;

  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int warp = tid / 32, lane = tid % 32;
  const T* qb = q + b * sq.b + h * sq.h;
  const T* kb = k + b * sk.b + h * sk.h;
  const T* vb = v + b * sv.b + h * sv.h;
  const float* gb = log_g + b * sg.b + h * sg.h;
  const float* ib = log_i != nullptr ? log_i + b * si.b + h * si.h : nullptr;
  T* yb = y + b * sy.b + h * sy.h;
  const int64_t state_off = (static_cast<int64_t>(b) * NH + h) * DK * DV;

  for (int idx = tid; idx < kDP * kDP; idx += kThreads) Ss[idx] = 0.0f;

  for (int c0 = 0; c0 < T_len; c0 += chunk) {
    const int Lc = min(chunk, T_len - c0);
    __syncthreads();  // the previous chunk is done with cum, li and the tiles
    for (int t = tid; t < Lc; t += kThreads) {
      cum[t] = gb[(c0 + t) * sg.t];
      li[t] = ib != nullptr ? ib[(c0 + t) * si.t] : 0.0f;
    }
    __syncthreads();
    if (warp == 0) {  // inclusive scan of the chunk's log decays
      float carry = 0.0f;
      for (int base = 0; base < Lc; base += 32) {
        const int t = base + lane;
        float x = t < Lc ? cum[t] : 0.0f;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
          const float up = __shfl_up_sync(0xffffffffu, x, o);
          if (lane >= o) x += up;
        }
        x += carry;
        if (t < Lc) cum[t] = x;
        carry = __shfl_sync(0xffffffffu, x, 31);
      }
    }
    __syncthreads();
    const float total = cum[Lc - 1];

    // ---- outputs, one 64-row block at a time
    for (int tb = 0; tb < Lc; tb += kTile) {
      const int nt = min(kTile, Lc - tb);
      __syncthreads();
      load_tile<T, true>(qT, qb + static_cast<int64_t>(c0 + tb) * sq.t, sq.t, nt, DK, nullptr);
      __syncthreads();
      float acc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
      // inter-chunk term: exp(clip(cum_t)) q_t . S
      for (int d = 0; d < DK; ++d) {
        float a[4], w[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = qT[d * kPitch + ty + 16 * i];
#pragma unroll
        for (int j = 0; j < 4; ++j) w[j] = Ss[d * kDP + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] += a[i] * w[j];
      }
      float cum_t[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = ty + 16 * i;
        cum_t[i] = t < nt ? cum[tb + t] : 0.0f;
        const float e = expf(clip(cum_t[i]));
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] *= e;
      }
      // intra-chunk term over the key blocks on or below the diagonal
      for (int sb = 0; sb <= tb; sb += kTile) {
        const int ns = min(kTile, Lc - sb);
        __syncthreads();
        load_tile<T, true>(kT, kb + static_cast<int64_t>(c0 + sb) * sk.t, sk.t, ns, DK, nullptr);
        load_tile<T, false>(vs, vb + static_cast<int64_t>(c0 + sb) * sv.t, sv.t, ns, DV, nullptr);
        __syncthreads();
        float p[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) p[i][j] = 0.0f;
        for (int d = 0; d < DK; ++d) {
          float a[4], w[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) a[i] = qT[d * kPitch + ty + 16 * i];
#pragma unroll
          for (int j = 0; j < 4; ++j) w[j] = kT[d * kPitch + tx + 16 * j];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) p[i][j] += a[i] * w[j];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int t = ty + 16 * i;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int s = tx + 16 * j;
            const bool ok = t < nt && s < ns && sb + s <= tb + t;
            const float decay = ok ? expf(clip(cum_t[i] - cum[sb + s] + li[sb + s])) : 0.0f;
            PT[s * kPitch + t] = ok ? p[i][j] * decay : 0.0f;
          }
        }
        __syncthreads();
        for (int s = 0; s < ns; ++s) {
          float a[4], w[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) a[i] = PT[s * kPitch + ty + 16 * i];
#pragma unroll
          for (int j = 0; j < 4; ++j) w[j] = vs[s * kDP + tx + 16 * j];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[i][j] += a[i] * w[j];
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = ty + 16 * i;
        if (t >= nt) continue;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = tx + 16 * j;
          if (c < DV) store(yb + static_cast<int64_t>(c0 + tb + t) * sy.t + c, acc[i][j]);
        }
      }
    }

    // ---- state: S' = exp(clip(total)) S + sum_s (k_s w_s) v_s^T
    float upd[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) upd[i][j] = 0.0f;
    for (int sb = 0; sb < Lc; sb += kTile) {
      const int ns = min(kTile, Lc - sb);
      __syncthreads();
      // the weights w_s, staged in PT's first row
      for (int s = tid; s < ns; s += kThreads)
        PT[s] = expf(clip(total - cum[sb + s] + li[sb + s]));
      __syncthreads();
      load_tile<T, true>(kT, kb + static_cast<int64_t>(c0 + sb) * sk.t, sk.t, ns, DK, PT);
      load_tile<T, false>(vs, vb + static_cast<int64_t>(c0 + sb) * sv.t, sv.t, ns, DV, nullptr);
      __syncthreads();
      for (int s = 0; s < ns; ++s) {
        float a[4], w[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = kT[(ty + 16 * i) * kPitch + s];
#pragma unroll
        for (int j = 0; j < 4; ++j) w[j] = vs[s * kDP + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) upd[i][j] += a[i] * w[j];
      }
    }
    __syncthreads();  // every thread is done reading the old state
    const float keep = expf(clip(total));
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float* sp = Ss + (ty + 16 * i) * kDP + tx + 16 * j;
        *sp = keep * *sp + upd[i][j];
      }
  }
  __syncthreads();
  for (int idx = tid; idx < DK * DV; idx += kThreads)
    state[state_off + idx] = Ss[(idx / DV) * kDP + idx % DV];
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const float* log_g, const float* log_i,
           void* y, float* state, Strides sq, Strides sk, Strides sv, Strides sg, Strides si,
           Strides sy, int B, int T_len, int NH, int DK, int DV, int chunk, cudaStream_t st) {
  const size_t smem = sizeof(float) * (static_cast<size_t>(kFixedFloats) + 2 * chunk);
  cudaError_t err = cudaFuncSetAttribute(ssd_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(NH, B);
  ssd_kernel<T><<<grid, kThreads, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), log_g,
      log_i, static_cast<T*>(y), state, sq, sk, sv, sg, si, sy, T_len, NH, DK, DV, chunk);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int ssd_forward(const void* q, const void* k, const void* v, const void* log_g,
                           const void* log_i, void* y, void* state,
                           int64_t sqb, int64_t sqt, int64_t sqh,
                           int64_t skb, int64_t skt, int64_t skh,
                           int64_t svb, int64_t svt, int64_t svh,
                           int64_t sgb, int64_t sgt, int64_t sgh,
                           int64_t sib, int64_t sit, int64_t sih,
                           int64_t syb, int64_t syt, int64_t syh,
                           int B, int T_len, int NH, int DK, int DV, int chunk, int dtype,
                           void* stream) {
  if (DK < 1 || DK > kDP || DV < 1 || DV > kDP || chunk < 1 || T_len < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const Strides sq{sqb, sqt, sqh}, sk{skb, skt, skh}, sv{svb, svt, svh};
  const Strides sg{sgb, sgt, sgh}, si{sib, sit, sih}, sy{syb, syt, syh};
  const float* g = static_cast<const float*>(log_g);
  const float* i = static_cast<const float*>(log_i);
  float* s = static_cast<float*>(state);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kBF16)
    return launch<__nv_bfloat16>(q, k, v, g, i, y, s, sq, sk, sv, sg, si, sy, B, T_len, NH, DK,
                                 DV, chunk, st);
  if (dtype == kF32)
    return launch<float>(q, k, v, g, i, y, s, sq, sk, sv, sg, si, sy, B, T_len, NH, DK, DV, chunk,
                         st);
  return static_cast<int>(cudaErrorInvalidValue);
}
