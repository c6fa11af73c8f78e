// Decode attention (one query token against a KV cache) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `decode_attention` (`_decode_kernel`) of
// src/repro/kernels/decode_attention/kernel.py: for each (batch, KV head)
// the G grouped query heads attend over the cache with an online softmax,
// f32 scores, f32 running max m, running sum l and accumulator, scale
// D^-0.5, positions >= kv_len masked, output in q's dtype.  As in the Pallas
// kernel, the probabilities stay f32 in the PV product.
//
// Bound on the card: bytes.  Every cached K and V element below kv_len is
// read once and used for two multiply-adds per query head, so at G <= 8 the
// card's memory rate bounds it by two orders of magnitude.  The design aims
// at keeping enough loads in flight: one block per (KV head, batch) of eight
// warps; the warps split the keys, each warp takes eight keys at a time and
// issues all their K and V loads before it uses any.  Within a warp the
// lanes split head_dim in element pairs (4-byte bf16x2 or 8-byte float2
// loads, a row read by consecutive lanes), so head_dim 80 runs as 40 pairs
// with no padding; a dot product is a warp shuffle reduction.  Each warp
// keeps its own (m, l, acc) and the eight are merged through shared memory
// at the end, as split-K flash decoding merges its splits.  kv_len is read
// from device memory (a scalar, or one per batch row), so the caller never
// synchronises with the host; keys at or past it are skipped, not loaded.
// A split over more blocks, TMA and a cp.async ring are later work.
//
// Layout: q and o are addressed through (batch, kv head, group) element
// strides, k and v through (batch, kv head, position) strides, all with a
// unit head_dim stride, so the model's (B, S, KH, D) cache is read in place.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kUnroll = 8;    // keys a warp loads before it computes
constexpr int kMaxD = 128;
constexpr int kMaxPairs = kMaxD / 64;  // element pairs a lane owns
constexpr float kNegInf = -1e30f;
enum { kF32 = 0, kBF16 = 1 };

struct Strides {
  int64_t b, h, s;  // element strides; head_dim is contiguous
};

__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// MAXG: the largest group size this instance takes (G <= MAXG at run time).
template <typename T, int MAXG>
__global__ void __launch_bounds__(kThreads)
decode_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
              T* __restrict__ o, const int* __restrict__ kv_len, int64_t kv_len_stride,
              int kv_len_scalar, Strides sq, Strides sk, Strides sv, Strides so, int G,
              int S, int D, float scale) {
  __shared__ float sm_m[kWarps][MAXG];
  __shared__ float sm_l[kWarps][MAXG];
  __shared__ float sm_acc[kWarps][MAXG][kMaxD];

  const int kh = blockIdx.x, b = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int npairs = D / 2;
  int L = kv_len != nullptr ? kv_len[b * kv_len_stride] : kv_len_scalar;
  L = min(L, S);

  const T* qb = q + b * sq.b + kh * sq.h;
  const T* kb = k + b * sk.b + kh * sk.h;
  const T* vb = v + b * sv.b + kh * sv.h;

  float qr[MAXG][kMaxPairs][2];
#pragma unroll
  for (int g = 0; g < MAXG; ++g) {
#pragma unroll
    for (int i = 0; i < kMaxPairs; ++i) {
      const int p = lane + 32 * i;
      float2 t = make_float2(0.0f, 0.0f);
      if (g < G && p < npairs) t = load2(qb + g * sq.s + 2 * p);
      qr[g][i][0] = t.x;
      qr[g][i][1] = t.y;
    }
  }

  float m[MAXG], l[MAXG], acc[MAXG][kMaxPairs][2];
#pragma unroll
  for (int g = 0; g < MAXG; ++g) {
    m[g] = kNegInf;
    l[g] = 0.0f;
#pragma unroll
    for (int i = 0; i < kMaxPairs; ++i) acc[g][i][0] = acc[g][i][1] = 0.0f;
  }

  for (int j0 = warp * kUnroll; j0 < L; j0 += kWarps * kUnroll) {
    float2 kr[kUnroll][kMaxPairs], vr[kUnroll][kMaxPairs];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int j = j0 + u;
#pragma unroll
      for (int i = 0; i < kMaxPairs; ++i) {
        const int p = lane + 32 * i;
        const bool ok = j < L && p < npairs;
        kr[u][i] = ok ? load2(kb + j * sk.s + 2 * p) : make_float2(0.0f, 0.0f);
        vr[u][i] = ok ? load2(vb + j * sv.s + 2 * p) : make_float2(0.0f, 0.0f);
      }
    }
#pragma unroll
    for (int g = 0; g < MAXG; ++g) {
      if (g >= G) break;
      float s[kUnroll];
      float mx = kNegInf;
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        float part = 0.0f;
#pragma unroll
        for (int i = 0; i < kMaxPairs; ++i)
          part += qr[g][i][0] * kr[u][i].x + qr[g][i][1] * kr[u][i].y;
        s[u] = warp_sum(part) * scale;
        if (j0 + u < L) mx = fmaxf(mx, s[u]);
      }
      const float m_new = fmaxf(m[g], mx);
      const float corr = expf(m[g] - m_new);
      float psum = 0.0f;
      float pv[kMaxPairs][2];
#pragma unroll
      for (int i = 0; i < kMaxPairs; ++i) pv[i][0] = pv[i][1] = 0.0f;
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const float p = j0 + u < L ? expf(s[u] - m_new) : 0.0f;
        psum += p;
#pragma unroll
        for (int i = 0; i < kMaxPairs; ++i) {
          pv[i][0] += p * vr[u][i].x;
          pv[i][1] += p * vr[u][i].y;
        }
      }
      l[g] = l[g] * corr + psum;
#pragma unroll
      for (int i = 0; i < kMaxPairs; ++i) {
        acc[g][i][0] = acc[g][i][0] * corr + pv[i][0];
        acc[g][i][1] = acc[g][i][1] * corr + pv[i][1];
      }
      m[g] = m_new;
    }
  }

  // merge the warps' partial softmaxes
#pragma unroll
  for (int g = 0; g < MAXG; ++g) {
    if (g >= G) break;
    if (lane == 0) {
      sm_m[warp][g] = m[g];
      sm_l[warp][g] = l[g];
    }
#pragma unroll
    for (int i = 0; i < kMaxPairs; ++i) {
      const int p = lane + 32 * i;
      if (p < npairs) {
        sm_acc[warp][g][2 * p] = acc[g][i][0];
        sm_acc[warp][g][2 * p + 1] = acc[g][i][1];
      }
    }
  }
  __syncthreads();
  T* ob = o + b * so.b + kh * so.h;
  for (int idx = threadIdx.x; idx < G * D; idx += kThreads) {
    const int g = idx / D, d = idx % D;
    float mx = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, sm_m[w][g]);
    float den = 0.0f, num = 0.0f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float c = expf(sm_m[w][g] - mx);
      den += sm_l[w][g] * c;
      num += sm_acc[w][g][d] * c;
    }
    store(ob + g * so.s + d, num / fmaxf(den, 1e-30f));
  }
}

template <typename T, int MAXG>
int launch(const void* q, const void* k, const void* v, void* o, const int* kv_len,
           int64_t kv_len_stride, int kv_len_scalar, Strides sq, Strides sk, Strides sv,
           Strides so, int B, int KH, int G, int S, int D, float scale, cudaStream_t st) {
  const dim3 grid(KH, B);
  decode_kernel<T, MAXG><<<grid, kThreads, 0, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), kv_len, kv_len_stride, kv_len_scalar, sq, sk, sv, so, G, S, D,
      scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* o, const int* kv_len,
             int64_t kv_len_stride, int kv_len_scalar, Strides sq, Strides sk, Strides sv,
             Strides so, int B, int KH, int G, int S, int D, float scale, cudaStream_t st) {
  if (G <= 1)
    return launch<T, 1>(q, k, v, o, kv_len, kv_len_stride, kv_len_scalar, sq, sk, sv, so, B,
                        KH, G, S, D, scale, st);
  if (G <= 2)
    return launch<T, 2>(q, k, v, o, kv_len, kv_len_stride, kv_len_scalar, sq, sk, sv, so, B,
                        KH, G, S, D, scale, st);
  if (G <= 4)
    return launch<T, 4>(q, k, v, o, kv_len, kv_len_stride, kv_len_scalar, sq, sk, sv, so, B,
                        KH, G, S, D, scale, st);
  return launch<T, 8>(q, k, v, o, kv_len, kv_len_stride, kv_len_scalar, sq, sk, sv, so, B, KH,
                      G, S, D, scale, st);
}

}  // namespace

extern "C" int da_forward(const void* q, const void* k, const void* v, void* o,
                          const void* kv_len, int64_t kv_len_stride, int kv_len_scalar,
                          int64_t sqb, int64_t sqh, int64_t sqg,
                          int64_t skb, int64_t skh, int64_t sks,
                          int64_t svb, int64_t svh, int64_t svs,
                          int64_t sob, int64_t soh, int64_t sog,
                          int B, int KH, int G, int S, int D, float scale, int dtype,
                          void* stream) {
  if (D < 2 || D > kMaxD || D % 2 != 0 || G < 1 || G > 8)
    return static_cast<int>(cudaErrorInvalidValue);
  const Strides sq{sqb, sqh, sqg}, sk{skb, skh, sks}, sv{svb, svh, svs}, so{sob, soh, sog};
  const int* lens = static_cast<const int*>(kv_len);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kBF16)
    return dispatch<__nv_bfloat16>(q, k, v, o, lens, kv_len_stride, kv_len_scalar, sq, sk, sv,
                                   so, B, KH, G, S, D, scale, st);
  if (dtype == kF32)
    return dispatch<float>(q, k, v, o, lens, kv_len_stride, kv_len_scalar, sq, sk, sv, so, B,
                           KH, G, S, D, scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
