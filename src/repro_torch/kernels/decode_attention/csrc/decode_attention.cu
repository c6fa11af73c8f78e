// Decode attention (one query token against a KV cache) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `decode_attention` (`_decode_kernel`) of
// src/repro/kernels/decode_attention/kernel.py: for each (batch, KV head)
// the G grouped query heads attend over the cache with an online softmax,
// f32 scores, f32 running max m, running sum l and accumulator, scale
// D^-0.5, positions >= kv_len masked, output in q's dtype.
//
// Bound on the card: bytes.  Every cached K and V element below kv_len is
// read once and used for two multiply-adds per query head: at G = 1 (both
// smoke shapes, 32 query heads over 32 KV heads) one multiply-add per loaded
// byte in bf16, two orders of magnitude under the card's ridge.  At
// zamba2-2.7b's shape (q (4, 1, 32, 80), cache 528) the K and V prefix is
// 21.6 MB, 6.47 us at 3.35 TB/s; at stablelm-3b's (q (8, 1, 32, 80), cache
// 160) 13.1 MB, 3.94 us.
//
// Design.  What the card needs is bytes in flight and few instructions a
// key:
//  - the sequence may be split over blocks: block (split, KV head, batch)
//    takes keys [split * split_len, (split + 1) * split_len).  The wrapper
//    picks the split and the block shape from host-known shapes only (B, KH,
//    the cache capacity S and the SM count; never kv_len), so the launch
//    shape is fixed (`ops.split_plan`, set from `sweep.py`'s timings); at
//    both smoke shapes it is one split, which measured fastest;
//  - a block streams its keys through a ring of K and V chunks in shared
//    memory;
//  - bf16 with 16-byte rows (the model path): one thread issues TMA loads,
//    16 rows of K and of V a box, through (D, KH, S, B) tensor maps built on
//    the host from the cache's strides, and the chunk's mbarrier counts the
//    bytes in; only the 16-row groups that hold keys below kv_len are
//    loaded (rows past S arrive as zeros).  Each of the block's 4 warps
//    (64-key chunks, three stages) or 8 (128-key chunks, two stages, where
//    the grid has at most one block an SM) takes 16 keys of a chunk and
//    computes S = q.K^T and O += P.V with `mma.sync` m16n8k16 (the G <= 8 query heads
//    as rows of A, zero-padded to 16; V's fragments by `ldmatrix.trans`;
//    the two key tiles' products and the output tiles' products issued as
//    independent chains).  Tensor cores do not help the byte bound (two
//    multiply-adds a loaded element at G = 1); they, and TMA in place of
//    16-byte `cp.async` copies, cut the instructions a key, which is what
//    bounded the earlier versions once the bytes were in flight.  As in the
//    Pallas kernel, the probabilities stay f32 for P.V: `mma.sync` takes a
//    bf16 A operand, so P goes in as two, its bf16 rounding in A's rows 0-7
//    and the bf16 rounding of the rest in rows 8-15, which are padding
//    otherwise (G <= 8); each product is exact in the f32 accumulator and
//    the two rows are summed at the end, so P keeps 16 significant bits
//    (bf16: 8) at no extra `mma`;
//  - f32 (and bf16 rows TMA cannot address): 16-byte `cp.async` copies
//    where rows and strides allow (4 bytes else), keys past kv_len
//    zero-filled; lanes split head_dim in element pairs, a dot product is a
//    warp shuffle reduction, and P stays f32, as in the Pallas kernel;
//  - each warp keeps its own (m, l, acc), merged through shared memory at
//    the end of the block.  With one split the block writes the output; with
//    several (at most 8), the splits of one (batch, KV head) run as one
//    thread block cluster: each writes its partial (m, l, acc) in f32 to
//    scratch the wrapper allocates, the cluster synchronises, and split 0
//    merges the partials in split order.  One launch (a second, merging
//    kernel cost more than the split saved at the smoke shapes, and a merge
//    through distributed shared memory measured slower than this one), and
//    no float atomics: the output is bit-identical from run to run;
//  - kv_len is read from device memory (a scalar, or one per batch row), so
//    the caller never synchronises with the host.  Keys at or past it are
//    masked to exactly zero weight (their scores to -1e30 before the max,
//    their probabilities to 0), so values there change nothing as long as
//    they are finite, as in the reference; a split that starts at or past
//    kv_len loads nothing and writes m = -1e30, l = 0, and the merge reads
//    only the splits below kv_len.
// Times measured (chip_smoke.py phase 2; NVIDIA H100 80GB HBM3, 700.00 W):
// 6.424 us at stablelm-3b's shape against SDPA's 8.555 us and the 3.937 us
// bound (one block a head before it: 8.810 us); 9.347 us at zamba2-2.7b's
// against SDPA's 10.686 us and the 6.468 us bound (before: 16.993 us); at
// qwen3-14b's one sequence over a 4096-key cache (8 KV heads, G = 5, D =
// 128), eight splits 19.341 us against one split's 97.321 us, SDPA's
// 11.188 us and the 5.014 us bound: eight splits of 8 heads fill 64 SMs.
//
// Layout: q and o are addressed through (batch, kv head, group) element
// strides, k and v through (batch, kv head, position) strides, all with a
// unit head_dim stride, so the model's (B, S, KH, D) cache is read in place.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxD = 128;
constexpr int kMaxG = 8;
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
enum { kF32 = 0, kBF16 = 1 };

// the CUDA-core path: keys a ring stage holds, and ring depth
constexpr int kChunk = 32;
constexpr int kStages = 4;
constexpr int kMaxPairs = kMaxD / 64;  // element pairs a lane owns
// the tensor-core path: a warp takes 16 keys of each chunk; the wrapper
// picks, for each block, 4 warps (64-key chunks) in a three-stage ring
// (60 KB at D = 80) or 8 (128-key chunks) in two stages (80 KB)
constexpr int kMaxSplits = 8;          // splits of one (batch, KV head): a portable cluster
constexpr int kMaxDevices = 64;        // devices whose shared-memory attribute is tracked

using bf16 = __nv_bfloat16;

struct Strides {
  int64_t b, h, s;  // element strides; head_dim is contiguous
};

struct Args {
  const void *q, *k, *v;
  void* o;
  const int* kv_len;
  int64_t kv_len_stride;
  int kv_len_scalar;
  Strides sq, sk, sv, so;
  int B, KH, G, S, D;
  float scale_log2;  // D^-0.5 * log2(e): the softmax runs in base 2
  int split_len, n_split;
  int ring;          // the tensor-core path's block: 0: 4 warps, 3 stages; 1: 8, 2
  float* part;       // nullptr: one split, the block writes the output
  CUtensorMap tm_k, tm_v;  // (D, KH, S, B) maps, 16-row boxes (tensor-core path)
};

__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load2(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(bf16* p, float v) { *p = __float2bfloat16_rn(v); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// VB bytes from global to shared memory; src_bytes 0 fills zeros, reading nothing
template <int VB>
__device__ __forceinline__ void cp_async(uint32_t dst, const void* src, int src_bytes) {
  if constexpr (VB == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
                 "r"(src_bytes)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(dst), "l"(src),
                 "n"(VB), "r"(src_bytes)
                 : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}


__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  const long long t0 = clock64();
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (!done && clock64() - t0 > 20000000000LL) __trap();
  } while (!done);
}
// 16 rows of one (KV head, batch) from a (D, KH, S, B) map
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, int head, int row0,
                                         int batch, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(0), "r"(head), "r"(row0), "r"(batch), "r"(bar)
      : "memory");
}

// This block's keys: [start, end), end clipped to kv_len and S.
struct Span {
  int start, end;
};
__device__ __forceinline__ int row_len(const Args& a, int b) {  // kv_len of row b, <= S
  return min(a.kv_len != nullptr ? a.kv_len[b * a.kv_len_stride] : a.kv_len_scalar, a.S);
}
__device__ __forceinline__ Span block_span(const Args& a, int split, int b) {
  const int start = split * a.split_len;
  return Span{start, min(min(start + a.split_len, a.S), row_len(a, b))};
}

// K and V rows [first, first + rows) into one ring stage (the CUDA-core
// path); rows at or past `end` are zero-filled and read nothing
template <typename T, int VB>
__device__ __forceinline__ void issue_rows(uint32_t ks, uint32_t vs, const T* kb, const T* vb,
                                           const Args& a, int first, int rows, int end) {
  const int row_bytes = a.D * static_cast<int>(sizeof(T));
  const int pieces = row_bytes / VB;
  for (int idx = threadIdx.x; idx < rows * pieces; idx += blockDim.x) {
    const int r = idx / pieces, pc = idx - r * pieces;
    const int j = first + r;
    const bool ok = j < end;
    const int64_t jj = ok ? j : first;
    cp_async<VB>(ks + r * row_bytes + pc * VB,
                 reinterpret_cast<const char*>(kb + jj * a.sk.s) + pc * VB, ok ? VB : 0);
    cp_async<VB>(vs + r * row_bytes + pc * VB,
                 reinterpret_cast<const char*>(vb + jj * a.sv.s) + pc * VB, ok ? VB : 0);
  }
}

// Shared memory for the warps' (m, l, acc), carved from the ring once the
// ring is drained: m [warp][g], l [warp][g], acc [warp][g][d].
__host__ __device__ constexpr int merge_floats(int D, int NW) { return NW * kMaxG * (2 + D); }

// Merge the four warps' partial softmaxes (in warp order).  One split: write
// the output.  Several: the splits of one (batch, KV head) are one thread
// block cluster; each writes its partial (m, l, acc) to the scratch, the
// cluster synchronises, and split 0 combines the partials of the splits
// below kv_len, in split order, into the output.
template <typename T, int NW>
__device__ __forceinline__ void finish_block(const Args& a, const float* sm, int split, int kh,
                                             int b) {
  const int G = a.G, D = a.D;
  const float* sm_m = sm;
  const float* sm_l = sm + NW * kMaxG;
  const float* sm_acc = sm + 2 * NW * kMaxG;
  T* ob = static_cast<T*>(a.o) + b * a.so.b + kh * a.so.h;
  // the cluster's partials: m and l at part_ml[2 * (split * G + g)], acc after all of them
  const int64_t slot0 = (static_cast<int64_t>(b) * a.KH + kh) * a.n_split;
  float* part_ml = a.part + 2 * slot0 * G;
  float* part_acc = a.part + 2 * static_cast<int64_t>(a.B) * a.KH * a.n_split * G + slot0 * G * D;
  for (int idx = threadIdx.x; idx < G * D; idx += blockDim.x) {
    const int g = idx / D, d = idx - g * D;
    float mx = kNegInf;
#pragma unroll
    for (int w = 0; w < NW; ++w) mx = fmaxf(mx, sm_m[w * kMaxG + g]);
    float den = 0.0f, num = 0.0f;
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      const float c = exp2f(sm_m[w * kMaxG + g] - mx);
      den += sm_l[w * kMaxG + g] * c;
      num += sm_acc[(w * kMaxG + g) * D + d] * c;
    }
    if (a.part == nullptr) {
      store(ob + g * a.so.s + d, num / fmaxf(den, 1e-30f));
    } else {
      part_acc[(split * G + g) * D + d] = num;
      if (d == 0) {
        part_ml[2 * (split * G + g)] = mx;
        part_ml[2 * (split * G + g) + 1] = den;
      }
    }
  }
  if (a.part == nullptr) return;
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
  if (split != 0) return;
  const int L = row_len(a, b);
  const int n_used = L > 0 ? min(a.n_split, (L + a.split_len - 1) / a.split_len) : 0;
  for (int idx = threadIdx.x; idx < G * D; idx += blockDim.x) {
    const int g = idx / D, d = idx - g * D;
    // every split's (m, l, acc) in one round of loads, then the merge
    float pm[kMaxSplits], pl[kMaxSplits], pacc[kMaxSplits];
#pragma unroll
    for (int s = 0; s < kMaxSplits; ++s) {
      const bool used = s < n_used;
      pm[s] = used ? part_ml[2 * (s * G + g)] : kNegInf;
      pl[s] = used ? part_ml[2 * (s * G + g) + 1] : 0.0f;
      pacc[s] = used ? part_acc[(s * G + g) * D + d] : 0.0f;
    }
    float mx = kNegInf;
#pragma unroll
    for (int s = 0; s < kMaxSplits; ++s) mx = fmaxf(mx, pm[s]);
    float den = 0.0f, num = 0.0f;
#pragma unroll
    for (int s = 0; s < kMaxSplits; ++s) {
      if (s >= n_used) break;
      const float c = exp2f(pm[s] - mx);
      den += pl[s] * c;
      num += pacc[s] * c;
    }
    store(ob + g * a.so.s + d, num / fmaxf(den, 1e-30f));
  }
}

// ------------------------------------------------------- CUDA-core path

// MAXG: the largest group size this instance takes (G <= MAXG at run time);
// VB: the cp.async width in bytes (16, or 4 where rows or strides are not
// 16-byte aligned)
template <typename T, int MAXG, int VB>
__global__ void __launch_bounds__(kThreads)
split_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char ring[];
  constexpr int kKeysPerWarp = kChunk / kWarps;
  const int split = blockIdx.x, kh = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int G = a.G, D = a.D, npairs = D / 2;
  const Span sp = block_span(a, split, b);
  const int n_chunks = sp.end > sp.start ? (sp.end - sp.start + kChunk - 1) / kChunk : 0;

  const T* qb = static_cast<const T*>(a.q) + b * a.sq.b + kh * a.sq.h;
  const T* kb = static_cast<const T*>(a.k) + b * a.sk.b + kh * a.sk.h;
  const T* vb = static_cast<const T*>(a.v) + b * a.sv.b + kh * a.sv.h;
  const int stage_bytes = 2 * kChunk * D * static_cast<int>(sizeof(T));
  const uint32_t ring_addr = static_cast<uint32_t>(__cvta_generic_to_shared(ring));
  auto issue = [&](int c) {
    const uint32_t ks = ring_addr + (c % kStages) * stage_bytes;
    issue_rows<T, VB>(ks, ks + stage_bytes / 2, kb, vb, a, sp.start + c * kChunk, kChunk, sp.end);
  };
  // every stage full from the start; a stage is refilled as soon as its
  // chunk is used, so kStages chunks stay in flight (one commit group a chunk)
#pragma unroll
  for (int c = 0; c < kStages; ++c) {
    if (c < n_chunks) issue(c);
    cp_async_commit();
  }

  float qr[MAXG][kMaxPairs][2];
#pragma unroll
  for (int g = 0; g < MAXG; ++g) {
#pragma unroll
    for (int i = 0; i < kMaxPairs; ++i) {
      const int p = lane + 32 * i;
      float2 t = make_float2(0.0f, 0.0f);
      if (g < G && p < npairs) t = load2(qb + g * a.sq.s + 2 * p);
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

  for (int c = 0; c < n_chunks; ++c) {
    cp_async_wait<kStages - 1>();  // chunk c has landed
    __syncthreads();

    const T* ks = reinterpret_cast<const T*>(ring + (c % kStages) * stage_bytes);
    const T* vs = ks + kChunk * D;
    const int r0 = warp * kKeysPerWarp;
    const int j0 = sp.start + c * kChunk + r0;
    float2 kr[kKeysPerWarp][kMaxPairs], vr[kKeysPerWarp][kMaxPairs];
#pragma unroll
    for (int u = 0; u < kKeysPerWarp; ++u) {
#pragma unroll
      for (int i = 0; i < kMaxPairs; ++i) {
        const int p = lane + 32 * i;
        const bool ok = p < npairs;
        kr[u][i] = ok ? load2(ks + (r0 + u) * D + 2 * p) : make_float2(0.0f, 0.0f);
        vr[u][i] = ok ? load2(vs + (r0 + u) * D + 2 * p) : make_float2(0.0f, 0.0f);
      }
    }
#pragma unroll
    for (int g = 0; g < MAXG; ++g) {
      if (g >= G) break;
      float s[kKeysPerWarp];
      float mx = kNegInf;
#pragma unroll
      for (int u = 0; u < kKeysPerWarp; ++u) {
        float dot = 0.0f;
#pragma unroll
        for (int i = 0; i < kMaxPairs; ++i)
          dot += qr[g][i][0] * kr[u][i].x + qr[g][i][1] * kr[u][i].y;
        s[u] = warp_sum(dot) * a.scale_log2;
        if (j0 + u < sp.end) mx = fmaxf(mx, s[u]);
      }
      const float m_new = fmaxf(m[g], mx);
      const float corr = exp2f(m[g] - m_new);
      float psum = 0.0f;
      float pv[kMaxPairs][2];
#pragma unroll
      for (int i = 0; i < kMaxPairs; ++i) pv[i][0] = pv[i][1] = 0.0f;
#pragma unroll
      for (int u = 0; u < kKeysPerWarp; ++u) {
        const float p = j0 + u < sp.end ? exp2f(s[u] - m_new) : 0.0f;
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
    __syncthreads();  // every warp is done with this stage before it is refilled
    if (c + kStages < n_chunks) issue(c + kStages);
    cp_async_commit();
  }
  cp_async_wait<0>();
  __syncthreads();

  float* sm = reinterpret_cast<float*>(ring);
#pragma unroll
  for (int g = 0; g < MAXG; ++g) {
    if (g >= G) break;
    if (lane == 0) {
      sm[warp * kMaxG + g] = m[g];
      sm[kWarps * kMaxG + warp * kMaxG + g] = l[g];
    }
#pragma unroll
    for (int i = 0; i < kMaxPairs; ++i) {
      const int p = lane + 32 * i;
      if (p < npairs) {
        float* row = sm + 2 * kWarps * kMaxG + (warp * kMaxG + g) * D;
        row[2 * p] = acc[g][i][0];
        row[2 * p + 1] = acc[g][i][1];
      }
    }
  }
  __syncthreads();
  finish_block<T, kWarps>(a, sm, split, kh, b);
}

// ----------------------------------------------------- tensor-core path

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// (x, y) as two bf16x2 A-operand registers whose sum is (x, y) to 16
// significant bits: the bf16 rounding, and the bf16 rounding of the rest
__device__ __forceinline__ void split_bf16(float x, float y, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 r = __floats2bfloat162_rn(x - hf.x, y - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&r);
}

// D (16x8, f32) += A (16x16, bf16, row) * B (16x8, bf16, col)
// not volatile: a pure function of its registers, free to be scheduled
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// the B fragment of a 16-key x 8-column block of row-major V in shared memory
__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t addr, uint32_t& b0, uint32_t& b1) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(b0), "=r"(b1)
               : "r"(addr)
               : "memory");
}

// KS: head_dim's k-steps of 16 (D <= 16 KS); D a multiple of 8, 16-byte rows
// NW warps, each taking 16 keys (one k-step of P.V) of each chunk of 16 NW
// keys, in a ring of STAGES chunks
template <int KS, int NW, int STAGES>
__global__ void __launch_bounds__(NW * 32)
mma_kernel(const __grid_constant__ Args a) {
  constexpr int CHUNK = 16 * NW;
  constexpr int NT = 2 * KS;  // output column tiles of 8
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int split = blockIdx.x, kh = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;  // mma fragment coordinates
  const int G = a.G, D = a.D;
  const Span sp = block_span(a, split, b);
  const int n_chunks = sp.end > sp.start ? (sp.end - sp.start + CHUNK - 1) / CHUNK : 0;

  const bf16* qb = static_cast<const bf16*>(a.q) + b * a.sq.b + kh * a.sq.h;
  const bf16* kb = static_cast<const bf16*>(a.k) + b * a.sk.b + kh * a.sk.h;
  const bf16* vb = static_cast<const bf16*>(a.v) + b * a.sv.b + kh * a.sv.h;
  const int row_bytes = 2 * D;
  const int stage_bytes = 2 * CHUNK * row_bytes;
  // the ring starts on a 128-byte boundary; `ring` is the same bytes through
  // a generic pointer, for the loads that do not go through TMA
  const uint32_t raw_addr = static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  const uint32_t ring_addr = (raw_addr + 127) & ~127u;
  unsigned char* const ring = smem_raw + (ring_addr - raw_addr);
  const uint32_t bars = ring_addr + STAGES * stage_bytes;
  if (threadIdx.x == 0) {
    for (int st = 0; st < STAGES; ++st) mbar_init(bars + 8 * st, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // thread 0: the 16-row groups of chunk c that hold keys below `end`
  auto issue = [&](int c) {
    const uint32_t ks = ring_addr + (c % STAGES) * stage_bytes;
    const uint32_t full = bars + 8 * (c % STAGES);
    const int first = sp.start + c * CHUNK;
    const int groups = min(NW, (sp.end - first + 15) / 16);
    mbar_expect_tx(full, groups * 16 * row_bytes * 2);
    for (int u = 0; u < groups; ++u) {
      tma_load(ks + u * 16 * row_bytes, &a.tm_k, kh, first + 16 * u, b, full);
      tma_load(ks + stage_bytes / 2 + u * 16 * row_bytes, &a.tm_v, kh, first + 16 * u, b, full);
    }
  };
  if (threadIdx.x == 0)
    for (int c = 0; c < STAGES && c < n_chunks; ++c) issue(c);

  // q as the A operand: row g is query head g (rows >= G, and 8-15, zero)
  uint32_t qa[KS][4];
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    const int col = ks * 16 + 2 * t;
    qa[ks][0] = (g < G && col < D) ? ld32(qb + g * a.sq.s + col) : 0u;
    qa[ks][2] = (g < G && col + 8 < D) ? ld32(qb + g * a.sq.s + col + 8) : 0u;
    qa[ks][1] = qa[ks][3] = 0u;
  }

  float m = kNegInf, l = 0.0f;  // row g's running max (base 2) and this lane's share of l
  float acc[NT][4];
#pragma unroll
  for (int i = 0; i < NT; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.0f;

  for (int c = 0; c < n_chunks; ++c) {
    mbar_wait(bars + 8 * (c % STAGES), (c / STAGES) & 1);  // chunk c has landed

    const int r0 = warp * 16;
    const int j0 = sp.start + c * CHUNK + r0;
    if (j0 < sp.end) {  // warp-uniform: this warp's keys hold at least one below `end`
      const bf16* ks = reinterpret_cast<const bf16*>(ring + (c % STAGES) * stage_bytes);
      const uint32_t vs = ring_addr + (c % STAGES) * stage_bytes + stage_bytes / 2;
      // k-steps outermost: the two key tiles' products are independent chains
      float s[2][4] = {};
#pragma unroll
      for (int kstep = 0; kstep < KS; ++kstep) {
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          const bf16* krow = ks + (r0 + nt * 8 + g) * D;
          const int col = kstep * 16 + 2 * t;
          const uint32_t b0 = col < D ? ld32(krow + col) : 0u;
          const uint32_t b1 = col + 8 < D ? ld32(krow + col + 8) : 0u;
          mma_bf16(s[nt], qa[kstep], b0, b1);
        }
      }
      // row g: keys 8nt + 2t + e of this warp's 16
      float mx = kNegInf;
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const bool ok = j0 + nt * 8 + 2 * t + e < sp.end;
          s[nt][e] = ok ? s[nt][e] * a.scale_log2 : kNegInf;
          mx = fmaxf(mx, s[nt][e]);
        }
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m, mx);
      const float corr = exp2f(m - m_new);
      m = m_new;
      float p[2][2];
      float psum = 0.0f;
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          p[nt][e] = j0 + nt * 8 + 2 * t + e < sp.end ? exp2f(s[nt][e] - m_new) : 0.0f;
          psum += p[nt][e];
        }
      }
      l = l * corr + psum;
      // P in A's rows 0-7 as its bf16 rounding, and in rows 8-15 (padding
      // else: G <= 8) as the bf16 rounding of the rest; the two rows'
      // products are summed in f32 at the end
      uint32_t pa[4];
      split_bf16(p[0][0], p[0][1], pa[0], pa[1]);
      split_bf16(p[1][0], p[1][1], pa[2], pa[3]);
      // lanes 0-15 address V rows r0 + 0..15 at column 8i: ldmatrix.trans
      // hands each lane its B fragment {V[2t][g], V[2t+1][g]}, {V[2t+8][g], ...};
      // all of V's fragments first, then the independent products
      const uint32_t vrow = vs + (r0 + (lane & 15)) * row_bytes;
      uint32_t vb0[NT], vb1[NT];
#pragma unroll
      for (int i = 0; i < NT; ++i)
        if (8 * i < D) ldmatrix_x2_trans(vrow + 16 * i, vb0[i], vb1[i]);
#pragma unroll
      for (int i = 0; i < NT; ++i) {
        if (8 * i >= D) break;
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][e] *= corr;
        mma_bf16(acc[i], pa, vb0[i], vb1[i]);
      }
    }
    __syncthreads();  // every warp is done with this stage before it is refilled
    if (threadIdx.x == 0 && c + STAGES < n_chunks) issue(c + STAGES);
  }
  __syncthreads();

  l += __shfl_xor_sync(0xffffffffu, l, 1);
  l += __shfl_xor_sync(0xffffffffu, l, 2);
  float* sm = reinterpret_cast<float*>(ring);
  if (g < G) {
    if (t == 0) {
      sm[warp * kMaxG + g] = m;
      sm[NW * kMaxG + warp * kMaxG + g] = l;
    }
    float* row = sm + 2 * NW * kMaxG + (warp * kMaxG + g) * D;
#pragma unroll
    for (int i = 0; i < NT; ++i) {
      if (8 * i >= D) break;
      row[8 * i + 2 * t] = acc[i][0] + acc[i][2];  // P's high and low parts
      row[8 * i + 2 * t + 1] = acc[i][1] + acc[i][3];
    }
  }
  __syncthreads();
  finish_block<bf16, NW>(a, sm, split, kh, b);
}

// ------------------------------------------------------------------ host

// set the kernel's shared-memory ceiling once per template instance and
// device: the attribute belongs to the current device's context
template <typename K>
cudaError_t allow_smem(K kernel, int bytes, bool (&done)[kMaxDevices]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && done[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess && dev < kMaxDevices) done[dev] = true;
  return err;
}

// one block per (split, KV head, batch); the splits of one (batch, KV head)
// form a cluster when there are several
template <typename K>
int launch_blocks(K kernel, const Args& a, int threads, int smem, cudaStream_t st) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.n_split, a.KH, a.B);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = a.n_split;
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = 1;
  cfg.attrs = cluster;
  cfg.numAttrs = a.n_split > 1 ? 1 : 0;
  return static_cast<int>(cudaLaunchKernelEx(&cfg, kernel, a));
}

template <typename T, int MAXG, int VB>
int launch_cuda_cores(const Args& a, cudaStream_t st) {
  static bool attr[kMaxDevices] = {};
  const int most = kStages * 2 * kChunk * kMaxD * static_cast<int>(sizeof(T));
  cudaError_t err = allow_smem(split_kernel<T, MAXG, VB>, most, attr);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int ring = kStages * 2 * kChunk * a.D * static_cast<int>(sizeof(T));
  const int smem = max(ring, merge_floats(a.D, kWarps) * 4);
  return launch_blocks(split_kernel<T, MAXG, VB>, a, kThreads, smem, st);
}

template <int KS, int NW, int STAGES>
int launch_tensor_cores(const Args& a, cudaStream_t st) {
  static bool attr[kMaxDevices] = {};
  constexpr int kRows = STAGES * 2 * NW * 16;  // K and V rows in the ring
  const int most = min(kRows * 2 * kMaxD + 256, 232448);
  cudaError_t err = allow_smem(mma_kernel<KS, NW, STAGES>, most, attr);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int smem = max(kRows * 2 * a.D + 128 + 8 * STAGES, merge_floats(a.D, NW) * 4 + 128);
  return launch_blocks(mma_kernel<KS, NW, STAGES>, a, NW * 32, smem, st);
}

template <int KS>
int launch_tensor_cores(const Args& a, cudaStream_t st) {
  return a.ring == 0 ? launch_tensor_cores<KS, 4, 3>(a, st) : launch_tensor_cores<KS, 8, 2>(a, st);
}

template <typename T, int MAXG>
int launch_vb(const Args& a, bool aligned16, cudaStream_t st) {
  return aligned16 ? launch_cuda_cores<T, MAXG, 16>(a, st) : launch_cuda_cores<T, MAXG, 4>(a, st);
}

template <typename T>
int dispatch_cuda_cores(const Args& a, bool aligned16, cudaStream_t st) {
  if (a.G <= 1) return launch_vb<T, 1>(a, aligned16, st);
  if (a.G <= 2) return launch_vb<T, 2>(a, aligned16, st);
  if (a.G <= 4) return launch_vb<T, 4>(a, aligned16, st);
  return launch_vb<T, 8>(a, aligned16, st);
}

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);
EncodeTiledFn encode_fn() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault,
                                         &q) == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}
bool encode(CUtensorMap* map, const void* ptr, int D, int KH, int S, int B, Strides st) {
  EncodeTiledFn fn = encode_fn();
  if (fn == nullptr) return false;
  const uint64_t row = static_cast<uint64_t>(D) * 2;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(KH),
                              static_cast<cuuint64_t>(S), static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {KH > 1 ? st.h * 2 : row, S > 1 ? st.s * 2 : row,
                                 B > 1 ? st.b * 2 : row};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(D), 1, 16, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides, box,
            elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

int dispatch_tensor_cores(const Args& a, cudaStream_t st) {
  switch ((a.D + 15) / 16) {
    case 1: return launch_tensor_cores<1>(a, st);
    case 2: return launch_tensor_cores<2>(a, st);
    case 3: return launch_tensor_cores<3>(a, st);
    case 4: return launch_tensor_cores<4>(a, st);
    case 5: return launch_tensor_cores<5>(a, st);
    case 6: return launch_tensor_cores<6>(a, st);
    case 7: return launch_tensor_cores<7>(a, st);
    default: return launch_tensor_cores<8>(a, st);
  }
}

}  // namespace

extern "C" int da_forward(const void* q, const void* k, const void* v, void* o,
                          const void* kv_len, int64_t kv_len_stride, int kv_len_scalar,
                          int64_t sqb, int64_t sqh, int64_t sqg,
                          int64_t skb, int64_t skh, int64_t sks,
                          int64_t svb, int64_t svh, int64_t svs,
                          int64_t sob, int64_t soh, int64_t sog,
                          int B, int KH, int G, int S, int D, float scale, int dtype,
                          int split_len, int n_split, int ring, void* part,
                          void* stream) {
  if (D < 2 || D > kMaxD || D % 2 != 0 || G < 1 || G > kMaxG || n_split < 1 ||
      n_split > kMaxSplits ||
      split_len < 1 || static_cast<int64_t>(split_len) * n_split < S ||
      static_cast<int64_t>(split_len) * (n_split - 1) >= S || (n_split > 1 && part == nullptr) ||
      ring < 0 || ring > 1)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{q, k, v, o, static_cast<const int*>(kv_len), kv_len_stride, kv_len_scalar,
               Strides{sqb, sqh, sqg}, Strides{skb, skh, sks}, Strides{svb, svh, svs},
               Strides{sob, soh, sog}, B, KH, G, S, D, scale * kLog2e, split_len, n_split,
               ring, n_split > 1 ? static_cast<float*>(part) : nullptr};
  // 16-byte copies where the K and V rows, their strides and bases allow
  const int64_t es = dtype == kBF16 ? 2 : 4;
  const uint64_t bits = reinterpret_cast<uintptr_t>(k) | reinterpret_cast<uintptr_t>(v) |
                        static_cast<uint64_t>(D * es) | static_cast<uint64_t>(skb * es) |
                        static_cast<uint64_t>(skh * es) | static_cast<uint64_t>(sks * es) |
                        static_cast<uint64_t>(svb * es) | static_cast<uint64_t>(svh * es) |
                        static_cast<uint64_t>(svs * es);
  const bool aligned16 = bits % 16 == 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kBF16 && aligned16) {
    if (!encode(&a.tm_k, k, D, KH, S, B, a.sk) || !encode(&a.tm_v, v, D, KH, S, B, a.sv))
      return static_cast<int>(cudaErrorInvalidValue);
    return dispatch_tensor_cores(a, st);
  }
  if (dtype == kBF16) return dispatch_cuda_cores<bf16>(a, aligned16, st);
  if (dtype == kF32) return dispatch_cuda_cores<float>(a, aligned16, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
