// Chunked linear attention with decay (the Mamba2 SSD scan, and the
// mLSTM's scan at state widths (hd, hd + 1)) for Hopper (sm_90a).
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
// Bound on the card.  At zamba2-2.7b's prefill (4, 512, 80, 64), chunk
// 256, bf16: a chunk does ~21 MFLOP on ~100 KB of inputs; q.k^T has two
// bf16 operands, and the other three products each have an f32 operand
// (the decayed scores, the state, the weighted keys) that must keep
// f32-level precision (the final state is held to atol 5e-4 / rtol 2e-3
// even in bf16).  With those as two bf16 parts (below) the operations take
// 13.6 us at the data sheet's bf16 rate and the 48.4 MB of inputs and
// outputs 14.4 us at 3.35 TB/s: bytes, by a little.  At xlstm-1.3b's mLSTM
// prefill (4, 512, 4, DK 1024, DV 1025), chunk 256, bf16: the f32 final
// state alone is 67 MB, the 134 MB of inputs and outputs take 40 us, and
// the products, the local state and q.S (16.8 MFLOP a row, DK x DV) above
// all, 59 us with the same parts: operations.
//
// Design.  On the TPU the state rides across a sequential grid axis in
// VMEM.  Here the recurrence is regrouped at the chunk boundaries the
// `chunk` argument defines (the SSD decomposition), in three launches:
//  1. `local_kernel`, a block of 4 warps per (chunk, head, batch): the
//     chunk's cumulative log decay (a warp shuffle scan, written to scratch
//     with log_i) and its local state L_c = sum_s w_s k_s v_s^T, w_s =
//     exp(clip(total - cum_s + li_s)), all chunks in parallel;
//  2. `fold_kernel`, a thread per (batch, head, state element): the short
//     recurrence S_c = exp(clip(total_c)) S_{c-1} + L_c in chunk order,
//     writing the state entering each chunk as the bf16 parts pass 3
//     multiplies by, and the final state;
//  3. `output_kernel`, a block of 4 warps per (head, batch, 64-row block of
//     a chunk): y for its rows from the state entering the chunk (skipped
//     for the first chunk, whose entering state is zero) and the key blocks
//     on or below the diagonal; blocks nearer the end of a chunk, which
//     have more key blocks, are scheduled first.
// At zamba2-2.7b's prefill that is 640 blocks, then 2,560 output blocks,
// where one block per (batch, head) walking the chunks in order gave 320.
// Sums run in a fixed order, with no atomics: the output is bit-identical
// from run to run.
//
// Every product runs on the tensor cores (`mma.sync` m16n8k16, bf16
// operands, f32 accumulation).  An operand that is not exact in bf16 goes
// in as a sum of bf16 parts, each the bf16 rounding of what the earlier
// parts leave, and a product takes the part pairs (i, j) with i + j < NP:
//  - bf16 inputs (the model path): q, k, v are one part each; the f32
//    operands (decayed scores, state, weighted keys) two parts, 16
//    significant bits (NP = 2), so q.k^T is one `mma` and each other
//    product two;
//  - f32 inputs: every operand three parts, 24 bits (NP = 3, six `mma`s a
//    product): the f32 path keeps f32 precision on the tensor cores.
// Each warp of an output block owns 16 rows of the 64-row tile; the
// decayed scores go from the q.k^T accumulators straight into the A
// operand of P.V in registers.  The decay is taken in base 2, one add, the
// clip and one `ex2` an element, the keys' li_s - cum_s hoisted out of the
// rows (the first version's per-element expf of three terms was the
// largest cost in the kernel); blocks below the diagonal skip the mask.
// Tiles sit in shared memory as bf16 planes (one a part) at a 144-byte row
// pitch, so `ldmatrix` reads are free of bank conflicts.  bf16 tiles whose
// rows are 16-byte aligned stream in by 16-byte `cp.async` copies through
// a two-stage ring (the next key block loads while the current one is
// multiplied), and so do pass 3's gates and entering state, from the
// scratch passes 1 and 2 write; the entering state sits in the ring's
// second stage until it is used, so an output block takes 47 KB and four
// fit an SM.  f32 tiles, and bf16 tiles `cp.async` cannot address, are
// loaded element by element and split into parts on the way.  q, k, v and
// the gates are read through (batch, time, head) strides, so Mamba2's head
// broadcast of q and k (head stride 0) and the model's (B, T, NH, D)
// layout need no copy; the broadcast q and k tiles of one (batch, chunk)
// are shared by the 80 heads' blocks through L2.  DK and DV are
// zero-padded to 64 (exact), and any T works: a short last chunk equals the
// reference's zero padding.
//
// Wide states (DK or DV past 64; the mLSTM's 1024 x 1025 is 16 x 17 tiles
// of 64 x 64, 4.2 MB of f32 state a (batch, head), where the Pallas kernel
// holds the whole state in VMEM).  Pass 1 takes a block per (chunk, state
// tile, head, batch) and only the (0, 0) tile's block writes the gate
// scratch; pass 2 a thread per element of the tiled state, writing the
// entering state tile by tile.  Pass 3 needs q.k^T summed over every DK
// tile for each of the DV tiles' outputs: summing it again in each DV
// tile's block would repeat it 17 times at DV = 1025 (more operations than
// q.S itself), so `scores_kernel` (a block per (chunk, row block, key block
// <= it)) sums it once over the DK tiles, applies the decay and the mask,
// and writes the scores in f32 to scratch (B, NH, nc, pairs, 64, 64), 5 MB
// at the mLSTM's shape, read back from L2; `output_wide_kernel` (a block
// per (chunk, row block, DV tile)) then runs a two-stage ring over (q's DK
// tile, the entering state's tile) pairs for q.S and (scores, v) pairs for
// P.V, the scores split into their MID parts as they load.  q, k and v
// keep 16-byte copies wherever their rows allow; the wrapper hands a v
// whose rows do not (hd + 1 wide, 2-byte aligned) to the kernel as a copy
// with rows zero-padded to a multiple of 8.
//
// Measured (chip_smoke.py --parent; NVIDIA H100 80GB HBM3, 700.00 W):
// 104.113 us at zamba2-2.7b's prefill against the 667.518 us of the
// one-block-a-head CUDA-core kernel it replaces and the 14.437 us bound;
// local 24.106, fold 11.420, output 65.180 us.  With the f32 operands as
// one bf16 part (MID = 1) the bf16 check's final state misses the f32
// bound (max|err| 0.0115 against 1.96e-05 with two parts).  The output kernel is far from its tensor-core
// time, and neither its tile traffic nor its load latency is what holds it
// back: 128-row blocks, which cut the tiles loaded again by each block by
// a third, gained little, and deeper rings, which cost resident blocks,
// lost.  What is left is per-block fixed cost and too few warps an SM to
// hide the latency of each warp's dependent chain (q.k^T, the decay, the
// splits, P.V); a persistent kernel that overlaps one block's loads and
// epilogue with the next block's work, and the fold fused into pass 1,
// are the next steps.
//
// Wide path, measured (chip_smoke.py; NVIDIA H100 80GB HBM3, 700.00 W): at
// xlstm-1.3b's mLSTM prefill (4, 512, 4, 1024, 1025), chunk 256, bf16,
// 675.442 us against the 58.708 us bound (local 222.805, fold 148.752,
// scores 29.119, output 244.472 us, and 28.0 us for the wrapper's copy of
// v; with v loaded element by element and the local states untiled it
// took 971.867 us); f32, 3112.218 us, pass 1 alone 1919.451 (element
// loads of f32 tiles, three parts, two blocks an SM).  The narrow path
// read 103.307 us at zamba2-2.7b's prefill.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kTile = 64;                 // rows of a tile; DK and DV padded to it
constexpr int kPitch = 72;                // bf16 a shared-memory row: 144 bytes
constexpr int kPlane = kTile * kPitch;    // bf16 of one 64-row plane
constexpr int kPlaneBytes = kPlane * 2;
constexpr float kClip = 30.0f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kMaxDevices = 64;
enum { kF32 = 0, kBF16 = 1 };

using bf16 = __nv_bfloat16;

struct Strides {
  int64_t b, t, h;  // element strides; the feature dim is contiguous
};

struct Args {
  const void *q, *k, *v;
  const float *log_g, *log_i;
  void* y;
  float* state;  // (B, NH, DK, DV): the final state
  // scratch the wrapper allocates:
  float* cum;       // (B, NH, T): the cumulative log decay within each chunk
  float* li;        // (B, NH, T): log_i, or 0
  float* local;     // (B, NH, nc, nk, nv, 64, 64): the chunks' local states L_c,
                    // tile by 64 x 64 tile
  bf16* entering;   // (B, NH, nc, nk, nv, MID, 64, 64): the state entering chunk c,
                    // tile by 64 x 64 tile, in MID parts
  float* scores;    // wide path: (B, NH, nc, n_tri, 64, 64), the decayed scores of each
                    // (row block, key block <= it) pair of a chunk
  Strides sq, sk, sv, sg, si, sy;
  int B, T, NH, DK, DV, chunk, nc;
  int nk, nv;  // 64-wide tiles of DK and DV
  // per tensor: bf16 rows by 16-byte cp.async (aligned base and strides,
  // width % 8 == 0)
  int vq, vk, vv;
};

// parts of an input (IN) and of an f32 operand (MID); a product takes the
// part pairs (i, j) with i + j < MID
template <typename T>
struct Parts;
template <>
struct Parts<bf16> {
  static constexpr int IN = 1, MID = 2;
};
template <>
struct Parts<float> {
  static constexpr int IN = 3, MID = 3;
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float clip(float x) { return fminf(fmaxf(x, -kClip), kClip); }
// the clip of a log decay in base 2 (x log2(e)), and 2^x
__device__ __forceinline__ float clip2(float x) {
  return fminf(fmaxf(x, -kClip * kLog2e), kClip * kLog2e);
}
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// x as N bf16 parts, each the rounding of what the earlier ones leave
template <int N>
__device__ __forceinline__ void split(float x, bf16 (&p)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    p[i] = __float2bfloat16_rn(x);
    x -= __bfloat162float(p[i]);
  }
}

// (x, y) as N bf16x2 registers (x in the low half)
template <int N>
__device__ __forceinline__ void split2(float x, float y, uint32_t* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
    const float2 hf = __bfloat1622float2(h);
    r[i] = *reinterpret_cast<const uint32_t*>(&h);
    x -= hf.x;
    y -= hf.y;
  }
}

__device__ __forceinline__ float2 unpack(uint32_t r) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&r));
}

// D (16x8, f32) += A (16x16, bf16, row) * B (16x8, bf16, col)
__device__ __forceinline__ void mma(float* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldsm(uint32_t addr, uint32_t* r) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}
__device__ __forceinline__ void ldsm_t(uint32_t addr, uint32_t* r) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ldmatrix addresses, byte offsets into a plane for this lane:
// A (rows m0.., cols k0..) from a row-major [m][k] plane
__device__ __forceinline__ int a_off(int m0, int k0, int lane) {
  return ((m0 + (lane & 7) + 8 * ((lane >> 3) & 1)) * kPitch + k0 + 8 * (lane >> 4)) * 2;
}
// B fragments of the n-tiles n0 and n0 + 8, k0.., from a [n][k] plane
// (non-transposed): r0, r1 for n0, r2, r3 for n0 + 8
__device__ __forceinline__ int bn_off(int n0, int k0, int lane) {
  return ((n0 + (lane & 7) + 8 * (lane >> 4)) * kPitch + k0 + 8 * ((lane >> 3) & 1)) * 2;
}
// the same from a [k][n] plane (transposed): r0, r1 for n0, r2, r3 for n0 + 8
__device__ __forceinline__ int bk_off(int k0, int n0, int lane) {
  return ((k0 + (lane & 7) + 8 * ((lane >> 3) & 1)) * kPitch + n0 + 8 * (lane >> 4)) * 2;
}
// A (m = features d0.., k = rows s0..) from a [s][d] plane (transposed)
__device__ __forceinline__ int at_off(int s0, int d0, int lane) {
  return ((s0 + (lane & 7) + 8 * (lane >> 4)) * kPitch + d0 + 8 * ((lane >> 3) & 1)) * 2;
}

// rows [0, rows) x cols [0, width) of a (time, feature) slice into P bf16
// planes (zero elsewhere in the 64 x 64 tile).  vec: 16-byte cp.async
// copies (bf16, one part; the caller commits); else element loads, split.
template <typename T, int P>
__device__ __forceinline__ void load_tile(bf16* dst, const T* src, int64_t rs, int rows,
                                          int width, bool vec) {
  if constexpr (P == 1 && sizeof(T) == 2) {
    if (vec) {
      const uint32_t base = smem_addr(dst);
      for (int idx = threadIdx.x; idx < kTile * 8; idx += kThreads) {
        const int r = idx >> 3, c = (idx & 7) * 8;
        const bool ok = r < rows && c < width;
        cp_async16(base + (r * kPitch + c) * 2, ok ? src + r * rs + c : src, ok ? 16 : 0);
      }
      return;
    }
  }
  for (int idx = threadIdx.x; idx < kTile * kTile; idx += kThreads) {
    const int r = idx >> 6, c = idx & 63;
    const float x = r < rows && c < width ? to_f32(src[r * rs + c]) : 0.0f;
    bf16 p[P];
    split<P>(x, p);
#pragma unroll
    for (int i = 0; i < P; ++i) dst[i * kPlane + r * kPitch + c] = p[i];
  }
}

// ---------------------------------------------------------------- pass 1

// one 64 x 64 tile (DK tile dk, DV tile dv) of the chunk's local state
// L_c = sum_s (k_s w_s) v_s^T, and (tile (0, 0)) the chunk's cumulative
// decay; shared memory: a two-stage ring of (k, v) tiles, then cum and w
template <typename T>
__global__ void __launch_bounds__(kThreads)
local_kernel(const __grid_constant__ Args a) {
  constexpr int IN = Parts<T>::IN, MID = Parts<T>::MID;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* ring = reinterpret_cast<bf16*>(smem);  // stage st: k planes, then v planes
  float* cum = reinterpret_cast<float*>(smem + 2 * 2 * IN * kPlaneBytes);
  const int c = blockIdx.x % a.nc, tile = blockIdx.x / a.nc, h = blockIdx.y, b = blockIdx.z;
  const int dk = tile / a.nv, dv = tile % a.nv;
  const int wk = min(kTile, a.DK - dk * kTile), wv = min(kTile, a.DV - dv * kTile);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int c0 = c * a.chunk, Lc = min(a.chunk, a.T - c0);
  const int n_tiles = (Lc + kTile - 1) / kTile;
  float* w = cum + n_tiles * kTile;
  const T* kb = static_cast<const T*>(a.k) + b * a.sk.b + h * a.sk.h + c0 * a.sk.t + dk * kTile;
  const T* vb = static_cast<const T*>(a.v) + b * a.sv.b + h * a.sv.h + c0 * a.sv.t + dv * kTile;

  auto issue = [&](int j) {
    bf16* st = ring + (j & 1) * 2 * IN * kPlane;
    const int rows = min(kTile, Lc - j * kTile);
    load_tile<T, IN>(st, kb + j * kTile * a.sk.t, a.sk.t, rows, wk, a.vk != 0);
    load_tile<T, IN>(st + IN * kPlane, vb + j * kTile * a.sv.t, a.sv.t, rows, wv, a.vv != 0);
  };
  issue(0);
  cp_async_commit();
  if (n_tiles > 1) issue(1);
  cp_async_commit();

  // gates and the inclusive scan of the log decays (warp 0)
  const float* gb = a.log_g + b * a.sg.b + h * a.sg.h + c0 * a.sg.t;
  const float* ib = a.log_i != nullptr ? a.log_i + b * a.si.b + h * a.si.h + c0 * a.si.t : nullptr;
  for (int t = tid; t < n_tiles * kTile; t += kThreads) {
    cum[t] = t < Lc ? gb[t * a.sg.t] : 0.0f;
    w[t] = t < Lc && ib != nullptr ? ib[t * a.si.t] : 0.0f;
  }
  __syncthreads();
  if (warp == 0) {
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
  const int64_t row0 = (static_cast<int64_t>(b) * a.NH + h) * a.T + c0;
  for (int t = tid; t < n_tiles * kTile; t += kThreads) {
    if (t < Lc && tile == 0) {
      a.cum[row0 + t] = cum[t];
      a.li[row0 + t] = w[t];
    }
    w[t] = t < Lc ? __expf(clip(total - cum[t] + w[t])) : 0.0f;
  }

  // warp: state rows d in [16 warp, 16 warp + 16), all 64 columns
  const int g = lane / 4, tq = lane % 4, d0 = 16 * warp;
  float acc[8][4] = {};
  for (int j = 0; j < n_tiles; ++j) {
    cp_async_wait<1>();
    __syncthreads();
    const bf16* st = ring + (j & 1) * 2 * IN * kPlane;
    const uint32_t ks = smem_addr(st), vs = smem_addr(st + IN * kPlane);
    const float* wj = w + j * kTile;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {  // 16 rows s of the tile a step
      // A[d][s] = k_s[d] w_s, rebuilt in f32 from the input parts, split
      float x[8] = {};
#pragma unroll
      for (int i = 0; i < IN; ++i) {
        uint32_t r[4];
        ldsm_t(ks + i * kPlaneBytes + at_off(16 * kk, d0, lane), r);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 f = unpack(r[e]);
          x[2 * e] += f.x;
          x[2 * e + 1] += f.y;
        }
      }
      const int s = 16 * kk + 2 * tq;
      const float w0 = wj[s], w1 = wj[s + 1], w8 = wj[s + 8], w9 = wj[s + 9];
      uint32_t am[4][MID];  // a0..a3 of each part
      split2<MID>(x[0] * w0, x[1] * w1, am[0]);
      split2<MID>(x[2] * w0, x[3] * w1, am[1]);
      split2<MID>(x[4] * w8, x[5] * w9, am[2]);
      split2<MID>(x[6] * w8, x[7] * w9, am[3]);
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t bv[IN][4];
#pragma unroll
        for (int jj = 0; jj < IN; ++jj) ldsm_t(vs + jj * kPlaneBytes + bk_off(16 * kk, 16 * np, lane), bv[jj]);
#pragma unroll
        for (int i = 0; i < MID; ++i) {
          const uint32_t ai[4] = {am[0][i], am[1][i], am[2][i], am[3][i]};
#pragma unroll
          for (int jj = 0; jj < IN; ++jj) {
            if (i + jj >= MID) continue;
            mma(acc[2 * np], ai, bv[jj][0], bv[jj][1]);
            mma(acc[2 * np + 1], ai, bv[jj][2], bv[jj][3]);
          }
        }
      }
    }
    __syncthreads();
    if (j + 2 < n_tiles) issue(j + 2);
    cp_async_commit();
  }

  // the whole tile, padding included (zeros: the padded k and v are)
  float* out = a.local +
               (((static_cast<int64_t>(b) * a.NH + h) * a.nc + c) * a.nk * a.nv + tile) * kTile * kTile;
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    const int col = 8 * n + 2 * tq;
    *reinterpret_cast<float2*>(out + (d0 + g) * kTile + col) = make_float2(acc[n][0], acc[n][1]);
    *reinterpret_cast<float2*>(out + (d0 + g + 8) * kTile + col) = make_float2(acc[n][2], acc[n][3]);
  }
}

// ---------------------------------------------------------------- pass 2

// S_c = exp(clip(total_c)) S_{c-1} + L_c in chunk order, a thread per
// (element of the state padded to 64 x 64 tiles, head, batch); the state
// entering each chunk after the first is written tile by tile as the MID
// bf16 parts pass 3 loads
template <typename T, bool WIDE>
__global__ void __launch_bounds__(256) fold_kernel(const __grid_constant__ Args a) {
  constexpr int MID = Parts<T>::MID;
  constexpr int kEl = kTile * kTile;
  const int nv = WIDE ? a.nv : 1, tiles = WIDE ? a.nk * a.nv : 1;
  const int rem = blockIdx.x * blockDim.x + threadIdx.x;  // element of this (batch, head)
  if (rem >= tiles * kEl) return;
  const int64_t bh = static_cast<int64_t>(blockIdx.z) * a.NH + blockIdx.y;
  const int tile = rem / kEl, e = rem % kEl;
  const int d = tile / nv * kTile + e / kTile, col = tile % nv * kTile + e % kTile;
  const bool valid = d < a.DK && col < a.DV;
  const int64_t n_el = static_cast<int64_t>(a.DK) * a.DV;
  const float* cum = a.cum + bh * a.T;
  const float* L = a.local + (bh * a.nc * tiles + tile) * kEl + e;
  bf16* ent = a.entering + (bh * a.nc * tiles + tile) * MID * kEl + e;
  float S = 0.0f;
  for (int c = 0; c < a.nc; ++c) {
    if (c > 0) {
      bf16 p[MID];
      split<MID>(S, p);
#pragma unroll
      for (int i = 0; i < MID; ++i) ent[(static_cast<int64_t>(c) * tiles * MID + i) * kEl] = p[i];
    }
    const int last = min(c * a.chunk + a.chunk, a.T) - 1;
    const float l = L[static_cast<int64_t>(c) * tiles * kEl];
    S = expf(clip(cum[last])) * S + l;
  }
  if (valid) a.state[bh * n_el + static_cast<int64_t>(d) * a.DV + col] = S;
}

// ---------------------------------------------------------------- pass 3

__device__ __forceinline__ void store2(float* p, float x, float y, bool pair) {
  p[0] = x;
  if (pair) p[1] = y;
}
__device__ __forceinline__ void store2(bf16* p, float x, float y, bool pair) {
  if (pair && (reinterpret_cast<uintptr_t>(p) & 3) == 0) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
    return;
  }
  p[0] = __float2bfloat16_rn(x);
  if (pair) p[1] = __float2bfloat16_rn(y);
}

// y for 64 rows of one chunk of one (batch, head).  Shared memory: q
// planes, a two-stage ring of (k, v, cum_s, li_s) for the key blocks, cum_t
// of the rows; the entering state's planes ([d][v]) sit in the ring's second
// stage until the inter-chunk term is done.  bf16: 47 KB and at most 128
// registers, four blocks an SM
template <typename T>
__global__ void __launch_bounds__(kThreads, sizeof(T) == 2 ? 4 : 1)
output_kernel(const __grid_constant__ Args a) {
  constexpr int IN = Parts<T>::IN, MID = Parts<T>::MID;
  constexpr int kStageBytes = 2 * IN * kPlaneBytes + 2 * kTile * 4;
  static_assert(MID <= 2 * IN, "the entering state fits in a ring stage");
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);
  unsigned char* ring = smem + IN * kPlaneBytes;
  bf16* Ss = reinterpret_cast<bf16*>(ring + kStageBytes);
  float* cum_t = reinterpret_cast<float*>(ring + 2 * kStageBytes);

  const int h = blockIdx.x, b = blockIdx.y;
  const int n_tb = (a.chunk + kTile - 1) / kTile;
  const int tbi = n_tb - 1 - static_cast<int>(blockIdx.z) / a.nc;  // last row blocks first
  const int c = static_cast<int>(blockIdx.z) % a.nc;
  const int c0 = c * a.chunk, Lc = min(a.chunk, a.T - c0), tb = tbi * kTile;
  if (tb >= Lc) return;
  const int nt = min(kTile, Lc - tb);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, tq = lane % 4, m0 = 16 * warp;

  const T* qb = static_cast<const T*>(a.q) + b * a.sq.b + h * a.sq.h + c0 * a.sq.t;
  const T* kb = static_cast<const T*>(a.k) + b * a.sk.b + h * a.sk.h + c0 * a.sk.t;
  const T* vb = static_cast<const T*>(a.v) + b * a.sv.b + h * a.sv.h + c0 * a.sv.t;
  const int64_t bh = static_cast<int64_t>(b) * a.NH + h;
  const float* cb = a.cum + bh * a.T + c0;
  const float* lb = a.li + bh * a.T + c0;

  // 64 floats of a gate row (rows past `rows` zero-filled)
  auto gates = [&](float* dst, const float* src, int rows) {
    for (int s = tid; s < kTile; s += kThreads)
      cp_async4(smem_addr(dst + s), s < rows ? src + s : src, s < rows ? 4 : 0);
  };
  auto issue = [&](int j) {  // key block j: rows [64 j, 64 j + 64) of the chunk
    unsigned char* st = ring + (j & 1) * kStageBytes;
    bf16* kt = reinterpret_cast<bf16*>(st);
    float* cs = reinterpret_cast<float*>(st + 2 * IN * kPlaneBytes);
    const int rows = min(kTile, Lc - j * kTile);
    load_tile<T, IN>(kt, kb + j * kTile * a.sk.t, a.sk.t, rows, a.DK, a.vk != 0);
    load_tile<T, IN>(kt + IN * kPlane, vb + j * kTile * a.sv.t, a.sv.t, rows, a.DV, a.vv != 0);
    gates(cs, cb + j * kTile, rows);
    gates(cs + kTile, lb + j * kTile, rows);
  };
  // group 0: q, the entering state, cum_t and key block 0; then key block 1
  // once the entering state is used
  load_tile<T, IN>(qs, qb + tb * a.sq.t, a.sq.t, nt, a.DK, a.vq != 0);
  if (c > 0) {
    const bf16* sp = a.entering + (bh * a.nc + c) * MID * kTile * kTile;
    for (int idx = tid; idx < MID * kTile * 8; idx += kThreads) {
      const int r = idx >> 3, col = (idx & 7) * 8;  // row r of the MID stacked planes
      const int plane = r / kTile, d = r % kTile;
      cp_async16(smem_addr(Ss + plane * kPlane + d * kPitch + col), sp + r * kTile + col, 16);
    }
  }
  gates(cum_t, cb + tb, nt);
  issue(0);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  const uint32_t q_addr = smem_addr(qs), S_addr = smem_addr(Ss);
  uint32_t qa[4][IN][4];  // q's A fragments, 16 features a step
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int i = 0; i < IN; ++i) ldsm(q_addr + i * kPlaneBytes + a_off(m0, 16 * kk, lane), qa[kk][i]);
  const float ct0 = cum_t[m0 + g] * kLog2e, ct1 = cum_t[m0 + g + 8] * kLog2e;  // base 2

  float acc[8][4] = {};
  if (c > 0) {  // exp(clip(cum_t)) q_t . S
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t bs[MID][4];
#pragma unroll
        for (int jj = 0; jj < MID; ++jj)
          ldsm_t(S_addr + jj * kPlaneBytes + bk_off(16 * kk, 16 * np, lane), bs[jj]);
#pragma unroll
        for (int i = 0; i < IN; ++i)
#pragma unroll
          for (int jj = 0; jj < MID; ++jj) {
            if (i + jj >= MID) continue;
            mma(acc[2 * np], qa[kk][i], bs[jj][0], bs[jj][1]);
            mma(acc[2 * np + 1], qa[kk][i], bs[jj][2], bs[jj][3]);
          }
      }
    }
    const float e0 = ex2(clip2(ct0)), e1 = ex2(clip2(ct1));
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      acc[n][0] *= e0;
      acc[n][1] *= e0;
      acc[n][2] *= e1;
      acc[n][3] *= e1;
    }
    __syncthreads();  // every warp is done with the state: stage 1 is free
  }
  if (tbi > 0) issue(1);
  cp_async_commit();

  const int t0 = tb + m0 + g;  // this thread's rows in the chunk: t0, t0 + 8
  for (int j = 0; j <= tbi; ++j) {
    cp_async_wait<1>();
    __syncthreads();
    const unsigned char* st = ring + (j & 1) * kStageBytes;
    const uint32_t ks = smem_addr(st), vs = ks + IN * kPlaneBytes;
    const float* cs = reinterpret_cast<const float*>(st + 2 * IN * kPlaneBytes);
    const float* ls = cs + kTile;

    float s[8][4] = {};  // q.k^T: 16 rows x 64 keys
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t bk[IN][4];
#pragma unroll
        for (int jj = 0; jj < IN; ++jj) ldsm(ks + jj * kPlaneBytes + bn_off(16 * np, 16 * kk, lane), bk[jj]);
#pragma unroll
        for (int i = 0; i < IN; ++i)
#pragma unroll
          for (int jj = 0; jj < IN; ++jj) {
            if (i + jj >= MID) continue;
            mma(s[2 * np], qa[kk][i], bk[jj][0], bk[jj][1]);
            mma(s[2 * np + 1], qa[kk][i], bk[jj][2], bk[jj][3]);
          }
      }
    }
    // decay and causal mask: P[t][s] = (q_t.k_s) exp(clip(cum_t - cum_s + li_s)),
    // s <= t, in base 2: one add, the clip and one ex2 an element, the keys'
    // li_s - cum_s taken once for this thread's 16 keys.  Every key of a
    // block below the diagonal one is below every row: no mask there
    const int sb = j * kTile;
    float u[8][2];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int sc = 8 * n + 2 * tq + e;
        u[n][e] = (ls[sc] - cs[sc]) * kLog2e;
      }
    if (j < tbi) {
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] *= ex2(clip2((e < 2 ? ct0 : ct1) + u[n][e & 1]));
    } else {
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int sk = sb + 8 * n + 2 * tq + (e & 1), t = t0 + 8 * (e >> 1);
          const float d = ex2(clip2((e < 2 ? ct0 : ct1) + u[n][e & 1]));
          s[n][e] = sk <= t && sk < Lc ? s[n][e] * d : 0.0f;
        }
    }
    // y += P.V, P from the accumulators as the A operand, in MID parts
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t pa[4][MID];
      split2<MID>(s[2 * kk][0], s[2 * kk][1], pa[0]);
      split2<MID>(s[2 * kk][2], s[2 * kk][3], pa[1]);
      split2<MID>(s[2 * kk + 1][0], s[2 * kk + 1][1], pa[2]);
      split2<MID>(s[2 * kk + 1][2], s[2 * kk + 1][3], pa[3]);
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t bv[IN][4];
#pragma unroll
        for (int jj = 0; jj < IN; ++jj) ldsm_t(vs + jj * kPlaneBytes + bk_off(16 * kk, 16 * np, lane), bv[jj]);
#pragma unroll
        for (int i = 0; i < MID; ++i) {
          const uint32_t ai[4] = {pa[0][i], pa[1][i], pa[2][i], pa[3][i]};
#pragma unroll
          for (int jj = 0; jj < IN; ++jj) {
            if (i + jj >= MID) continue;
            mma(acc[2 * np], ai, bv[jj][0], bv[jj][1]);
            mma(acc[2 * np + 1], ai, bv[jj][2], bv[jj][3]);
          }
        }
      }
    }
    __syncthreads();
    if (j + 2 <= tbi) issue(j + 2);
    cp_async_commit();
  }

  T* yb = static_cast<T*>(a.y) + b * a.sy.b + h * a.sy.h + c0 * a.sy.t;
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    const int col = 8 * n + 2 * tq;
    if (col >= a.DV) continue;
    const bool pair = col + 1 < a.DV;
    if (t0 < Lc) store2(yb + static_cast<int64_t>(t0) * a.sy.t + col, acc[n][0], acc[n][1], pair);
    if (t0 + 8 < Lc)
      store2(yb + static_cast<int64_t>(t0 + 8) * a.sy.t + col, acc[n][2], acc[n][3], pair);
  }
}

// ------------------------------------------------- pass 3, wide states

// DK or DV past 64 (the mLSTM: 1024 and 1025).  q.k^T then sums over DK
// tiles and y covers DV tiles; rather than have each DV tile's block sum
// q.k^T again (17 times at DV = 1025), `scores_kernel` writes the decayed,
// masked scores of each (row block, key block) pair once, in f32, and
// `output_wide_kernel` reads them as the A operand of P.V.

// the pair index of a chunk's (row block tbi, key block j <= tbi)
__host__ __device__ __forceinline__ int tri(int tbi) { return tbi * (tbi + 1) / 2; }

// P[t][s] = (q_t.k_s) exp(clip(cum_t - cum_s + li_s)) for s <= t, both in the
// chunk, else 0: a block per (chunk, pair, head, batch), the q and k tiles
// of each DK tile through a two-stage ring (q planes, then k planes)
template <typename T>
__global__ void __launch_bounds__(kThreads) scores_kernel(const __grid_constant__ Args a) {
  constexpr int IN = Parts<T>::IN, MID = Parts<T>::MID;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* ring = reinterpret_cast<bf16*>(smem);
  const int n_tb = (a.chunk + kTile - 1) / kTile;
  const int c = blockIdx.x % a.nc, pair = blockIdx.x / a.nc, h = blockIdx.y, b = blockIdx.z;
  int tbi = 0;
  while (tri(tbi + 1) <= pair) ++tbi;
  const int j = pair - tri(tbi);
  const int c0 = c * a.chunk, Lc = min(a.chunk, a.T - c0), tb = tbi * kTile;
  if (tb >= Lc) return;
  const int nt = min(kTile, Lc - tb), ns = min(kTile, Lc - j * kTile);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, tq = lane % 4, m0 = 16 * warp;
  const T* qb = static_cast<const T*>(a.q) + b * a.sq.b + h * a.sq.h + (c0 + tb) * a.sq.t;
  const T* kb = static_cast<const T*>(a.k) + b * a.sk.b + h * a.sk.h +
                static_cast<int64_t>(c0 + j * kTile) * a.sk.t;

  auto issue = [&](int dk) {
    bf16* st = ring + (dk & 1) * 2 * IN * kPlane;
    const int w = min(kTile, a.DK - dk * kTile);
    load_tile<T, IN>(st, qb + dk * kTile, a.sq.t, nt, w, a.vq != 0);
    load_tile<T, IN>(st + IN * kPlane, kb + dk * kTile, a.sk.t, ns, w, a.vk != 0);
  };
  issue(0);
  cp_async_commit();
  if (a.nk > 1) issue(1);
  cp_async_commit();

  float s[8][4] = {};
  for (int dk = 0; dk < a.nk; ++dk) {
    cp_async_wait<1>();
    __syncthreads();
    const uint32_t qs = smem_addr(ring + (dk & 1) * 2 * IN * kPlane), ks = qs + IN * kPlaneBytes;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t qa[IN][4];
#pragma unroll
      for (int i = 0; i < IN; ++i) ldsm(qs + i * kPlaneBytes + a_off(m0, 16 * kk, lane), qa[i]);
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t bk[IN][4];
#pragma unroll
        for (int jj = 0; jj < IN; ++jj) ldsm(ks + jj * kPlaneBytes + bn_off(16 * np, 16 * kk, lane), bk[jj]);
#pragma unroll
        for (int i = 0; i < IN; ++i)
#pragma unroll
          for (int jj = 0; jj < IN; ++jj) {
            if (i + jj >= MID) continue;
            mma(s[2 * np], qa[i], bk[jj][0], bk[jj][1]);
            mma(s[2 * np + 1], qa[i], bk[jj][2], bk[jj][3]);
          }
      }
    }
    __syncthreads();
    if (dk + 2 < a.nk) issue(dk + 2);
    cp_async_commit();
  }

  // the decay in base 2, as the narrow output kernel takes it
  const int64_t bh = static_cast<int64_t>(b) * a.NH + h;
  const float* cb = a.cum + bh * a.T + c0;
  const float* lb = a.li + bh * a.T + c0;
  const int t0 = tb + m0 + g;  // this thread's rows in the chunk: t0, t0 + 8
  const float ct0 = (t0 < Lc ? cb[t0] : 0.0f) * kLog2e;
  const float ct1 = (t0 + 8 < Lc ? cb[t0 + 8] : 0.0f) * kLog2e;
  float* out = a.scores + ((bh * a.nc + c) * tri(n_tb) + pair) * kTile * kTile;
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    float p[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int sk = j * kTile + 8 * n + 2 * tq + (e & 1), t = t0 + 8 * (e >> 1);
      const float u = sk < Lc ? (lb[sk] - cb[sk]) * kLog2e : 0.0f;
      const float d = ex2(clip2((e < 2 ? ct0 : ct1) + u));
      p[e] = sk <= t && sk < Lc && t < Lc ? s[n][e] * d : 0.0f;
    }
    const int col = 8 * n + 2 * tq;
    *reinterpret_cast<float2*>(out + (m0 + g) * kTile + col) = make_float2(p[0], p[1]);
    *reinterpret_cast<float2*>(out + (m0 + g + 8) * kTile + col) = make_float2(p[2], p[3]);
  }
}

// y for 64 rows of one chunk and one 64-wide DV tile: first exp(clip(cum_t))
// q_t . S over the DK tiles (skipped for the first chunk), then P.V over
// the key blocks, every step one (A, B) tile pair through a two-stage ring:
// (q, the entering state's tile) or (the decayed scores, v)
template <typename T>
__global__ void __launch_bounds__(kThreads) output_wide_kernel(const __grid_constant__ Args a) {
  constexpr int IN = Parts<T>::IN, MID = Parts<T>::MID, PL = IN > MID ? IN : MID;
  constexpr int kStage = 2 * PL * kPlane;  // A planes, then B planes
  constexpr int kEl = kTile * kTile;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* ring = reinterpret_cast<bf16*>(smem);
  const int n_tb = (a.chunk + kTile - 1) / kTile;
  const int dv = blockIdx.x % a.nv, rest = blockIdx.x / a.nv;
  const int tbi = n_tb - 1 - rest / a.nc, c = rest % a.nc;  // last row blocks first
  const int h = blockIdx.y, b = blockIdx.z;
  const int c0 = c * a.chunk, Lc = min(a.chunk, a.T - c0), tb = tbi * kTile;
  if (tb >= Lc) return;
  const int nt = min(kTile, Lc - tb), wv = min(kTile, a.DV - dv * kTile);
  const int n_s = c > 0 ? a.nk : 0, n_steps = n_s + tbi + 1;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, tq = lane % 4, m0 = 16 * warp;
  const int64_t bh = static_cast<int64_t>(b) * a.NH + h;
  const T* qb = static_cast<const T*>(a.q) + b * a.sq.b + h * a.sq.h + (c0 + tb) * a.sq.t;
  const T* vb = static_cast<const T*>(a.v) + b * a.sv.b + h * a.sv.h + c0 * a.sv.t + dv * kTile;
  const bf16* ent = a.entering + (bh * a.nc + c) * a.nk * a.nv * MID * kEl;
  const float* sc = a.scores + ((bh * a.nc + c) * tri(n_tb) + tri(tbi)) * kEl;

  auto issue = [&](int n) {
    bf16* A = ring + (n & 1) * kStage;
    bf16* B = A + PL * kPlane;
    if (n < n_s) {  // q's DK tile n and the entering state's tile (n, dv)
      load_tile<T, IN>(A, qb + n * kTile, a.sq.t, nt, min(kTile, a.DK - n * kTile), a.vq != 0);
      const bf16* sp = ent + (n * a.nv + dv) * MID * kEl;
      for (int idx = tid; idx < MID * kTile * 8; idx += kThreads) {
        const int r = idx >> 3, col = (idx & 7) * 8;  // row r of the MID stacked planes
        cp_async16(smem_addr(B + r / kTile * kPlane + r % kTile * kPitch + col),
                   sp + r * kTile + col, 16);
      }
    } else {  // the scores of key block j and v's rows of it
      const int j = n - n_s;
      load_tile<float, MID>(A, sc + j * kEl, kTile, kTile, kTile, false);
      load_tile<T, IN>(B, vb + static_cast<int64_t>(j) * kTile * a.sv.t, a.sv.t,
                       min(kTile, Lc - j * kTile), wv, a.vv != 0);
    }
  };
  issue(0);
  cp_async_commit();
  if (n_steps > 1) issue(1);
  cp_async_commit();

  float acc[8][4] = {};
  for (int n = 0; n < n_steps; ++n) {
    cp_async_wait<1>();
    __syncthreads();
    if (n == n_s && n_s > 0) {  // the inter-chunk term is complete: decay it
      const float* cb = a.cum + bh * a.T + c0 + tb;
      const float e0 = m0 + g < nt ? ex2(clip2(cb[m0 + g] * kLog2e)) : 0.0f;
      const float e1 = m0 + g + 8 < nt ? ex2(clip2(cb[m0 + g + 8] * kLog2e)) : 0.0f;
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        acc[k][0] *= e0;
        acc[k][1] *= e0;
        acc[k][2] *= e1;
        acc[k][3] *= e1;
      }
    }
    const uint32_t As = smem_addr(ring + (n & 1) * kStage), Bs = As + PL * kPlaneBytes;
    if (n < n_s) {  // acc += q . S: q in IN parts, S in MID parts
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        uint32_t qa[IN][4];
#pragma unroll
        for (int i = 0; i < IN; ++i) ldsm(As + i * kPlaneBytes + a_off(m0, 16 * kk, lane), qa[i]);
#pragma unroll
        for (int np = 0; np < 4; ++np) {
          uint32_t bs[MID][4];
#pragma unroll
          for (int jj = 0; jj < MID; ++jj)
            ldsm_t(Bs + jj * kPlaneBytes + bk_off(16 * kk, 16 * np, lane), bs[jj]);
#pragma unroll
          for (int i = 0; i < IN; ++i)
#pragma unroll
            for (int jj = 0; jj < MID; ++jj) {
              if (i + jj >= MID) continue;
              mma(acc[2 * np], qa[i], bs[jj][0], bs[jj][1]);
              mma(acc[2 * np + 1], qa[i], bs[jj][2], bs[jj][3]);
            }
        }
      }
    } else {  // acc += P . V: P in MID parts, v in IN parts
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        uint32_t pa[MID][4];
#pragma unroll
        for (int i = 0; i < MID; ++i) ldsm(As + i * kPlaneBytes + a_off(m0, 16 * kk, lane), pa[i]);
#pragma unroll
        for (int np = 0; np < 4; ++np) {
          uint32_t bv[IN][4];
#pragma unroll
          for (int jj = 0; jj < IN; ++jj)
            ldsm_t(Bs + jj * kPlaneBytes + bk_off(16 * kk, 16 * np, lane), bv[jj]);
#pragma unroll
          for (int i = 0; i < MID; ++i)
#pragma unroll
            for (int jj = 0; jj < IN; ++jj) {
              if (i + jj >= MID) continue;
              mma(acc[2 * np], pa[i], bv[jj][0], bv[jj][1]);
              mma(acc[2 * np + 1], pa[i], bv[jj][2], bv[jj][3]);
            }
        }
      }
    }
    __syncthreads();
    if (n + 2 < n_steps) issue(n + 2);
    cp_async_commit();
  }

  T* yb = static_cast<T*>(a.y) + b * a.sy.b + h * a.sy.h + c0 * a.sy.t + dv * kTile;
  const int t0 = tb + m0 + g;
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    const int col = 8 * n + 2 * tq;
    if (col >= wv) continue;
    const bool pair = col + 1 < wv;
    if (t0 < Lc) store2(yb + static_cast<int64_t>(t0) * a.sy.t + col, acc[n][0], acc[n][1], pair);
    if (t0 + 8 < Lc)
      store2(yb + static_cast<int64_t>(t0 + 8) * a.sy.t + col, acc[n][2], acc[n][3], pair);
  }
}

// ------------------------------------------------------------------ host

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

template <typename T>
int launch(const Args& a, cudaStream_t st) {
  constexpr int IN = Parts<T>::IN, MID = Parts<T>::MID, PL = IN > MID ? IN : MID;
  static bool attr_local[kMaxDevices] = {}, attr_out[kMaxDevices] = {},
              attr_scores[kMaxDevices] = {}, attr_wide[kMaxDevices] = {};
  constexpr int kMaxChunk = 4096;
  const int local_most = 2 * 2 * IN * kPlaneBytes + 2 * kMaxChunk * 4;
  constexpr int out_smem = IN * kPlaneBytes + 2 * (2 * IN * kPlaneBytes + 2 * kTile * 4)
                           + kTile * 4;
  constexpr int scores_smem = 2 * 2 * IN * kPlaneBytes;
  constexpr int wide_smem = 2 * 2 * PL * kPlaneBytes;
  const bool wide = a.nk > 1 || a.nv > 1;
  cudaError_t err = allow_smem(local_kernel<T>, local_most, attr_local);
  if (err == cudaSuccess && !wide) err = allow_smem(output_kernel<T>, out_smem, attr_out);
  if (err == cudaSuccess && wide) err = allow_smem(scores_kernel<T>, scores_smem, attr_scores);
  if (err == cudaSuccess && wide) err = allow_smem(output_wide_kernel<T>, wide_smem, attr_wide);
  if (err != cudaSuccess) return static_cast<int>(err);

  const int padded = (a.chunk + kTile - 1) / kTile * kTile;
  const int local_smem = 2 * 2 * IN * kPlaneBytes + 2 * padded * 4;
  local_kernel<T><<<dim3(a.nc * a.nk * a.nv, a.NH, a.B), kThreads, local_smem, st>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_el = a.nk * a.nv * kTile * kTile;  // a (batch, head)'s, in 64 x 64 tiles
  if (wide)
    fold_kernel<T, true><<<dim3((n_el + 255) / 256, a.NH, a.B), 256, 0, st>>>(a);
  else
    fold_kernel<T, false><<<dim3((n_el + 255) / 256, a.NH, a.B), 256, 0, st>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_tb = (a.chunk + kTile - 1) / kTile;
  if (!wide) {
    output_kernel<T><<<dim3(a.NH, a.B, a.nc * n_tb), kThreads, out_smem, st>>>(a);
    return static_cast<int>(cudaGetLastError());
  }
  scores_kernel<T><<<dim3(a.nc * tri(n_tb), a.NH, a.B), kThreads, scores_smem, st>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  output_wide_kernel<T><<<dim3(a.nc * n_tb * a.nv, a.NH, a.B), kThreads, wide_smem, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int ssd_forward(const void* q, const void* k, const void* v, const void* log_g,
                           const void* log_i, void* y, void* state, void* cum, void* li,
                           void* local, void* entering, void* scores,
                           int64_t sqb, int64_t sqt, int64_t sqh,
                           int64_t skb, int64_t skt, int64_t skh,
                           int64_t svb, int64_t svt, int64_t svh,
                           int64_t sgb, int64_t sgt, int64_t sgh,
                           int64_t sib, int64_t sit, int64_t sih,
                           int64_t syb, int64_t syt, int64_t syh,
                           int B, int T_len, int NH, int DK, int DV, int chunk, int dtype,
                           int vq, int vk, int vv, void* stream) {
  if (DK < 1 || DV < 1 || chunk < 1 || chunk > 4096 || T_len < 1 || B < 1 || NH < 1 ||
      B > 65535 || NH > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.log_g = static_cast<const float*>(log_g);
  a.log_i = static_cast<const float*>(log_i);
  a.y = y;
  a.state = static_cast<float*>(state);
  a.cum = static_cast<float*>(cum);
  a.li = static_cast<float*>(li);
  a.local = static_cast<float*>(local);
  a.entering = static_cast<bf16*>(entering);
  a.scores = static_cast<float*>(scores);
  a.sq = Strides{sqb, sqt, sqh};
  a.sk = Strides{skb, skt, skh};
  a.sv = Strides{svb, svt, svh};
  a.sg = Strides{sgb, sgt, sgh};
  a.si = Strides{sib, sit, sih};
  a.sy = Strides{syb, syt, syh};
  a.B = B;
  a.T = T_len;
  a.NH = NH;
  a.DK = DK;
  a.DV = DV;
  a.chunk = chunk;
  a.nc = (T_len + chunk - 1) / chunk;
  a.nk = (DK + kTile - 1) / kTile;
  a.nv = (DV + kTile - 1) / kTile;
  a.vq = vq;
  a.vk = vk;
  a.vv = vv;
  if ((a.nk > 1 || a.nv > 1) && scores == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kBF16) return launch<bf16>(a, st);
  if (dtype == kF32) {
    a.vq = a.vk = a.vv = 0;
    return launch<float>(a, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
