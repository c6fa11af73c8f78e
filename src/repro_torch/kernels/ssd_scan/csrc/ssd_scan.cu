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
// holds the whole state in VMEM across its sequential chunk axis), three
// launches, the state pass's and the outputs' products `wgmma` (m64, bf16
// parts as above) on 128B-swizzled tiles that a cp.async ring brings in:
//  1. `state_kernel<T, false>`, a block of one warpgroup per (state tile,
//     head, batch) walking the chunks in order, the tile's running state in
//     registers: per chunk the gates (a warp's scan; the first tile's block
//     writes cum and li), L_c = sum_s (w_s k_s) v_s^T tile by tile (A, the
//     weighted k^T, from registers in MID parts), then S = exp(clip(total))
//     S + L_c, written as the state entering the next chunk in MID parts
//     (one bulk copy a tile; f32 from registers) or as the final state.  The
//     local states never leave the chip.
//  2. `scores_kernel`, a block per (chunk, row block, key block <= it):
//     q.k^T (`mma.sync`) summed once over the DK tiles (summing it again in
//     each DV tile's block would repeat it 17 times at DV = 1025), decayed,
//     masked and divided by exp(clip(cum_t)), written as three bf16 parts
//     (16 MB at the mLSTM's train micro-batch, read back from L2; with two,
//     as in the first design, more of y's elements round otherwise than its
//     f32 value does, below: `chip_smoke.py` logs that share);
//  3. `output_wide_kernel`, two warpgroups per (chunk, 128 rows, two DV
//     tiles; one in f32): q.S over the DK tiles (each entering-state tile
//     read once for 128 rows, each q tile once for 128 columns), then P'.V
//     over the key blocks, in one accumulator; y_t = exp(clip(cum_t)) times
//     it.
// q, k and v keep 16-byte copies wherever their rows allow; the wrapper
// hands a v whose rows do not (hd + 1 wide, 2-byte aligned) to the kernel
// as a copy with rows zero-padded to a multiple of 8 (only the pad columns
// zeroed first).  The forward's state pass gets at most 128 registers a
// thread in bf16 so that four blocks share an SM (the backward's, which
// holds more, three; f32's two).  Three blocks an SM ran slower on the
// card, as did a deeper ring, 128 x 128 tiles a block on two warpgroups
// (half the tile traffic through L2) and the grid ordered by head.
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
// Wide path, measured (chip_smoke.py --parent, in turns with the first
// design's four launches; NVIDIA H100 80GB HBM3, 700.00 W), bf16: at
// xlstm-1.3b's mLSTM train micro-batch (4, 1024, 4, 1024, 1025), chunk 256,
// 879.288 us against 1337.069 (0.658x; the bound 134.803 us): state 475.484,
// scores 63.224, output 290.443 and v's copy 44.705 us, where the first
// design took local 442.063, fold 250.569, scores 48.696, output 544.636;
// at its prefill (4, 512, ...) 451.970 against 677.958 us (0.667x).  y
// rounds otherwise than its f32 value in 0.1176% of its elements (the first
// design's 0.1975%).  f32 at the prefill: 2578.550 against 3117.245 us
// (0.827x; the state pass 1592.147, element loads of f32 tiles).
//
// The backward (bf16 inputs; no Pallas counterpart: the reference takes
// jax.grad of src/repro/models/ssm.py:29 `chunked_linear_attention`).  Per
// chunk, with D_ts, w_s and the clips as above, S_c the state entering
// chunk c and G_c the cotangent of the state leaving it (G_last = dstate,
// G_{c-1} = exp(clip(total_c)) G_c + U_c, U_c = sum_t exp(clip(cum_t)) q_t
// dy_t^T), P_ts = D_ts (q_t.k_s) and dS_ts = D_ts (dy_t.v_s):
//   dq_t = sum_s dS_ts k_s + exp(clip(cum_t)) S_c dy_t
//   dk_s = sum_t dS_ts q_t + w_s G_c v_s
//   dv_s = sum_t P_ts dy_t + w_s G_c^T k_s
// and the gates from g_ts = P_ts (dy_t.v_s) (to dcum_t, -dcum_s, dli_s),
// exp(cum_t) q_t.S_c dy_t (dcum_t), h_s = w_s k_s.G_c v_s (dtotal, -dcum_s,
// dli_s) and exp(total) <S_c, G_c> (dtotal), each where its clip passes;
// dlog_g_u = sum_{t>=u} dcum_t + dtotal.  Two routes, every sum in a fixed
// order (no atomics: bit-equal run to run, and capturable); products take
// parts as the forward's do (P, dS, S_c and G_c two bf16 parts).
//
// The heads route, `ssd_backward_heads` (DK and DV at most 64, chunks of at
// most 256 steps: Mamba2's), three launches on the forward's cum, li and
// entering states, which `_ScanFn` keeps (a direct call of the wrapper
// without them runs the forward kernel first):
//  1. `ufold_kernel`, a block per (head, batch) walking the chunks last
//     first: U_c formed on the way from TMA-fed tiles, G_c written as two
//     bf16 parts;
//  2. `heads_kernel`, two warpgroups per (key block, head group, chunk,
//     batch) walking the group's heads (each head's tiles by TMA, the next
//     head's in flight), every product a `wgmma`: per head and (row block,
//     key block) pair S^T, dP^T, P^T, dS^T and the gate sums are formed
//     once, dv += P^T dy, and dS^T is summed over the group's heads in
//     registers; after the heads, each pair's summed dS times k_j and q_i
//     gives the group's f32 shares of dq and dk.  Where q and k are one head
//     broadcast over the heads (Mamba2), the dq and dk products run once a
//     group, not once a head, and come out summed over the heads;
//  3. `finish_kernel`: the groups' shares summed in group order into dq and
//     dk at (B, T, q/k heads, DK); dlog_g and dlog_i.
// The pairs route, `ssd_backward` (any state width and chunk: the mLSTM's
// 1024 x 1025 states), six launches on the forward's cum, li and entering
// states, which `_ScanFn` keeps on this route too (285 MB a call at the
// mLSTM's train micro-batch; a direct call without them runs the forward
// kernel first):
//  1. `state_kernel<T, true>`: the forward's state pass run backward over
//     the chunks, q for k, dy for v: each tile's G_c written as MID parts
//     and U_c formed and folded in on chip, with each tile's decay term
//     exp(total) <S_c, G_c>;
//  2. `bscores_kernel`, a block per (chunk, row block, key block <= it):
//     q.k^T over the DK tiles and dy.v^T over the DV tiles (`mma.sync`), P
//     and dS written as MID bf16 parts through shared memory (the mLSTM's
//     sums span 16 and 17 tiles, so no block of one output tile can form
//     them alone), with each pair's sums of g by row and by column;
//  3-5. `grad_kernel` for dq (128 rows a block: the key blocks <= each), dk
//     and dv (128 keys a block: the row blocks >= each; dS^T and P^T read
//     MN-major by `wgmma`), each per 64-wide output tile, the state term
//     over the other width's tiles and the pairs in accumulators of their
//     own, on the output kernel's two-warpgroup ring;
//  6. `gates_kernel`, a warp per chunk: the partial sums in order and the
//     suffix sums of dcum.
// Measured (chip_smoke.py --parent; NVIDIA H100 80GB HBM3, 700.00 W) at the
// mLSTM's train micro-batch (4, 1024, 4, 1024, 1025) as a train step runs
// it, on the kept scratch: 1665.461 us against the nine-launch design's
// 3232.739 (0.515x; the bound 365.261 us): state 498.655, bscores 124.346,
// dq 239.636, dk 282.062, dv 401.058, gates 25.999 and dy's copy 90.290 us.
// dq and dk are per head there (the wrapper sums a one-head q's or k's).
//
// Bound on the card: operations (chip_smoke.py `ssd_backward_bound`, the
// products with an f32 operand at half the bf16 rate): 64.001 us at
// zamba2-2.7b's train micro-batch (4, 1024, 80, 64), chunk 256, q/k one
// head; 365.261 us at the mLSTM's (4, 1024, 4, 1024, 1025).
// Measured (chip_smoke.py --parent; NVIDIA H100 80GB HBM3, 700.00 W): the
// heads route 357.720 us at zamba2-2.7b's train shape against 645.475 us
// for the seven-launch design it replaces in the same run (0.554x; 0.518x
// of that with the sums over heads its step's expand backward ran), 5.59x
// the bound: ufold 39.5, heads 292.2, finish 20.1 us; a ragged (2, 1000,
// 80, 64) 220.464 against 354.154.  What holds the heads kernel back: at 255 registers a
// thread an SM runs its 8 warps, and each step waits on its own chain
// (the scores' wgmma, the element work, the dv wgmma); keeping more live
// (the next pair's first scores issued early, the state sums moved to
// shared memory to make room) spilled or lost time.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "wgmma.cuh"

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
  bf16* scores;     // wide path: (B, NH, nc, n_tri, MID, 64, 64), the decayed scores of
                    // each (row block, key block <= it) pair of a chunk in MID parts
  Strides sq, sk, sv, sg, si, sy;
  int B, T, NH, DK, DV, chunk, nc;
  int nk, nv;  // 64-wide tiles of DK and DV
  // per tensor: bf16 rows by 16-byte cp.async (aligned base and strides,
  // width % 8 == 0)
  int vq, vk, vv;
  // the backward (ssd_backward) only:
  const void* dy;        // (B, T, NH, DV): the cotangent of y, through sdy
  Strides sdy;
  int vdy;
  const float* dstate;   // (B, NH, DK, DV): the cotangent of the final state, or null (zero)
  bf16* gstate;          // like `entering`: G_c, the cotangent of the state leaving chunk c
  bf16* pmat;            // like `scores`: P_ts = (q_t.k_s) D_ts of each (row block, key block)
                         // pair, in MID parts
  bf16* dsmat;           // the same pairs of dS_ts = (dy_t.v_s) D_ts
  float* rpart;          // (B, NH, nc, n_tri, 64): each pair's sums of g_ts over s, by row t
                         // (heads route: (B, NH, nc, n_tri, 4 warps, 64), each warp's keys)
  float* cpart;          // the same over t, by column s (heads route: (B, NH, T), complete)
  float* ipart;          // (B, NH, nk, T): q_t . (S_c dy_t) over each DK tile
  float* hpart;          // (B, NH, nk, T): k_s . (G_c v_s) over each DK tile
  float* dpart;          // (B, NH, nc, nk x nv): exp(total) <S_c, G_c> over each state tile
                         // (heads route: (B, NH, nc), exp(total) <S_c, G_c> complete)
  void *dq, *dk, *dv;    // (B, T, NH, DK or DV) contiguous, in the input dtype (dq and dk
                         // (B, T, nq, DK) on the heads route)
  float *dlog_g, *dli;   // (B, T, NH) contiguous; dli null without log_i
  // the heads route (narrow states, chunks of at most 256 steps) only:
  float* dqp;            // (B, nc, ng, n_tri, 64, 64): each head group's share of dq, by pair
  float* dkp;            // (B, nc, ng, n_tb, 64, 64): each head group's share of dk, by key block
  int hg, ng, nq;        // heads a group, head groups, q/k heads (1: broadcast over the heads)
};

// parts of an input (IN) and of an f32 operand (MID); a product takes the
// part pairs (i, j) with i + j < MID.  SCORE: the wide path's decayed scores,
// three parts in either dtype (their products are few, and with two, y is
// rounded as the f32 result would be in fewer places)
template <typename T>
struct Parts;
template <>
struct Parts<bf16> {
  static constexpr int IN = 1, MID = 2, SCORE = 3;
};
template <>
struct Parts<float> {
  static constexpr int IN = 3, MID = 3, SCORE = 3;
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

// 128B-swizzled 64 x 64 bf16 tiles, the layout `wgmma` reads: row r's
// 16-byte chunk c sits at r * 128 + ((c ^ (r & 7)) << 4), and a tile starts
// on a 1024-byte boundary.
constexpr int kSwTile = kTile * kTile * 2;
__device__ __forceinline__ int sw_off(int r, int c16) { return r * 128 + ((c16 ^ (r & 7)) << 4); }

// wgmma shared-memory descriptor for a 128B-swizzled operand: start address,
// leading and stride byte offsets (16-byte units), layout type 1 (SW128);
// K-major: k-step kk of a tile starts kk * 32 bytes in; MN-major (the
// transpose bit): at row 16 kk
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}
__device__ __forceinline__ uint64_t kmajor(uint32_t addr) { return sw128_desc(addr, 16, 1024); }
__device__ __forceinline__ uint64_t mnmajor(uint32_t addr) { return sw128_desc(addr, kSwTile, 1024); }
__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keep the compiler from moving accumulator reads or writes across the
// asynchronous wgmma
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
// shared-memory writes of the generic proxy (cp.async, st.shared) made
// visible to wgmma's reads
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// ldmatrix row addresses in a swizzled tile, as `at_off` and `bk_off` give
// them in a padded plane
__device__ __forceinline__ int at_sw(int s0, int d0, int lane) {
  return sw_off(s0 + (lane & 7) + 8 * (lane >> 4), (d0 >> 3) + ((lane >> 3) & 1));
}
__device__ __forceinline__ int bk_sw(int k0, int n0, int lane) {
  return sw_off(k0 + (lane & 7) + 8 * ((lane >> 3) & 1), (n0 >> 3) + (lane >> 4));
}

// ---------------------------------------------------------------- pass 1

// the chunk's local state L_c = sum_s (k_s w_s) v_s^T (narrow states: one
// 64 x 64 tile) and its cumulative decay; shared memory: a two-stage ring of
// (k, v) tiles, then cum and w
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
  const Strides sk = a.sk;
  const Strides sv = a.sv;
  const bool vk = a.vk != 0, vv = a.vv != 0;
  const T* kb = static_cast<const T*>(a.k) + b * sk.b + h * sk.h + c0 * sk.t + dk * kTile;
  const T* vb = static_cast<const T*>(a.v) + b * sv.b + h * sv.h + c0 * sv.t + dv * kTile;

  auto issue = [&](int j) {
    bf16* st = ring + (j & 1) * 2 * IN * kPlane;
    const int rows = min(kTile, Lc - j * kTile);
    load_tile<T, IN>(st, kb + j * kTile * sk.t, sk.t, rows, wk, vk);
    load_tile<T, IN>(st + IN * kPlane, vb + j * kTile * sv.t, sv.t, rows, wv, vv);
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
    w[t] = t >= Lc ? 0.0f : __expf(clip(total - cum[t] + w[t]));
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
// (element of the state padded to a 64 x 64 tile, head, batch); the state
// entering each chunk after the first is written as the MID bf16 parts
// pass 3 loads
template <typename T>
__global__ void __launch_bounds__(256) fold_kernel(const __grid_constant__ Args a) {
  constexpr int MID = Parts<T>::MID;
  constexpr int kEl = kTile * kTile;
  const int nv = 1, tiles = 1;
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
  if (valid && a.state != nullptr) a.state[bh * n_el + static_cast<int64_t>(d) * a.DV + col] = S;
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

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}
__device__ __forceinline__ bool passes(float x) { return x >= -kClip && x <= kClip; }

// ------------------------------------------------------------- wide states
//
// DK or DV past 64 (the mLSTM: 1024 and 1025, 16 x 17 state tiles of 64 x
// 64).  Three launches: `state_kernel<T, false>` (the chunks' states, the
// fold and the gate scratch), `scores_kernel` (q.k^T summed over the DK
// tiles once, decayed and masked) and `output_wide_kernel` (y); the
// backward's pairs route runs `state_kernel<T, true>` for the state
// cotangents.  Tiles sit in shared memory as 128B-swizzled bf16 planes, one
// a part, the layout `wgmma` reads.

// rows [0, rows) x cols [0, width) of a (time, feature) slice into P
// swizzled bf16 planes at `dst`, `stride` bytes apart (zero elsewhere in the
// 64 x 64 tile), by a block of NT threads: 16-byte cp.async copies where
// `vec` (bf16, one part; the caller commits), else element loads split into
// parts
template <typename T, int P, int NT>
__device__ __forceinline__ void load_sw_parts(unsigned char* dst, const T* src, int64_t rs, int rows,
                                              int width, bool vec, int stride = kSwTile) {
  if constexpr (P == 1 && sizeof(T) == 2) {
    if (vec) {
      const uint32_t base = smem_addr(dst);
      for (int idx = threadIdx.x; idx < kTile * 8; idx += NT) {
        const int r = idx >> 3, c = idx & 7;
        const bool ok = r < rows && 8 * c < width;
        cp_async16(base + sw_off(r, c), ok ? src + r * rs + 8 * c : src, ok ? 16 : 0);
      }
      return;
    }
  }
  for (int idx = threadIdx.x; idx < kTile * kTile; idx += NT) {
    const int r = idx >> 6, c = idx & 63;
    bf16 p[P];
    split<P>(r < rows && c < width ? to_f32(src[r * rs + c]) : 0.0f, p);
#pragma unroll
    for (int i = 0; i < P; ++i)
      *reinterpret_cast<bf16*>(dst + i * stride + sw_off(r, c >> 3) + (c & 7) * 2) = p[i];
  }
}

// N plain 64 x 64 bf16 planes (row-major, contiguous, as `entering`,
// `gstate` and `scores` hold them) into N swizzled planes by cp.async
template <int N, int NT>
__device__ __forceinline__ void load_planes_sw(unsigned char* dst, const bf16* src) {
  const uint32_t base = smem_addr(dst);
  for (int idx = threadIdx.x; idx < N * kTile * 8; idx += NT) {
    const int r = idx >> 3, c = idx & 7;  // row r of the N stacked planes
    cp_async16(base + (r >> 6) * kSwTile + sw_off(r & 63, c), src + r * kTile + 8 * c, 16);
  }
}

// the accumulator layout's 64 x 64 tile x (f32, this thread's 32 values) as
// MID bf16 parts into `stage` (MID plain planes) and out to `dst` by one
// bulk copy; `stage` is free again once the previous copy has read it.
// With no stage (null) each thread stores its own parts.
template <int MID>
__device__ __forceinline__ void store_parts(const float (&x)[32], unsigned char* stage, bf16* dst) {
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane / 4, tq = lane % 4;
  if (stage == nullptr) {
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int off = (16 * warp + g + 8 * r) * kTile + 8 * n + 2 * tq;
        uint32_t p[MID];
        split2<MID>(x[4 * n + 2 * r], x[4 * n + 2 * r + 1], p);
#pragma unroll
        for (int i = 0; i < MID; ++i) *reinterpret_cast<uint32_t*>(dst + i * kTile * kTile + off) = p[i];
      }
    return;
  }
  if (tid == 0) asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
  __syncthreads();
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int off = (16 * warp + g + 8 * r) * kTile + 8 * n + 2 * tq;
      uint32_t p[MID];
      split2<MID>(x[4 * n + 2 * r], x[4 * n + 2 * r + 1], p);
#pragma unroll
      for (int i = 0; i < MID; ++i) *reinterpret_cast<uint32_t*>(stage + (i * kTile * kTile + off) * 2) = p[i];
    }
  fence_async_smem();
  __syncthreads();
  if (tid == 0) {
    asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(dst),
                 "r"(smem_addr(stage)), "n"(MID * kTile * kTile * 2)
                 : "memory");
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
  }
}

// The state pass: one 64 x 64 state tile (DK tile dk, DV tile dv) of one
// (head, batch) a block of one warpgroup, walking the chunks in order with
// the running state S in registers (f32, the accumulator layout: warp w
// holds rows 16 w ..).  The (k, v) tiles of every chunk come through a
// two-stage cp.async ring, each chunk's raw gates beside its first tile.
// At a chunk's first tile warp 0 scans its log decays (the (0, 0) tile's
// block writes cum and li); each tile then adds its 64 steps of L_c =
// sum_s (w_s k_s) v_s^T, w_s = exp(clip(total - cum_s + li_s)), as `wgmma`
// with A from registers (k^T by `ldmatrix .trans`, times w, split into MID
// parts) and v from shared memory (MN-major); at its last tile S =
// exp(clip(total)) S + L_c, written as the state entering the next chunk
// (MID bf16 parts, one bulk copy a tile) or, after the last chunk, as the
// f32 final state.  Nothing of L_c leaves the chip.
//
// BWD (the backward's pairs route): the same walk over the chunks last
// first with q for k, dy for v, w_t = exp(clip(cum_t)) from the forward's
// cum, and G for S: G_c (G_last = dstate) is written as MID parts at the
// chunk's first tile, with the tile's decay term exp(total) <S_c, G_c> (S_c
// from the forward's entering states) to dpart, and G_{c-1} =
// exp(clip(total_c)) G_c + U_c, U_c = sum_t exp(clip(cum_t)) q_t dy_t^T.
constexpr int kStateStages = 2;
// f32 stores its parts from registers: without the staging tile two blocks
// fit an SM
template <typename T>
constexpr bool kStateStaged = sizeof(T) == 2;
template <typename T>
constexpr int state_smem(int padded) {
  return 1024 + kStateStages * (2 * Parts<T>::IN * kSwTile + 2 * padded * 4) +
         (kStateStaged<T> ? Parts<T>::MID * kSwTile : 0);
}

template <typename T, bool BWD>
__global__ void __launch_bounds__(kThreads, sizeof(T) == 4 ? 2 : BWD ? 3 : 4)
state_kernel(const __grid_constant__ Args a) {
  constexpr int IN = Parts<T>::IN, MID = Parts<T>::MID;
  constexpr int kStage = 2 * IN * kSwTile;  // k planes, then v planes
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ float red[kWarps];
  const uint32_t base = (smem_addr(smem_raw) + 1023) & ~1023u;
  unsigned char* sm = smem_raw + (base - smem_addr(smem_raw));
  unsigned char* out_stage = kStateStaged<T> ? sm + kStateStages * kStage : nullptr;
  const int n_tb = (a.chunk + kTile - 1) / kTile, padded = n_tb * kTile;
  // the gates of chunk c in buffer c % kStateStages: cum, then w
  float* gates = reinterpret_cast<float*>(sm + kStateStages * kStage + (kStateStaged<T> ? MID * kSwTile : 0));
  const int tile = blockIdx.x, h = blockIdx.y, b = blockIdx.z, tiles = a.nk * a.nv;
  const int dk = tile / a.nv, dv = tile % a.nv;
  const int wk = min(kTile, a.DK - dk * kTile), wv = min(kTile, a.DV - dv * kTile);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, tq = lane % 4, d0 = 16 * warp;
  const int64_t bh = static_cast<int64_t>(b) * a.NH + h;
  const int last_len = a.T - (a.nc - 1) * a.chunk;
  const int n_last = (last_len + kTile - 1) / kTile;
  const int steps = (a.nc - 1) * n_tb + n_last;
  const Strides sk = BWD ? a.sq : a.sk, sv = BWD ? a.sdy : a.sv;
  const bool vk = (BWD ? a.vq : a.vk) != 0, vv = (BWD ? a.vdy : a.vv) != 0;
  const T* kb = static_cast<const T*>(BWD ? a.q : a.k) + b * sk.b + h * sk.h + dk * kTile;
  const T* vb = static_cast<const T*>(BWD ? a.dy : a.v) + b * sv.b + h * sv.h + dv * kTile;

  auto at = [&](int n, int& c, int& j) {  // step n: tile j of chunk c
    if (!BWD) {
      c = n / n_tb;
      j = n % n_tb;
    } else if (n < n_last) {
      c = a.nc - 1;
      j = n;
    } else {
      c = a.nc - 2 - (n - n_last) / n_tb;
      j = (n - n_last) % n_tb;
    }
  };
  auto issue = [&](int n) {
    if (n >= steps) return;
    int c, j;
    at(n, c, j);
    unsigned char* st = sm + (n % kStateStages) * kStage;
    const int c0 = c * a.chunk, Lc = min(a.chunk, a.T - c0), rows = min(kTile, Lc - j * kTile);
    const int64_t t0 = c0 + j * kTile;
    load_sw_parts<T, IN, kThreads>(st, kb + t0 * sk.t, sk.t, rows, wk, vk);
    load_sw_parts<T, IN, kThreads>(st + IN * kSwTile, vb + t0 * sv.t, sv.t, rows, wv, vv);
    if (j == 0) {  // the chunk's gates: log_g and log_i (BWD: the forward's cum)
      float* gb = gates + (c % kStateStages) * 2 * padded;
      const float* gsrc = BWD ? a.cum + bh * a.T + c0 : a.log_g + b * a.sg.b + h * a.sg.h + c0 * a.sg.t;
      const int64_t gs = BWD ? 1 : a.sg.t;
      const float* isrc = a.log_i != nullptr ? a.log_i + b * a.si.b + h * a.si.h + c0 * a.si.t : nullptr;
      for (int s = tid; s < padded; s += kThreads) {
        cp_async4(smem_addr(gb + s), s < Lc ? gsrc + s * gs : gsrc, s < Lc ? 4 : 0);
        if (BWD) continue;
        if (isrc != nullptr)
          cp_async4(smem_addr(gb + padded + s), s < Lc ? isrc + s * a.si.t : isrc, s < Lc ? 4 : 0);
        else
          gb[padded + s] = 0.0f;
      }
    }
  };
  for (int n = 0; n < kStateStages; ++n) {
    issue(n);
    cp_async_commit();
  }

  float S[32], L[32];  // S: the running state (BWD: G); L: this chunk's sum, wgmma's alone
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int d = dk * kTile + d0 + g + 8 * ((i >> 1) & 1), col = dv * kTile + 8 * (i >> 2) + 2 * tq + (i & 1);
    S[i] = BWD && a.dstate != nullptr && d < a.DK && col < a.DV
               ? a.dstate[bh * a.DK * a.DV + static_cast<int64_t>(d) * a.DV + col]
               : 0.0f;
  }
  float total = 0.0f;
  for (int n = 0; n < steps; ++n) {
    int c, j;
    at(n, c, j);
    const int c0 = c * a.chunk, Lc = min(a.chunk, a.T - c0), n_tc = (Lc + kTile - 1) / kTile;
    float* cum = gates + (c % kStateStages) * 2 * padded;
    float* w = cum + padded;
    cp_async_wait<kStateStages - 1>();
    fence_async_smem();
    __syncthreads();
    if (j == 0) {  // the chunk's gates, then (BWD) G_c out
      if (!BWD && warp == 0) {  // the inclusive scan of the log decays
        float carry = 0.0f;
        for (int base_t = 0; base_t < Lc; base_t += 32) {
          const int t = base_t + lane;
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
      total = cum[Lc - 1];
      for (int t = tid; t < n_tc * kTile; t += kThreads) {
        if (!BWD && t < Lc && tile == 0) {
          a.cum[bh * a.T + c0 + t] = cum[t];
          a.li[bh * a.T + c0 + t] = w[t];
        }
        w[t] = t >= Lc ? 0.0f : BWD ? __expf(clip(cum[t])) : __expf(clip(total - cum[t] + w[t]));
      }
      if constexpr (BWD) {
        const int64_t at_tile = ((bh * a.nc + c) * tiles + tile) * MID * kTile * kTile;
        store_parts<MID>(S, out_stage, a.gstate + at_tile);
        float x = 0.0f;  // <S_c, G_c> over this thread's elements
        if (c > 0 && passes(total)) {
          const bf16* ent = a.entering + at_tile;
#pragma unroll
          for (int n8 = 0; n8 < 8; ++n8)
#pragma unroll
            for (int r = 0; r < 2; ++r) {
              const int off = (d0 + g + 8 * r) * kTile + 8 * n8 + 2 * tq;
              float2 sc = make_float2(0.0f, 0.0f);
#pragma unroll
              for (int i = 0; i < MID; ++i) {
                const float2 f = __bfloat1622float2(
                    *reinterpret_cast<const __nv_bfloat162*>(ent + i * kTile * kTile + off));
                sc.x += f.x;
                sc.y += f.y;
              }
              x += sc.x * S[4 * n8 + 2 * r] + sc.y * S[4 * n8 + 2 * r + 1];
            }
        }
        x = warp_sum(x);
        if (lane == 0) red[warp] = x;
      }
      __syncthreads();
      if (BWD && tid == 0)
        a.dpart[(bh * a.nc + c) * tiles + tile] =
            c > 0 && passes(total) ? expf(total) * (((red[0] + red[1]) + red[2]) + red[3]) : 0.0f;
    }
    // A[d][s] = k_s[d] w_s (rows d of this warp, 16 steps s a k-step) in MID
    // parts, from the IN parts of the staged k tile
    const uint32_t ks = base + (n % kStateStages) * kStage, vs = ks + IN * kSwTile;
    const float* wj = w + j * kTile;
    uint32_t am[4][MID][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      float x[8] = {};
#pragma unroll
      for (int i = 0; i < IN; ++i) {
        uint32_t r[4];
        ldsm_t(ks + i * kSwTile + at_sw(16 * kk, d0, lane), r);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 f = unpack(r[e]);
          x[2 * e] += f.x;
          x[2 * e + 1] += f.y;
        }
      }
      const int s = 16 * kk + 2 * tq;
      const float w0 = wj[s], w1 = wj[s + 1], w8 = wj[s + 8], w9 = wj[s + 9];
      uint32_t parts[4][MID];
      split2<MID>(x[0] * w0, x[1] * w1, parts[0]);
      split2<MID>(x[2] * w0, x[3] * w1, parts[1]);
      split2<MID>(x[4] * w8, x[5] * w9, parts[2]);
      split2<MID>(x[6] * w8, x[7] * w9, parts[3]);
#pragma unroll
      for (int i = 0; i < MID; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) am[kk][i][e] = parts[e][i];
    }
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int i = 0; i < MID; ++i)
#pragma unroll
        for (int jj = 0; jj < IN; ++jj) {
          if (i + jj >= MID) continue;
          Wgmma<64, 1>::rs(L, am[kk][i], mnmajor(vs + jj * kSwTile + kk * 2048),
                           j > 0 || kk > 0 || i > 0 || jj > 0);
        }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(L);
    if (j == n_tc - 1) {  // the chunk's last tile: fold it in
      const float decay = expf(clip(total));
#pragma unroll
      for (int i = 0; i < 32; ++i) S[i] = decay * S[i] + L[i];
      if (!BWD && c + 1 < a.nc) {
        store_parts<MID>(S, out_stage, a.entering + ((bh * a.nc + c + 1) * tiles + tile) * MID * kTile * kTile);
      } else if (!BWD && a.state != nullptr) {
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const int d = dk * kTile + d0 + g + 8 * ((i >> 1) & 1);
          const int col = dv * kTile + 8 * (i >> 2) + 2 * tq + (i & 1);
          if (d < a.DK && col < a.DV) a.state[bh * a.DK * a.DV + static_cast<int64_t>(d) * a.DV + col] = S[i];
        }
      }
    }
    __syncthreads();
    issue(n + kStateStages);
    cp_async_commit();
  }
  if (tid == 0) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// the pair index of a chunk's (row block tbi, key block j <= tbi)
__host__ __device__ __forceinline__ int tri(int tbi) { return tbi * (tbi + 1) / 2; }

// P[t][s] = (q_t.k_s) exp(clip(cum_t - cum_s + li_s)) for s <= t, both in the
// chunk, else 0: a block per (chunk, pair, head, batch), the q and k tiles
// of each DK tile through a two-stage ring (q planes, then k planes); P' =
// P / exp(clip(cum_t)) is written as its MID bf16 parts, the planes
// `output_wide_kernel` loads (which scales its rows by exp(clip(cum_t)))
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
  const float inv0 = ex2(-clip2(ct0)), inv1 = ex2(-clip2(ct1));
  constexpr int SC = Parts<T>::SCORE;
  bf16* out = a.scores + ((bh * a.nc + c) * tri(n_tb) + pair) * SC * kTile * kTile;
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    float p[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int sk = j * kTile + 8 * n + 2 * tq + (e & 1), t = t0 + 8 * (e >> 1);
      const float u = sk < Lc ? (lb[sk] - cb[sk]) * kLog2e : 0.0f;
      const float d = ex2(clip2((e < 2 ? ct0 : ct1) + u));
      p[e] = sk <= t && sk < Lc && t < Lc ? s[n][e] * d * (e < 2 ? inv0 : inv1) : 0.0f;
    }
    const int col = 8 * n + 2 * tq;
    uint32_t r0[SC], r1[SC];
    split2<SC>(p[0], p[1], r0);
    split2<SC>(p[2], p[3], r1);
#pragma unroll
    for (int i = 0; i < SC; ++i) {
      *reinterpret_cast<uint32_t*>(out + i * kTile * kTile + (m0 + g) * kTile + col) = r0[i];
      *reinterpret_cast<uint32_t*>(out + i * kTile * kTile + (m0 + g + 8) * kTile + col) = r1[i];
    }
  }
}

// y for 128 rows of one chunk (two 64-row blocks, a warpgroup each) and NV
// 64-wide DV tiles (N = 64 NV; bf16 2, f32 1, whose tiles come in three
// parts and would not leave room for a second block), every product a
// `wgmma` from swizzled tiles
// that a two-stage cp.async ring brings in: first q.S over the DK tiles (q's
// two row tiles and the entering state's (dk, dv) tiles in MID parts;
// skipped for the first chunk, whose entering state is zero), then P'.V
// over the key blocks (v's two tiles and each row block's scores in MID
// parts, a warpgroup skipping the key blocks past its own).  Each
// entering-state tile is read once for 128 rows, each q tile once for 128
// columns (bf16).  `scores_kernel` writes P' = P / exp(clip(cum_t)), so both
// products sum in one accumulator and y_t = exp(clip(cum_t)) (q_t.S +
// (P'.V)_t).  A DV tile past the last (an odd count) is neither loaded nor
// stored.
constexpr int kOutThreads = 256;
// a ring stage of the two-warpgroup kernels: `output_wide_kernel` (NV = 2
// output tiles) and `grad_kernel` (NV = 1), the larger of its two phases
// (PP: the parts of the pair tiles, the scores' or P's and dS's)
template <typename T, int NV, int PP>
__host__ __device__ constexpr int ring_stage_bytes() {
  constexpr int IN = Parts<T>::IN, MID = Parts<T>::MID;
  return (2 * IN + NV * MID > NV * IN + 2 * PP ? 2 * IN + NV * MID : NV * IN + 2 * PP) * kSwTile;
}

template <typename T>
constexpr int kOutNV = sizeof(T) == 2 ? 2 : 1;  // DV tiles an output block

template <typename T>
__global__ void __launch_bounds__(kOutThreads) output_wide_kernel(const __grid_constant__ Args a) {
  constexpr int IN = Parts<T>::IN, MID = Parts<T>::MID, SC = Parts<T>::SCORE, NV = kOutNV<T>;
  constexpr int kStage = ring_stage_bytes<T, NV, SC>();
  constexpr int kEl = kTile * kTile;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023) & ~1023u;
  unsigned char* sm = smem_raw + (base - smem_addr(smem_raw));
  const int n_tb = (a.chunk + kTile - 1) / kTile, n_rp = (n_tb + 1) / 2, n_vp = (a.nv + NV - 1) / NV;
  const int vp = blockIdx.x % n_vp, rest = blockIdx.x / n_vp;
  const int rp = n_rp - 1 - rest / a.nc, c = rest % a.nc;  // the last row blocks first
  const int h = blockIdx.y, b = blockIdx.z;
  const int c0 = c * a.chunk, Lc = min(a.chunk, a.T - c0), rb0 = 2 * rp;
  if (rb0 * kTile >= Lc) return;
  const int tid = threadIdx.x, wg = tid / 128, warp = (tid / 32) % 4, lane = tid % 32;
  const int g = lane / 4, tq = lane % 4, m0 = 16 * warp;
  const int rb = rb0 + wg;
  const bool live = rb * kTile < Lc, live1 = (rb0 + 1) * kTile < Lc;
  const int dv0 = NV * vp, n_dv = min(NV, a.nv - dv0);  // this block's DV tiles
  const int wv = min(NV * kTile, a.DV - dv0 * kTile);  // and their columns
  const int n_s = c > 0 ? a.nk : 0, n_steps = n_s + rb0 + (live1 ? 2 : 1);
  const int64_t bh = static_cast<int64_t>(b) * a.NH + h;
  const T* qb = static_cast<const T*>(a.q) + b * a.sq.b + h * a.sq.h + static_cast<int64_t>(c0 + rb0 * kTile) * a.sq.t;
  const T* vb = static_cast<const T*>(a.v) + b * a.sv.b + h * a.sv.h + c0 * a.sv.t + dv0 * kTile;
  const bf16* ent = a.entering + (bh * a.nc + c) * a.nk * a.nv * MID * kEl;
  const bf16* sc = a.scores + (bh * a.nc + c) * tri(n_tb) * SC * kEl;

  // stage layout: A (q's two row tiles, or the two row blocks' scores),
  // then B (the state's or v's NV DV tiles side by side, part by part: the
  // N = 64 NV operand of an MN-major descriptor)
  auto issue = [&](int n) {
    if (n >= n_steps) return;
    unsigned char* st = sm + (n & 1) * kStage;
    if (n < n_s) {  // q's DK tile n for both row blocks, the entering state's tiles (n, dv)
      const int wk = min(kTile, a.DK - n * kTile);
      load_sw_parts<T, IN, kOutThreads>(st, qb + n * kTile, a.sq.t, min(kTile, Lc - rb0 * kTile), wk,
                                        a.vq != 0);
      if (live1)
        load_sw_parts<T, IN, kOutThreads>(st + IN * kSwTile, qb + kTile * a.sq.t + n * kTile, a.sq.t,
                                          min(kTile, Lc - (rb0 + 1) * kTile), wk, a.vq != 0);
      for (int p = 0; p < MID; ++p)
        for (int v = 0; v < n_dv; ++v)
          load_planes_sw<1, kOutThreads>(st + (2 * IN + NV * p + v) * kSwTile,
                                         ent + ((n * a.nv + dv0 + v) * MID + p) * kEl);
    } else {  // key block j: the two row blocks' scores with it, v's rows of it
      const int j = n - n_s;
      for (int w = 0; w < 2; ++w)
        if ((rb0 + w) * kTile < Lc && j <= rb0 + w)
          load_planes_sw<SC, kOutThreads>(st + w * SC * kSwTile, sc + (tri(rb0 + w) + j) * SC * kEl);
      for (int v = 0; v < n_dv; ++v)
        load_sw_parts<T, IN, kOutThreads>(st + 2 * SC * kSwTile + v * kSwTile,
                                          vb + static_cast<int64_t>(j) * kTile * a.sv.t + v * kTile, a.sv.t,
                                          min(kTile, Lc - j * kTile), min(kTile, a.DV - (dv0 + v) * kTile),
                                          a.vv != 0, NV * kSwTile);
    }
  };
  issue(0);
  cp_async_commit();
  issue(1);
  cp_async_commit();

  float acc[32 * NV];  // q.S, then P'.V: defined by wgmma alone
  for (int n = 0; n < n_steps; ++n) {
    cp_async_wait<1>();
    fence_async_smem();
    __syncthreads();
    const uint32_t sa = base + (n & 1) * kStage;
    if (live && n < n_s) {
      const uint32_t qa = sa + wg * IN * kSwTile, Sa = sa + 2 * IN * kSwTile;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int i = 0; i < IN; ++i)
#pragma unroll
          for (int p = 0; p < MID; ++p) {
            if (i + p >= MID) continue;
            Wgmma<64 * NV, 1>::ss(acc, kmajor(qa + i * kSwTile + kk * 32),
                                  mnmajor(Sa + NV * p * kSwTile + kk * 2048), n > 0 || kk > 0 || i > 0 || p > 0);
          }
      wgmma_commit();
      wgmma_wait<0>();
    } else if (live && n - n_s <= rb) {
      const int j = n - n_s;
      const uint32_t Pa = sa + wg * SC * kSwTile, Va = sa + 2 * SC * kSwTile;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int p = 0; p < SC; ++p)
#pragma unroll
          for (int jj = 0; jj < IN; ++jj) {
            if (p + jj >= SC) continue;
            Wgmma<64 * NV, 1>::ss(acc, kmajor(Pa + p * kSwTile + kk * 32),
                                  mnmajor(Va + NV * jj * kSwTile + kk * 2048),
                                  n_s > 0 || j > 0 || kk > 0 || p > 0 || jj > 0);
          }
      wgmma_commit();
      wgmma_wait<0>();
    }
    __syncthreads();
    issue(n + 2);
    cp_async_commit();
  }
  if (!live) return;
  fence_regs(acc);
  const float* cb = a.cum + bh * a.T + c0;
  const int t0 = rb * kTile + m0 + g;  // this thread's rows in the chunk: t0, t0 + 8
  T* yb = static_cast<T*>(a.y) + b * a.sy.b + h * a.sy.h + c0 * a.sy.t + dv0 * kTile;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int t = t0 + 8 * r;
    if (t >= Lc) continue;
    const float e = ex2(clip2(cb[t] * kLog2e));
#pragma unroll
    for (int n = 0; n < 8 * NV; ++n) {
      const int col = 8 * n + 2 * tq;
      if (col < wv)
        store2(yb + static_cast<int64_t>(t) * a.sy.t + col, e * acc[4 * n + 2 * r], e * acc[4 * n + 2 * r + 1],
               col + 1 < wv);
    }
  }
}

// ------------------------------------------------------------- backward
//
// The pairs route, `ssd_backward` (see the note at the head of the file),
// on the forward's cum, li and entering states: `state_kernel<T, true>` (the
// state cotangents and the decay term, above), `bscores_kernel` (P, dS and
// the gate sums of each pair), `grad_kernel` for dq, dk and dv, and
// `gates_kernel` (dlog_g, dlog_i).  The heads route's kernels follow
// `gates_kernel`.



// the A fragments of 16 rows x 16 columns (cols 16 kk..) of IN planes
template <int IN>
__device__ __forceinline__ void frag_a(uint32_t plane, int m0, int kk, int lane, uint32_t (&f)[IN][4]) {
#pragma unroll
  for (int i = 0; i < IN; ++i) ldsm(plane + i * kPlaneBytes + a_off(m0, 16 * kk, lane), f[i]);
}

// acc (16 rows x 64) += A rows (IN planes, [row][k]) . B^T, B [n][k] in NB
// planes (`ldmatrix` untransposed), the part pairs (i, j) with i + j < MID
template <int IN, int NB, int MID>
__device__ __forceinline__ void mma_abt(float (&acc)[8][4], uint32_t A, uint32_t B, int m0, int lane) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    uint32_t fa[IN][4];
    frag_a<IN>(A, m0, kk, lane, fa);
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      uint32_t fb[NB][4];
#pragma unroll
      for (int jj = 0; jj < NB; ++jj) ldsm(B + jj * kPlaneBytes + bn_off(16 * np, 16 * kk, lane), fb[jj]);
#pragma unroll
      for (int i = 0; i < IN; ++i)
#pragma unroll
        for (int jj = 0; jj < NB; ++jj) {
          if (i + jj >= MID) continue;
          mma(acc[2 * np], fa[i], fb[jj][0], fb[jj][1]);
          mma(acc[2 * np + 1], fa[i], fb[jj][2], fb[jj][3]);
        }
    }
  }
}

// sum over a row of the accumulator layout: x holds this thread's columns
// of rows g and g + 8; the quad's four lanes hold the row
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// P_ts = (q_t.k_s) D_ts and dS_ts = (dy_t.v_s) D_ts for s <= t in the chunk
// (else 0) of one (row block, key block <= it) pair, written in MID bf16
// parts (the planes `grad_kernel` loads), with
// the sums of g_ts = P_ts (dy_t.v_s) where D's clip passes, by row and by
// column: a block per (chunk, pair, head, batch), q.k^T over the DK tiles
// and then dy.v^T over the DV tiles through one two-stage ring
template <typename T>
__global__ void __launch_bounds__(kThreads) bscores_kernel(const __grid_constant__ Args a) {
  constexpr int IN = Parts<T>::IN, MID = Parts<T>::MID;
  constexpr int kEl = kTile * kTile;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float colsum[kWarps][kTile];
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
  const int64_t s0 = c0 + static_cast<int64_t>(j) * kTile;
  const T* qb = static_cast<const T*>(a.q) + b * a.sq.b + h * a.sq.h + (c0 + tb) * a.sq.t;
  const T* kb = static_cast<const T*>(a.k) + b * a.sk.b + h * a.sk.h + s0 * a.sk.t;
  const T* yb = static_cast<const T*>(a.dy) + b * a.sdy.b + h * a.sdy.h + (c0 + tb) * a.sdy.t;
  const T* vb = static_cast<const T*>(a.v) + b * a.sv.b + h * a.sv.h + s0 * a.sv.t;
  const int steps = a.nk + a.nv;

  auto issue = [&](int n) {
    bf16* st = ring + (n & 1) * 2 * IN * kPlane;
    if (n < a.nk) {
      const int w = min(kTile, a.DK - n * kTile);
      load_tile<T, IN>(st, qb + n * kTile, a.sq.t, nt, w, a.vq != 0);
      load_tile<T, IN>(st + IN * kPlane, kb + n * kTile, a.sk.t, ns, w, a.vk != 0);
    } else {
      const int m = n - a.nk, w = min(kTile, a.DV - m * kTile);
      load_tile<T, IN>(st, yb + m * kTile, a.sdy.t, nt, w, a.vdy != 0);
      load_tile<T, IN>(st + IN * kPlane, vb + m * kTile, a.sv.t, ns, w, a.vv != 0);
    }
  };
  issue(0);
  cp_async_commit();
  if (steps > 1) issue(1);
  cp_async_commit();

  // acc += A.B^T over one staged pair of tiles (rows t, rows s)
  auto step = [&](float (&acc)[8][4], int n) {
    cp_async_wait<1>();
    __syncthreads();
    const uint32_t as = smem_addr(ring + (n & 1) * 2 * IN * kPlane);
    mma_abt<IN, IN, MID>(acc, as, as + IN * kPlaneBytes, m0, lane);
    __syncthreads();
    if (n + 2 < steps) issue(n + 2);
    cp_async_commit();
  };
  float s[8][4] = {}, dp[8][4] = {};
  for (int n = 0; n < a.nk; ++n) step(s, n);
  for (int n = a.nk; n < steps; ++n) step(dp, n);

  const int64_t bh = static_cast<int64_t>(b) * a.NH + h;
  const float* cb = a.cum + bh * a.T + c0;
  const float* lb = a.li + bh * a.T + c0;
  const int t0 = tb + m0 + g;  // this thread's rows in the chunk: t0, t0 + 8
  const float ct0 = (t0 < Lc ? cb[t0] : 0.0f) * kLog2e;
  const float ct1 = (t0 + 8 < Lc ? cb[t0 + 8] : 0.0f) * kLog2e;
  const int64_t tile_at = ((bh * a.nc + c) * tri(n_tb) + pair);
  // P's and dS's MID planes go out through the ring's space, free now, one
  // bulk copy each
  static_assert(2 * MID * kEl * 2 <= 2 * 2 * IN * kPlaneBytes, "P and dS fit in the ring");
  bf16* stage = ring;
  float row0 = 0.0f, row1 = 0.0f, colp[8][2];
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    float p[4], ds[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int sk = j * kTile + 8 * n + 2 * tq + (e & 1), t = t0 + 8 * (e >> 1);
      const float u = sk < Lc ? (lb[sk] - cb[sk]) * kLog2e : 0.0f;
      const float x = (e < 2 ? ct0 : ct1) + u;  // the log decay in base 2
      const bool ok = sk <= t && sk < Lc && t < Lc;
      const float d = ex2(clip2(x));
      p[e] = ok ? s[n][e] * d : 0.0f;
      ds[e] = ok ? dp[n][e] * d : 0.0f;
      const float gg = ok && x >= -kClip * kLog2e && x <= kClip * kLog2e ? p[e] * dp[n][e] : 0.0f;
      if (e < 2) row0 += gg; else row1 += gg;
      if (e < 2) colp[n][e] = gg; else colp[n][e & 1] += gg;
    }
    const int col = 8 * n + 2 * tq;
    uint32_t pp[2][MID], dd[2][MID];
    split2<MID>(p[0], p[1], pp[0]);
    split2<MID>(p[2], p[3], pp[1]);
    split2<MID>(ds[0], ds[1], dd[0]);
    split2<MID>(ds[2], ds[3], dd[1]);
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int i = 0; i < MID; ++i) {
        const int off = i * kEl + (m0 + g + 8 * r) * kTile + col;
        *reinterpret_cast<uint32_t*>(stage + off) = pp[r][i];
        *reinterpret_cast<uint32_t*>(stage + MID * kEl + off) = dd[r][i];
      }
  }
  fence_async_smem();
  __syncthreads();
  if (tid == 0) {
    asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(a.pmat + tile_at * MID * kEl),
                 "r"(smem_addr(stage)), "n"(MID * kEl * 2)
                 : "memory");
    asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(a.dsmat + tile_at * MID * kEl),
                 "r"(smem_addr(stage + MID * kEl)), "n"(MID * kEl * 2)
                 : "memory");
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
  }
  row0 = quad_sum(row0);
  row1 = quad_sum(row1);
  float* rp = a.rpart + tile_at * kTile;
  if (tq == 0) {
    rp[m0 + g] = row0;
    rp[m0 + g + 8] = row1;
  }
  // columns: the eight lanes of one tq hold a warp's 16 rows; then the
  // warps in order
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float x = colp[n][e];
      x += __shfl_xor_sync(0xffffffffu, x, 4);
      x += __shfl_xor_sync(0xffffffffu, x, 8);
      x += __shfl_xor_sync(0xffffffffu, x, 16);
      if (g == 0) colsum[warp][8 * n + 2 * tq + e] = x;
    }
  __syncthreads();
  if (tid < kTile)
    a.cpart[tile_at * kTile + tid] = ((colsum[0][tid] + colsum[1][tid]) + colsum[2][tid]) + colsum[3][tid];
  if (tid == 0) asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

enum { kDQ = 0, kDK = 1, kDV = 2 };

// dq, dk or dv for 128 rows of a chunk (two 64-row blocks, a warpgroup
// each) and one 64-wide output tile, every product a `wgmma` from swizzled
// tiles through a two-stage cp.async ring, as `output_wide_kernel` runs:
//  - the state term over the other width's tiles: DQ dy_t S_c^T (skipped in
//    the first chunk, whose S_c is zero), DK v_s G_c^T, DV k_s G_c; the
//    state's tile in MID parts;
//  - the pairs: DQ dS k over the key blocks <= each row block; DK dS^T q and
//    DV P^T dy over the row blocks >= each key block (A MN-major: the
//    pairs' tiles are [t][s]); the pair's tile in MID parts.
// The two sum in accumulators of their own, joined at the end as out =
// scale . state term + pairs, the scale exp(clip(cum_t)) (DQ) or w_s (DK,
// DV).  DQ and DK also write their state term's dot with q or k over the
// tile, unscaled (ipart, hpart), for the gates.  Rows past the chunk's end
// are zero in every tile and not stored.
template <typename T, int MODE>
__global__ void __launch_bounds__(kOutThreads) grad_kernel(const __grid_constant__ Args a) {
  constexpr int IN = Parts<T>::IN, MID = Parts<T>::MID;
  constexpr int kStage = ring_stage_bytes<T, 1, Parts<T>::MID>();
  constexpr int kEl = kTile * kTile;
  constexpr bool kKeys = MODE != kDQ;  // rows are keys s; the pairs' tiles are transposed
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023) & ~1023u;
  unsigned char* sm = smem_raw + (base - smem_addr(smem_raw));
  const int n_tb = (a.chunk + kTile - 1) / kTile, n_rp = (n_tb + 1) / 2;
  const int n_out = MODE == kDV ? a.nv : a.nk;
  const int ot = blockIdx.x % n_out, rest = blockIdx.x / n_out;
  const int order = rest / a.nc, c = rest % a.nc;
  const int rp = kKeys ? order : n_rp - 1 - order;  // blocks with more pairs first
  const int h = blockIdx.y, b = blockIdx.z;
  const int c0 = c * a.chunk, Lc = min(a.chunk, a.T - c0), rb0 = 2 * rp;
  if (rb0 * kTile >= Lc) return;
  const int n_tbc = (Lc + kTile - 1) / kTile;
  const int tid = threadIdx.x, wg = tid / 128, warp = (tid / 32) % 4, lane = tid % 32;
  const int g = lane / 4, tq = lane % 4, m0 = 16 * warp;
  const int rb = rb0 + wg;
  const bool live = rb * kTile < Lc, live1 = (rb0 + 1) * kTile < Lc;
  const int D_out = MODE == kDV ? a.DV : a.DK;
  const int wo = min(kTile, D_out - ot * kTile);
  const int n_in = MODE == kDV ? a.nk : a.nv, D_in = MODE == kDV ? a.DK : a.DV;
  const int n_s = MODE == kDQ && c == 0 ? 0 : n_in;
  const int n_p = kKeys ? n_tbc - rb0 : rb0 + (live1 ? 2 : 1);
  const int n_steps = n_s + n_p;
  const int64_t bh = static_cast<int64_t>(b) * a.NH + h;
  const int tiles = a.nk * a.nv;

  // the state term's A rows (the two row blocks, a depth tile at a time)
  const Strides sa = MODE == kDQ ? a.sdy : MODE == kDK ? a.sv : a.sk;
  const T* ab = static_cast<const T*>(MODE == kDQ ? a.dy : MODE == kDK ? a.v : a.k) + b * sa.b +
                h * sa.h + static_cast<int64_t>(c0 + rb0 * kTile) * sa.t;
  const bool va = (MODE == kDQ ? a.vdy : MODE == kDK ? a.vv : a.vk) != 0;
  const bf16* state = (MODE == kDQ ? a.entering : a.gstate) + (bh * a.nc + c) * tiles * MID * kEl;
  // the pairs' B rows (the other block of each pair, this output tile)
  const Strides sb = MODE == kDQ ? a.sk : MODE == kDK ? a.sq : a.sdy;
  const T* bb = static_cast<const T*>(MODE == kDQ ? a.k : MODE == kDK ? a.q : a.dy) + b * sb.b +
                h * sb.h + c0 * sb.t + ot * kTile;
  const bool vb = (MODE == kDQ ? a.vk : MODE == kDK ? a.vq : a.vdy) != 0;
  const bf16* pairs = (MODE == kDV ? a.pmat : a.dsmat) + (bh * a.nc + c) * tri(n_tb) * MID * kEl;
  // whether row block r and the other block o of step n's pair meet
  auto meets = [&](int r, int o) { return r * kTile < Lc && (kKeys ? o >= r : o <= r); };

  auto issue = [&](int n) {
    if (n >= n_steps) return;
    unsigned char* st = sm + (n & 1) * kStage;
    if (n < n_s) {  // both row blocks' depth tile n and the state's tile
      const int w = min(kTile, D_in - n * kTile);
      load_sw_parts<T, IN, kOutThreads>(st, ab + n * kTile, sa.t, min(kTile, Lc - rb0 * kTile), w, va);
      if (live1)
        load_sw_parts<T, IN, kOutThreads>(st + IN * kSwTile, ab + kTile * sa.t + n * kTile, sa.t,
                                          min(kTile, Lc - (rb0 + 1) * kTile), w, va);
      const int tile = MODE == kDV ? n * a.nv + ot : ot * a.nv + n;
      load_planes_sw<MID, kOutThreads>(st + 2 * IN * kSwTile, state + tile * MID * kEl);
    } else {  // the other block's rows, and each row block's tile of the pair
      const int o = kKeys ? rb0 + n - n_s : n - n_s;
      load_sw_parts<T, IN, kOutThreads>(st, bb + static_cast<int64_t>(o) * kTile * sb.t, sb.t,
                                        min(kTile, Lc - o * kTile), wo, vb);
      for (int w = 0; w < 2; ++w) {
        const int r = rb0 + w;
        if (meets(r, o))
          load_planes_sw<MID, kOutThreads>(st + (IN + w * MID) * kSwTile,
                                           pairs + (kKeys ? tri(o) + r : tri(r) + o) * MID * kEl);
      }
    }
  };
  issue(0);
  cp_async_commit();
  issue(1);
  cp_async_commit();

  float accS[32], accP[32];  // the state term and the pairs: each defined by wgmma alone
  for (int n = 0; n < n_steps; ++n) {
    cp_async_wait<1>();
    fence_async_smem();
    __syncthreads();
    const uint32_t st = base + (n & 1) * kStage;
    if (live && n < n_s) {  // accS += A . state: A in IN parts, the state in MID parts
      const uint32_t Aa = st + wg * IN * kSwTile, Sa = st + 2 * IN * kSwTile;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int i = 0; i < IN; ++i)
#pragma unroll
          for (int p = 0; p < MID; ++p) {
            if (i + p >= MID) continue;
            const int acc = n > 0 || kk > 0 || i > 0 || p > 0;
            if constexpr (MODE == kDV)  // G [dk][dv]: k = dk, n = dv
              Wgmma<64, 1>::ss(accS, kmajor(Aa + i * kSwTile + kk * 32), mnmajor(Sa + p * kSwTile + kk * 2048),
                               acc);
            else  // S or G [dk][dv]: n = dk, k = dv
              Wgmma<64, 0>::ss(accS, kmajor(Aa + i * kSwTile + kk * 32), kmajor(Sa + p * kSwTile + kk * 32),
                               acc);
          }
      wgmma_commit();
      wgmma_wait<0>();
    } else if (live && n >= n_s && meets(rb, kKeys ? rb0 + n - n_s : n - n_s)) {
      // accP += the pair's tile ([t][s]: transposed for keys) . B rows
      const int o = kKeys ? rb0 + n - n_s : n - n_s;
      const uint32_t Pa = st + (IN + wg * MID) * kSwTile;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int p = 0; p < MID; ++p)
#pragma unroll
          for (int jj = 0; jj < IN; ++jj) {
            if (p + jj >= MID) continue;
            const int acc = o != (kKeys ? rb : 0) || kk > 0 || p > 0 || jj > 0;
            if constexpr (kKeys)
              Wgmma<64, 1, 1>::ss(accP, mnmajor(Pa + p * kSwTile + kk * 2048),
                                  mnmajor(st + jj * kSwTile + kk * 2048), acc);
            else
              Wgmma<64, 1>::ss(accP, kmajor(Pa + p * kSwTile + kk * 32), mnmajor(st + jj * kSwTile + kk * 2048),
                               acc);
          }
      wgmma_commit();
      wgmma_wait<0>();
    }
    __syncthreads();
    issue(n + 2);
    cp_async_commit();
  }
  if (!live) return;
  fence_regs(accS);
  fence_regs(accP);
  const bool has_s = n_s > 0;
  const int r0 = rb * kTile + m0 + g;  // this thread's rows in the chunk: r0, r0 + 8
  if constexpr (MODE != kDV) {  // the state term's dot with q (DQ) or k (DK), by row
    const Strides sx = MODE == kDQ ? a.sq : a.sk;
    const T* xb = static_cast<const T*>(MODE == kDQ ? a.q : a.k) + b * sx.b + h * sx.h + c0 * sx.t + ot * kTile;
    float d[2] = {0.0f, 0.0f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (!has_s || r0 + 8 * r >= Lc) continue;
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = 8 * n + 2 * tq + e;
          if (col < wo) d[r] += accS[4 * n + 2 * r + e] * to_f32(xb[static_cast<int64_t>(r0 + 8 * r) * sx.t + col]);
        }
    }
    float* part = (MODE == kDQ ? a.ipart : a.hpart) + (bh * a.nk + ot) * a.T + c0;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      d[r] = quad_sum(d[r]);
      if (tq == 0 && r0 + 8 * r < Lc) part[r0 + 8 * r] = d[r];
    }
  }
  // the rows' scale: exp(clip(cum_t)) (DQ) or w_s (DK, DV)
  const float* cb = a.cum + bh * a.T + c0;
  const float* lb = a.li + bh * a.T + c0;
  const float total = cb[Lc - 1];
  T* out = static_cast<T*>(MODE == kDQ ? a.dq : MODE == kDK ? a.dk : a.dv);
  const int64_t row_stride = static_cast<int64_t>(a.NH) * D_out;
  T* ob = out + ((static_cast<int64_t>(b) * a.T + c0) * a.NH + h) * D_out + ot * kTile;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int t = r0 + 8 * r;
    if (t >= Lc) continue;
    const float sc = has_s ? ex2(clip2((MODE == kDQ ? cb[t] : total - cb[t] + lb[t]) * kLog2e)) : 0.0f;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const int col = 8 * n + 2 * tq;
      if (col >= wo) continue;
      const float x0 = (has_s ? sc * accS[4 * n + 2 * r] : 0.0f) + accP[4 * n + 2 * r];
      const float x1 = (has_s ? sc * accS[4 * n + 2 * r + 1] : 0.0f) + accP[4 * n + 2 * r + 1];
      store2(ob + t * row_stride + col, x0, x1, col + 1 < wo);
    }
  }
}

// dlog_g and dlog_i of one chunk, a warp per (chunk, head, batch): for each
// step t, dcum_t = rows_t - cols_t + inter_t - h_t and dli_t = cols_t + h_t
// (rows and cols: the sums of g by row and by column, from the pairs'
// partial sums; inter_t =
// exp(cum_t) q_t.S_c dy_t and h_t = w_t k_t.G_c v_t from their DK tiles'
// parts, each where its clip passes); dtotal = sum_t h_t + exp(total)
// <S_c, G_c>; then dlog_g_u = sum_{t>=u} dcum_t + dtotal.  Every sum runs
// in a fixed order.
__global__ void __launch_bounds__(32) gates_kernel(const __grid_constant__ Args a, int tiles) {
  __shared__ float dc[4096];  // dcum over the chunk (chunk <= 4096)
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z, lane = threadIdx.x;
  const int c0 = c * a.chunk, Lc = min(a.chunk, a.T - c0);
  const int n_tb = (a.chunk + kTile - 1) / kTile, n_tbc = (Lc + kTile - 1) / kTile;
  const int64_t bh = static_cast<int64_t>(b) * a.NH + h;
  const int64_t pairs = (bh * a.nc + c) * tri(n_tb);
  const float* cb = a.cum + bh * a.T + c0;
  const float* lb = a.li + bh * a.T + c0;
  const float total = cb[Lc - 1];
  float hsum = 0.0f;
  for (int t = lane; t < Lc; t += 32) {
    const int tb = t / kTile, r = t % kTile;
    float rows = 0.0f, cols = 0.0f, inter = 0.0f, hs = 0.0f;
    for (int j = 0; j <= tb; ++j) rows += a.rpart[(pairs + tri(tb) + j) * kTile + r];
    for (int i = tb; i < n_tbc; ++i) cols += a.cpart[(pairs + tri(i) + tb) * kTile + r];
    for (int dk = 0; dk < a.nk; ++dk) {
      inter += a.ipart[(bh * a.nk + dk) * a.T + c0 + t];
      hs += a.hpart[(bh * a.nk + dk) * a.T + c0 + t];
    }
    const float ct = cb[t], xw = total - ct + lb[t];
    inter = passes(ct) ? expf(ct) * inter : 0.0f;
    hs = passes(xw) ? expf(xw) * hs : 0.0f;
    dc[t] = rows - cols + inter - hs;
    if (a.dli != nullptr) a.dli[(static_cast<int64_t>(b) * a.T + c0 + t) * a.NH + h] = cols + hs;
    hsum += hs;
  }
  float decay = 0.0f;
  const float* dp = a.dpart + (bh * a.nc + c) * tiles;
  for (int i = lane; i < tiles; i += 32) decay += dp[i];
  const float dtotal = warp_sum(hsum) + warp_sum(decay);
  __syncwarp();
  float carry = 0.0f;
  for (int base = (Lc - 1) / 32 * 32; base >= 0; base -= 32) {
    const int t = base + lane;
    float x = t < Lc ? dc[t] : 0.0f;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float down = __shfl_down_sync(0xffffffffu, x, o);
      if (lane + o < 32) x += down;
    }
    x += carry;
    if (t < Lc) a.dlog_g[(static_cast<int64_t>(b) * a.T + c0 + t) * a.NH + h] = x + dtotal;
    carry = __shfl_sync(0xffffffffu, x, 0);
  }
}

// Narrow states (DK and DV at most 64, Mamba2's) in chunks of at most 256
// steps: the heads route, three launches (`ufold_kernel`, `heads_kernel`,
// `finish_kernel`; see the note at the head of the file).

constexpr int kMaxTb = 4;             // row blocks of a chunk on the heads route
constexpr int kHeadsThreads = 256;    // a heads block: two warpgroups
constexpr int kXPitch = kTile + 4;    // f32 a row of the warpgroups' exchange tile

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
// spins until the phase of parity `parity` has completed; a wait of more
// than ~10 s (a transaction count that never arrives) traps, so a fault
// ends the launch with an error rather than hanging the card
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
// TMA: one box of a 4-d (feature, head, time, batch) map, or of a 2-d
// (column, row) map, into shared memory, counted on the mbarrier `bar`
__device__ __forceinline__ void tma_load4(uint32_t dst, const CUtensorMap* map, int col0, int head,
                                          int row0, int batch, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(col0), "r"(head), "r"(row0), "r"(batch), "r"(bar)
      : "memory");
}
__device__ __forceinline__ void tma_load2(uint32_t dst, const CUtensorMap* map, int col0, int row0,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(col0), "r"(row0), "r"(bar)
      : "memory");
}

// rows [0, rows) x cols [0, width) of a bf16 (time, feature) slice into the
// swizzled tile at `dst` (zero elsewhere), by a block of NT threads: 16-byte
// cp.async copies where `vec` (the caller commits), else element loads
template <int NT>
__device__ __forceinline__ void load_sw(unsigned char* dst, const bf16* src, int64_t rs, int rows,
                                        int width, bool vec) {
  if (vec) {
    const uint32_t base = smem_addr(dst);
    for (int idx = threadIdx.x; idx < kTile * 8; idx += NT) {
      const int r = idx >> 3, c = idx & 7;
      const bool ok = r < rows && 8 * c < width;
      cp_async16(base + sw_off(r, c), ok ? src + r * rs + 8 * c : src, ok ? 16 : 0);
    }
    return;
  }
  for (int idx = threadIdx.x; idx < kTile * kTile; idx += NT) {
    const int r = idx >> 6, c = idx & 63;
    *reinterpret_cast<bf16*>(dst + sw_off(r, c >> 3) + (c & 7) * 2) =
        r < rows && c < width ? src[r * rs + c] : __float2bfloat16_rn(0.0f);
  }
}
// this thread's dot over the 64 columns of rows g and g + 8 of a 64-wide
// accumulator with a swizzled bf16 tile's rows m0 + g and m0 + g + 8,
// summed over the quad
__device__ __forceinline__ float2 row_dot_sw(const float (&acc)[32], const unsigned char* X, int m0,
                                             int g, int tq) {
  float d0 = 0.0f, d1 = 0.0f;
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    const float2 x0 = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(X + sw_off(m0 + g, n) + 4 * tq));
    const float2 x1 = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(X + sw_off(m0 + g + 8, n) + 4 * tq));
    d0 += acc[4 * n] * x0.x + acc[4 * n + 1] * x0.y;
    d1 += acc[4 * n + 2] * x1.x + acc[4 * n + 3] * x1.y;
  }
  return make_float2(quad_sum(d0), quad_sum(d1));
}

// G_c, the cotangent of the state leaving chunk c, in reverse chunk order,
// U_c formed on the way: a block of 4 warps per (head, batch), a warp per
// 16 state rows d x the 64 columns (`mma.sync`, the forward pass 1's
// product), the (q, dy) tiles of the chunks by TMA through a ring of
// kUfoldStages swizzled stages (one thread issues them; cum by cp.async),
// last chunk first.  At each chunk: G_c written as the MID bf16 parts the
// heads kernel loads, then U_c = sum_t exp(clip(cum_t)) q_t dy_t^T over the
// chunk's tiles and G_{c-1} = exp(clip(total_c)) G_c + U_c, all in
// registers; G_c goes out through shared memory, one bulk copy of its
// 16 KB.  cum is the forward's.  A chunk's last tile may hold rows of the
// next chunk (TMA's box is 64 rows): their weights are zero.
constexpr int kUfoldStages = 3;
constexpr int kUfoldStage = 2 * kSwTile + 1024;  // q, dy and the tile's cum, 1024-byte aligned
// the stages, then G_c's MID planes as gstate holds them, copied out whole
constexpr int kUfoldSmem = 1024 + kUfoldStages * kUfoldStage + 2 * kSwTile;

__global__ void __launch_bounds__(kThreads)
ufold_kernel(const __grid_constant__ Args a, const __grid_constant__ CUtensorMap tm_q,
             const __grid_constant__ CUtensorMap tm_dy) {
  constexpr int MID = Parts<bf16>::MID;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[kUfoldStages];
  const uint32_t base = (smem_addr(smem_raw) + 1023) & ~1023u;
  unsigned char* sm = smem_raw + (base - smem_addr(smem_raw));
  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, tq = lane % 4, d0 = 16 * warp;
  const int64_t bh = static_cast<int64_t>(b) * a.NH + h;
  const int n_tb = (a.chunk + kTile - 1) / kTile;
  const int last_len = a.T - (a.nc - 1) * a.chunk;
  const int n_last = (last_len + kTile - 1) / kTile;  // the last chunk's tiles, walked first
  const int steps = n_last + (a.nc - 1) * n_tb;
  const float* cb = a.cum + bh * a.T;
  const uint32_t full_addr = smem_addr(full);
  if (tid == 0)
    for (int s = 0; s < kUfoldStages; ++s) mbar_init(full_addr + 8 * s, 1);
  __syncthreads();

  auto at = [&](int n, int& c, int& j) {  // step n: tile j of chunk c
    if (n < n_last) {
      c = a.nc - 1;
      j = n;
    } else {
      c = a.nc - 2 - (n - n_last) / n_tb;
      j = (n - n_last) % n_tb;
    }
  };
  auto issue = [&](int n) {
    int c, j;
    at(n, c, j);
    const int st = n % kUfoldStages;
    const uint32_t sa = base + st * kUfoldStage, bar = full_addr + 8 * st;
    float* cs = reinterpret_cast<float*>(sm + st * kUfoldStage + 2 * kSwTile);
    const int t0 = c * a.chunk + j * kTile;
    const int rows = min(kTile, min(a.chunk, a.T - c * a.chunk) - j * kTile);
    if (tid == 0) {
      fence_async_smem();  // the stage's earlier reads, before TMA overwrites it
      mbar_expect_tx(bar, 2 * kSwTile);
      tma_load4(sa, &tm_q, 0, a.sq.h == 0 ? 0 : h, t0, b, bar);  // head stride 0: one head
      tma_load4(sa + kSwTile, &tm_dy, 0, h, t0, b, bar);
    }
    for (int s = tid; s < kTile; s += kThreads)
      cp_async4(smem_addr(cs + s), s < rows ? cb + t0 + s : cb, s < rows ? 4 : 0);
  };
  for (int n = 0; n < kUfoldStages - 1; ++n) {
    if (n < steps) issue(n);
    cp_async_commit();
  }

  float G[8][4], U[8][4];
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int d = d0 + g + 8 * (e >> 1), col = 8 * n + 2 * tq + (e & 1);
      G[n][e] = a.dstate != nullptr && d < a.DK && col < a.DV
                    ? a.dstate[bh * a.DK * a.DV + static_cast<int64_t>(d) * a.DV + col]
                    : 0.0f;
      U[n][e] = 0.0f;
    }
  for (int n = 0; n < steps; ++n) {
    int c, j;
    at(n, c, j);
    const int Lc = min(a.chunk, a.T - c * a.chunk), rows = min(kTile, Lc - j * kTile);
    const float total = cb[c * a.chunk + Lc - 1];
    const int64_t tile_at = (bh * a.nc + c) * MID * kTile * kTile;
    if (j == 0) {  // G is G_c: write it, staged in shared memory
      unsigned char* gs = sm + kUfoldStages * kUfoldStage;
      if (tid == 0) asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
      __syncthreads();  // the last chunk's copy has read the staging tile
#pragma unroll
      for (int n8 = 0; n8 < 8; ++n8)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int off = (d0 + g + 8 * r) * kTile + 8 * n8 + 2 * tq;
          uint32_t p[MID];
          split2<MID>(G[n8][2 * r], G[n8][2 * r + 1], p);
#pragma unroll
          for (int i = 0; i < MID; ++i) *reinterpret_cast<uint32_t*>(gs + (i * kTile * kTile + off) * 2) = p[i];
        }
      fence_async_smem();
      __syncthreads();
      if (tid == 0) {
        asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(a.gstate + tile_at),
                     "r"(smem_addr(gs)), "n"(MID * kTile * kTile * 2)
                     : "memory");
        asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
      }
    }
    const int st = n % kUfoldStages;
    cp_async_wait<kUfoldStages - 2>();
    mbar_wait(full_addr + 8 * st, (n / kUfoldStages) & 1);
    __syncthreads();
    const uint32_t qs = base + st * kUfoldStage, ys = qs + kSwTile;
    const float* cs = reinterpret_cast<const float*>(sm + st * kUfoldStage + 2 * kSwTile);
    auto weight = [&](int s) { return s < rows ? ex2(clip2(cs[s] * kLog2e)) : 0.0f; };
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {  // 16 steps t of the tile a k-step
      uint32_t r[4];
      ldsm_t(qs + at_sw(16 * kk, d0, lane), r);  // A[d][t] = q_t[d], then times exp(cum_t)
      const int s = 16 * kk + 2 * tq;
      const float w0 = weight(s), w1 = weight(s + 1), w8 = weight(s + 8), w9 = weight(s + 9);
      const float2 x0 = unpack(r[0]), x1 = unpack(r[1]), x2 = unpack(r[2]), x3 = unpack(r[3]);
      uint32_t am[4][MID];
      split2<MID>(x0.x * w0, x0.y * w1, am[0]);
      split2<MID>(x1.x * w0, x1.y * w1, am[1]);
      split2<MID>(x2.x * w8, x2.y * w9, am[2]);
      split2<MID>(x3.x * w8, x3.y * w9, am[3]);
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t bv[4];
        ldsm_t(ys + bk_sw(16 * kk, 16 * np, lane), bv);
#pragma unroll
        for (int i = 0; i < MID; ++i) {
          const uint32_t ai[4] = {am[0][i], am[1][i], am[2][i], am[3][i]};
          mma(U[2 * np], ai, bv[0], bv[1]);
          mma(U[2 * np + 1], ai, bv[2], bv[3]);
        }
      }
    }
    if (n + kUfoldStages - 1 < steps) issue(n + kUfoldStages - 1);
    cp_async_commit();
    if (j * kTile + rows >= Lc) {  // the chunk's last tile: G_{c-1} = exp(clip(total)) G_c + U_c
      const float decay = expf(clip(total));
#pragma unroll
      for (int n8 = 0; n8 < 8; ++n8)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          G[n8][e] = decay * G[n8][e] + U[n8][e];
          U[n8][e] = 0.0f;
        }
    }
  }
  if (tid == 0) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// dv, and each head group's shares of dq and dk, for the 64 keys of one
// block j of a chunk: a block of two warpgroups per (key block, head group,
// chunk, batch), the heaviest key blocks (most row blocks) first.  k_j and
// the q tiles of the row blocks i >= j are loaded once (the heads of a
// group share them: Mamba2's broadcast q and k, or a group of one head);
// each head's v_j, G_c, S_c, dy tiles and gates come through a two-stage
// cp.async ring into 128B-swizzled tiles, the next head's in flight while
// this one's run.  Every product is a warpgroup `wgmma` (m64; the 64 keys s
// are the rows), bf16 operands, f32 accumulators.  Warpgroup w takes the
// pairs (i, j) with i - j = w mod 2, and per head and pair, 16 steps t at a
// time: S^T = k_j q_i^T and dP^T = v_j dy_i^T (m64n16, both from shared
// memory), issued one step ahead so that the tensor cores run them while
// the warps finish the step before: P^T and dS^T by the decay and mask, the
// gate sums by key and by step, dS^T added into the group's sum over heads
// (registers, the warpgroup's at most two pairs), then dv += P^T dy_i
// (m64n64, P^T from registers in MID bf16 parts, dy_i read MN-major).  The
// state terms (m64n64, S_c and G_c in MID parts): warpgroup 0 dq's for the
// rows of block j (dy_j S_c^T, and the inter gate term's dot with q),
// summed over the heads; warpgroup 1 dk's (v_j G_c^T, and h's dot with k),
// summed over the heads, and dv's (w_s k_j G_c).  Warpgroup 1 hands its dv
// and its key sums to warpgroup 0 through shared memory, which adds them in
// that order and writes them.  After the heads: each pair's summed dS goes
// to shared memory as MID swizzled bf16 tiles [t][s], dq's share of the
// pair is dS k_j (the diagonal pair's starting from the dq state term) and
// dk's share of block j is sum_i dS^T q_i (plus the dk state term),
// warpgroup 1's added to warpgroup 0's; both written in f32 (dqp, dkp) for
// `finish_kernel`.  Shared memory: k_j and four q tiles, two stages of nine
// tiles (v, G_c, S_c, four dy) and the chunk's gates, the exchange tile.
constexpr int kHeadsStage = 74 * 1024;  // nine tiles and the gates, on a 1024-byte boundary
constexpr int kHeadsSmem = 1024 + 5 * kSwTile + 2 * kHeadsStage + kTile * kXPitch * 4;

__global__ void __launch_bounds__(kHeadsThreads, 1)
heads_kernel(const __grid_constant__ Args a, const __grid_constant__ CUtensorMap tm_v,
             const __grid_constant__ CUtensorMap tm_dy, const __grid_constant__ CUtensorMap tm_g,
             const __grid_constant__ CUtensorMap tm_s) {
  constexpr int MID = Parts<bf16>::MID;
  constexpr int NT = kHeadsThreads;
  constexpr int kV = 0, kG = kSwTile, kS = 3 * kSwTile, kDy = 5 * kSwTile, kGates = 9 * kSwTile;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ float xcol[kTile], dred[kWarps];
  __shared__ __align__(8) uint64_t full[2];  // a stage's TMA tiles have landed
  const uint32_t base = (smem_addr(smem_raw) + 1023) & ~1023u;
  unsigned char* sm = smem_raw + (base - smem_addr(smem_raw));
  unsigned char* kres = sm;
  unsigned char* qres = sm + kSwTile;  // tile i: q of row block i
  unsigned char* stages = sm + 5 * kSwTile;
  float* xchg = reinterpret_cast<float*>(stages + 2 * kHeadsStage);
  const uint32_t k_addr = base, q_addr = base + kSwTile, st_addr = base + 5 * kSwTile;

  const int n_tb = (a.chunk + kTile - 1) / kTile;
  int idx = blockIdx.x;
  const int j = idx / (a.ng * a.nc * a.B);
  idx %= a.ng * a.nc * a.B;
  const int grp = idx % a.ng;
  idx /= a.ng;
  const int c = idx % a.nc, b = idx / a.nc;
  const int c0 = c * a.chunk, Lc = min(a.chunk, a.T - c0), sb = j * kTile;
  if (sb >= Lc) return;
  const int n_tbc = (Lc + kTile - 1) / kTile;
  const int h0 = grp * a.hg, nh = min(a.hg, a.NH - h0);
  const int tid = threadIdx.x, wg = tid / 128, warp = (tid / 32) % 4, lane = tid % 32;
  const int g = lane / 4, tq = lane % 4, m0 = 16 * warp;
  const bf16* qb = static_cast<const bf16*>(a.q) + b * a.sq.b + h0 * a.sq.h + c0 * a.sq.t;
  const bf16* kb = static_cast<const bf16*>(a.k) + b * a.sk.b + h0 * a.sk.h + c0 * a.sk.t;

  const uint32_t full_addr = smem_addr(full);
  if (tid == 0) {
    mbar_init(full_addr, 1);
    mbar_init(full_addr + 8, 1);
  }
  __syncthreads();
  // head h0 + hh into stage hh & 1: its v_j, G_c, S_c and dy tiles by TMA
  // (one thread), the chunk's gates by cp.async (every thread)
  auto issue = [&](int hh) {
    const int h = h0 + hh;
    const int64_t bh = static_cast<int64_t>(b) * a.NH + h;
    unsigned char* st = stages + (hh & 1) * kHeadsStage;
    const uint32_t sa = st_addr + (hh & 1) * kHeadsStage, bar = full_addr + 8 * (hh & 1);
    if (tid == 0) {
      fence_async_smem();  // the stage's earlier reads, before TMA overwrites it
      mbar_expect_tx(bar, (1 + 2 * MID + (n_tbc - j)) * kSwTile - (c > 0 ? 0 : MID * kSwTile));
      tma_load4(sa + kV, &tm_v, 0, h, c0 + sb, b, bar);
      const int plane = static_cast<int>((bh * a.nc + c) * MID * kTile);
      tma_load2(sa + kG, &tm_g, 0, plane, bar);
      if (c > 0) tma_load2(sa + kS, &tm_s, 0, plane, bar);
      for (int i = j; i < n_tbc; ++i) tma_load4(sa + kDy + i * kSwTile, &tm_dy, 0, h, c0 + i * kTile, b, bar);
    }
    float* cs = reinterpret_cast<float*>(st + kGates);
    const float* cg = a.cum + bh * a.T + c0;
    const float* lg = a.li + bh * a.T + c0 + sb;
    for (int s = tid; s < n_tbc * kTile; s += NT)
      cp_async4(smem_addr(cs + s), s < Lc ? cg + s : cg, s < Lc ? 4 : 0);
    for (int s = tid; s < kTile; s += NT)
      cp_async4(smem_addr(cs + kMaxTb * kTile + s), sb + s < Lc ? lg + s : lg, sb + s < Lc ? 4 : 0);
  };
  load_sw<NT>(kres, kb + sb * a.sk.t, a.sk.t, min(kTile, Lc - sb), a.DK, a.vk != 0);
  for (int i = j; i < n_tbc; ++i)
    load_sw<NT>(qres + i * kSwTile, qb + i * kTile * a.sq.t, a.sq.t, min(kTile, Lc - i * kTile), a.DK,
                a.vq != 0);
  issue(0);
  cp_async_commit();

  float sds[2][32];  // this warpgroup's pairs: dS^T summed over the group's heads
  float stt[32];     // warpgroup 0: dq's state term of block j's rows; 1: dk's; summed over heads
#pragma unroll
  for (int i = 0; i < 32; ++i) sds[0][i] = sds[1][i] = stt[i] = 0.0f;

  for (int hh = 0; hh < nh; ++hh) {
    cp_async_wait<0>();  // this thread's gates (and first the resident k and q tiles)
    mbar_wait(full_addr + 8 * (hh & 1), (hh >> 1) & 1);
    fence_async_smem();
    __syncthreads();  // head hh landed; every warp is done with head hh - 1
    if (hh + 1 < nh) issue(hh + 1);
    cp_async_commit();
    const int h = h0 + hh;
    const int64_t bh = static_cast<int64_t>(b) * a.NH + h;
    const unsigned char* st = stages + (hh & 1) * kHeadsStage;
    const uint32_t sa = st_addr + (hh & 1) * kHeadsStage;
    const uint32_t v_addr = sa + kV, G_addr = sa + kG, S_addr = sa + kS, dy_addr = sa + kDy;
    const float* cs = reinterpret_cast<const float*>(st + kGates);
    const float* ls = cs + kMaxTb * kTile;
    const float total = cs[Lc - 1];
    float us[2], w[2];  // this thread's keys s: (li_s - cum_s) in base 2, and w_s
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int sr = m0 + g + 8 * r, s = sb + sr;
      us[r] = (ls[sr] - cs[s]) * kLog2e;
      w[r] = s < Lc ? ex2(clip2((total - cs[s] + ls[sr]) * kLog2e)) : 0.0f;
    }
    // the state terms, each in accumulators of its own that only `wgmma`
    // defines (an accumulator an ALU instruction also defines, between one
    // wgmma and the next, makes ptxas serialize every wgmma of the kernel)
    if (wg == 0) {  // dq's state term for block j's rows t: e_t dy_t S_c^T
      float2 inter = make_float2(0.0f, 0.0f);
      if (c > 0) {
        float tmp[32];
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int p = 0; p < MID; ++p)  // S [d][v]: B K-major
            Wgmma<64, 0>::ss(tmp, kmajor(dy_addr + j * kSwTile + kk * 32),
                             kmajor(S_addr + p * kSwTile + kk * 32), kk + p > 0);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(tmp);
        inter = row_dot_sw(tmp, qres + j * kSwTile, m0, g, tq);
        const float e0 = ex2(clip2(cs[sb + m0 + g] * kLog2e));
        const float e1 = ex2(clip2(cs[sb + m0 + g + 8] * kLog2e));
#pragma unroll
        for (int i = 0; i < 32; ++i) stt[i] += ((i >> 1) & 1 ? e1 : e0) * tmp[i];
      }
      if (tq == 0) {
        float* ip = a.ipart + bh * a.T + c0 + sb;
        if (sb + m0 + g < Lc) ip[m0 + g] = inter.x;
        if (sb + m0 + g + 8 < Lc) ip[m0 + g + 8] = inter.y;
      }
    } else {  // dk's state term w_s v_s G_c^T (h's dot k_s . G_c v_s), and dv's w_s k_s G_c
      float tmp[32], dvs[32];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int p = 0; p < MID; ++p) {
          Wgmma<64, 0>::ss(tmp, kmajor(v_addr + kk * 32), kmajor(G_addr + p * kSwTile + kk * 32),
                           kk + p > 0);  // G [d][v]: B K-major
          Wgmma<64, 1>::ss(dvs, kmajor(k_addr + kk * 32), mnmajor(G_addr + p * kSwTile + kk * 2048),
                           kk + p > 0);  // G [d][v]: B MN-major
        }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(tmp);
      fence_regs(dvs);
      const float2 hdot = row_dot_sw(tmp, kres, m0, g, tq);
      if (tq == 0) {
        float* hp = a.hpart + bh * a.T + c0 + sb;
        if (sb + m0 + g < Lc) hp[m0 + g] = hdot.x;
        if (sb + m0 + g + 8 < Lc) hp[m0 + g + 8] = hdot.y;
      }
      if (j == n_tbc - 1) {  // the decay term exp(total) <S_c, G_c> (the lightest block's)
        float x = 0.0f;
        if (c > 0 && passes(total)) {
#pragma unroll
          for (int n = 0; n < 8; ++n)
#pragma unroll
            for (int r = 0; r < 2; ++r) {
              const int off = sw_off(m0 + g + 8 * r, n) + 4 * tq;
              float2 S = make_float2(0.0f, 0.0f), Gv = S;
#pragma unroll
              for (int p = 0; p < MID; ++p) {
                const float2 fs = __bfloat1622float2(
                    *reinterpret_cast<const __nv_bfloat162*>(st + kS + p * kSwTile + off));
                const float2 fg = __bfloat1622float2(
                    *reinterpret_cast<const __nv_bfloat162*>(st + kG + p * kSwTile + off));
                S.x += fs.x;
                S.y += fs.y;
                Gv.x += fg.x;
                Gv.y += fg.y;
              }
              x += S.x * Gv.x + S.y * Gv.y;
            }
        }
        x = warp_sum(x);
        if (lane == 0) dred[warp] = x;
        asm volatile("bar.sync 1, 128;\n" ::: "memory");  // warpgroup 1 alone
        if (tid == 128)
          a.dpart[bh * a.nc + c] = c > 0 && passes(total)
                                       ? expf(total) * (((dred[0] + dred[1]) + dred[2]) + dred[3])
                                       : 0.0f;
      }
      // dv's state term goes to the exchange tile now; the pairs' dv adds to it there
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const int col = 8 * n + 2 * tq;
        *reinterpret_cast<float2*>(xchg + (m0 + g) * kXPitch + col) =
            make_float2(w[0] * dvs[4 * n], w[0] * dvs[4 * n + 1]);
        *reinterpret_cast<float2*>(xchg + (m0 + g + 8) * kXPitch + col) =
            make_float2(w[1] * dvs[4 * n + 2], w[1] * dvs[4 * n + 3]);
      }
#pragma unroll
      for (int i = 0; i < 32; ++i) stt[i] += w[(i >> 1) & 1] * tmp[i];
    }
    float dv[32];  // the pairs' dv, accumulated by wgmma alone
#pragma unroll
    for (int i = 0; i < 32; ++i) dv[i] = 0.0f;

    float cr0 = 0.0f, cr1 = 0.0f;  // the gate sums of this thread's keys, over t
    // S^T = k_j q_i^T and dP^T = v_j dy_i^T for steps [16 tc, 16 tc + 16)
    // of row block i, one commit group
    float sv[2][8], dp[2][8];
    uint32_t pa[MID][4];  // one buffer: a step's wait retires the step before's dv product
    auto scores = [&](int i, int tc, float (&s8)[8], float (&d8)[8]) {
      const uint32_t qi = q_addr + i * kSwTile, yi = dy_addr + i * kSwTile;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        Wgmma<16, 0>::ss(s8, kmajor(k_addr + kk * 32), kmajor(qi + tc * 2048 + kk * 32), kk > 0);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        Wgmma<16, 0>::ss(d8, kmajor(v_addr + kk * 32), kmajor(yi + tc * 2048 + kk * 32), kk > 0);
      wgmma_commit();
    };
#pragma unroll
    for (int slot = 0; slot < 2; ++slot) {
      const int i = j + wg + 2 * slot;
      if (i < n_tbc) {
        const uint32_t yi = dy_addr + i * kSwTile;
        float* rp = a.rpart + (((bh * a.nc + c) * tri(n_tb) + tri(i) + j) * kWarps + warp) * kTile;
        // below the diagonal block and short of the chunk's end nothing is masked
        const bool inner = i > j && (i + 1) * kTile <= Lc;
        scores(i, 0, sv[0], dp[0]);
#pragma unroll
        for (int tc = 0; tc < 4; ++tc) {
          const int bf = tc & 1;
          if (tc < 3) {  // the next step's scores, in flight while this step runs
            scores(i, tc + 1, sv[bf ^ 1], dp[bf ^ 1]);
            wgmma_wait<1>();
          } else {
            wgmma_wait<0>();
          }
          fence_regs(sv[bf]);
          fence_regs(dp[bf]);
          float rs[2][2] = {}, pv[8];
#pragma unroll
          for (int n = 0; n < 2; ++n) {
            const int t = i * kTile + 16 * tc + 8 * n + 2 * tq;
            const float ct[2] = {cs[t] * kLog2e, cs[t + 1] * kLog2e};
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const float x = ct[e & 1] + us[e >> 1];  // the log decay in base 2
              const float xc = clip2(x);
              const bool ok = inner || (sb + m0 + g + 8 * (e >> 1) <= t + (e & 1) && t + (e & 1) < Lc);
              const float d = ex2(xc);
              const float pp = ok ? sv[bf][4 * n + e] * d : 0.0f;
              const float gg = ok && xc == x ? pp * dp[bf][4 * n + e] : 0.0f;  // where the clip passes
              if (e < 2) cr0 += gg; else cr1 += gg;
              rs[n][e & 1] += gg;
              sds[slot][4 * (2 * tc + n) + e] += ok ? dp[bf][4 * n + e] * d : 0.0f;
              pv[4 * n + e] = pp;
            }
          }
          // the step sums over this warp's 16 keys (the 8 lanes of one tq), in
          // halving exchanges: lane g ends with column 8 (g >> 2 & 1) + (g >> 1 & 1)
          {
            const bool hi = g & 4;
            float k0 = hi ? rs[1][0] : rs[0][0], k1 = hi ? rs[1][1] : rs[0][1];
            k0 += __shfl_xor_sync(0xffffffffu, hi ? rs[0][0] : rs[1][0], 16);
            k1 += __shfl_xor_sync(0xffffffffu, hi ? rs[0][1] : rs[1][1], 16);
            const bool odd = g & 2;
            float x = odd ? k1 : k0;
            x += __shfl_xor_sync(0xffffffffu, odd ? k0 : k1, 8);
            x += __shfl_xor_sync(0xffffffffu, x, 4);
            if ((g & 1) == 0) rp[16 * tc + 8 * (g >> 2 & 1) + 2 * tq + (g >> 1 & 1)] = x;
          }
          // dv += P^T dy_i over these 16 steps: P^T as the A fragments, in MID parts
          uint32_t parts[4][MID];
#pragma unroll
          for (int r = 0; r < 4; ++r) split2<MID>(pv[2 * r], pv[2 * r + 1], parts[r]);
#pragma unroll
          for (int p = 0; p < MID; ++p)
#pragma unroll
            for (int r = 0; r < 4; ++r) pa[p][r] = parts[r][p];
          wgmma_fence();
#pragma unroll
          for (int p = 0; p < MID; ++p) Wgmma<64, 1>::rs(dv, pa[p], mnmajor(yi + tc * 2048), 1);
          wgmma_commit();
        }
      }
    }
    wgmma_wait<0>();
    fence_regs(dv);
    cr0 = quad_sum(cr0);
    cr1 = quad_sum(cr1);
    if (wg == 1) {  // hand dv (the state term, then its pairs') and the key sums to warpgroup 0
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const int col = 8 * n + 2 * tq;
        float2* x0 = reinterpret_cast<float2*>(xchg + (m0 + g) * kXPitch + col);
        float2* x1 = reinterpret_cast<float2*>(xchg + (m0 + g + 8) * kXPitch + col);
        *x0 = make_float2(x0->x + dv[4 * n], x0->y + dv[4 * n + 1]);
        *x1 = make_float2(x1->x + dv[4 * n + 2], x1->y + dv[4 * n + 3]);
      }
      if (tq == 0) {
        xcol[m0 + g] = cr0;
        xcol[m0 + g + 8] = cr1;
      }
    }
    __syncthreads();
    if (wg == 0) {  // warpgroup 0's, then 1's: dv in the input dtype, the key sums
      bf16* vout = static_cast<bf16*>(a.dv) + ((static_cast<int64_t>(b) * a.T + c0) * a.NH + h) * a.DV;
      const int64_t rv = static_cast<int64_t>(a.NH) * a.DV;
      const int s0 = sb + m0 + g;
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const int col = 8 * n + 2 * tq;
        const float2 x0 = *reinterpret_cast<const float2*>(xchg + (m0 + g) * kXPitch + col);
        const float2 x1 = *reinterpret_cast<const float2*>(xchg + (m0 + g + 8) * kXPitch + col);
        if (col < a.DV) {
          const bool pair = col + 1 < a.DV;
          if (s0 < Lc) store2(vout + s0 * rv + col, dv[4 * n] + x0.x, dv[4 * n + 1] + x0.y, pair);
          if (s0 + 8 < Lc)
            store2(vout + (s0 + 8) * rv + col, dv[4 * n + 2] + x1.x, dv[4 * n + 3] + x1.y, pair);
        }
      }
      if (tq == 0) {
        float* cp = a.cpart + bh * a.T + c0;
        if (s0 < Lc) cp[s0] = cr0 + xcol[m0 + g];
        if (s0 + 8 < Lc) cp[s0 + 8] = cr1 + xcol[m0 + g + 8];
      }
    }
  }

  // the group's sums over heads: each pair's dS (transposed back, [t][s])
  // as MID swizzled tiles in the stages' space, warpgroup w's slot q at
  // tiles MID (2 q + w) ...
  __syncthreads();
#pragma unroll
  for (int slot = 0; slot < 2; ++slot) {
    if (j + wg + 2 * slot >= n_tbc) continue;
    unsigned char* pl = stages + MID * (2 * slot + wg) * kSwTile;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int s = m0 + g + 8 * ((i >> 1) & 1), t = 8 * (i >> 2) + 2 * tq + (i & 1);
      bf16 p[MID];
      split<MID>(sds[slot][i], p);
#pragma unroll
      for (int q = 0; q < MID; ++q)
        *reinterpret_cast<bf16*>(pl + q * kSwTile + sw_off(t, s >> 3) + (s & 7) * 2) = p[q];
    }
  }
  fence_async_smem();
  __syncthreads();
  const int64_t grp_at = (static_cast<int64_t>(b) * a.nc + c) * a.ng + grp;
  // dq's share of each pair (i, j): rows t of block i, sum_s dS(t, s) k_s;
  // the diagonal pair's starts from the dq state term (warpgroup 0's stt)
#pragma unroll
  for (int slot = 0; slot < 2; ++slot) {
    const int i = j + wg + 2 * slot;
    if (i >= n_tbc) continue;
    float acc[32];
#pragma unroll
    for (int e = 0; e < 32; ++e) acc[e] = wg == 0 && slot == 0 ? stt[e] : 0.0f;
    const uint32_t pl = st_addr + MID * (2 * slot + wg) * kSwTile;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int p = 0; p < MID; ++p)  // k_j [s][d]: B MN-major
        Wgmma<64, 1>::ss(acc, kmajor(pl + p * kSwTile + kk * 32), mnmajor(k_addr + kk * 2048), 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    float* out = a.dqp + (grp_at * tri(n_tb) + tri(i) + j) * kTile * kTile;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const int col = 8 * n + 2 * tq;
      *reinterpret_cast<float2*>(out + (m0 + g) * kTile + col) = make_float2(acc[4 * n], acc[4 * n + 1]);
      *reinterpret_cast<float2*>(out + (m0 + g + 8) * kTile + col) =
          make_float2(acc[4 * n + 2], acc[4 * n + 3]);
    }
  }
  // dk's share of block j: sum over the pairs of dS^T q_i (A from the
  // registers in MID parts, q_i [t][d]: B MN-major), plus (warpgroup 1) the
  // state term
  float dk[32];
#pragma unroll
  for (int e = 0; e < 32; ++e) dk[e] = wg == 1 ? stt[e] : 0.0f;
#pragma unroll
  for (int slot = 0; slot < 2; ++slot) {
    const int i = j + wg + 2 * slot;
    if (i >= n_tbc) continue;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t parts[4][MID], af[MID][4];
#pragma unroll
      for (int r = 0; r < 4; ++r) split2<MID>(sds[slot][8 * kk + 2 * r], sds[slot][8 * kk + 2 * r + 1], parts[r]);
#pragma unroll
      for (int p = 0; p < MID; ++p)
#pragma unroll
        for (int r = 0; r < 4; ++r) af[p][r] = parts[r][p];
      wgmma_fence();
#pragma unroll
      for (int p = 0; p < MID; ++p) Wgmma<64, 1>::rs(dk, af[p], mnmajor(q_addr + i * kSwTile + kk * 2048), 1);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dk);
    }
  }
  if (wg == 1) {
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const int col = 8 * n + 2 * tq;
      *reinterpret_cast<float2*>(xchg + (m0 + g) * kXPitch + col) = make_float2(dk[4 * n], dk[4 * n + 1]);
      *reinterpret_cast<float2*>(xchg + (m0 + g + 8) * kXPitch + col) = make_float2(dk[4 * n + 2], dk[4 * n + 3]);
    }
  }
  __syncthreads();
  if (wg == 0) {
    float* out = a.dkp + (grp_at * n_tb + j) * kTile * kTile;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const int col = 8 * n + 2 * tq;
      const float2 x0 = *reinterpret_cast<const float2*>(xchg + (m0 + g) * kXPitch + col);
      const float2 x1 = *reinterpret_cast<const float2*>(xchg + (m0 + g + 8) * kXPitch + col);
      *reinterpret_cast<float2*>(out + (m0 + g) * kTile + col) = make_float2(dk[4 * n] + x0.x, dk[4 * n + 1] + x0.y);
      *reinterpret_cast<float2*>(out + (m0 + g + 8) * kTile + col) =
          make_float2(dk[4 * n + 2] + x1.x, dk[4 * n + 3] + x1.y);
    }
  }
}

// The heads route's last launch, blocks of 256 threads.  Blocks [0,
// n_sum): one per (16 rows of a row block, q/k head, chunk, batch), a
// thread per 4 columns of a row: dq and dk there, each the sum of the head
// groups' shares in group order (dq's of the pairs (r, j <= r) in
// key-block order within a group), written in the input dtype at (B, T,
// q/k heads, DK).  The rest: one per (chunk, head, batch), a thread per
// step t: dcum_t = rows_t - cols_t + inter_t - h_t and dli_t = cols_t + h_t
// as `gates_kernel` makes them (the step sums over keys from each pair's
// four warps' parts, the sums over steps, q's and k's gate dots complete),
// dtotal = sum_t h_t + the decay term, then dlog_g_u = sum_{t>=u} dcum_t +
// dtotal by warp scans and the warps' carries in order.  Every sum in a
// fixed order.
constexpr int kFinishThreads = 256;

__global__ void __launch_bounds__(kFinishThreads) finish_kernel(const __grid_constant__ Args a, int n_sum) {
  __shared__ float wsum[2][kFinishThreads / 32];
  const int n_tb = (a.chunk + kTile - 1) / kTile;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  if (static_cast<int>(blockIdx.x) < n_sum) {
    int idx = blockIdx.x;
    const int part = idx % 4;  // 16 rows of the row block
    idx /= 4;
    const int r = idx % n_tb;
    idx /= n_tb;
    const int qh = idx % a.nq;
    idx /= a.nq;
    const int c = idx % a.nc, b = idx / a.nc;
    const int c0 = c * a.chunk, Lc = min(a.chunk, a.T - c0);
    const int row = 16 * part + tid / 16, col = tid % 16 * 4, t = r * kTile + row;
    if (t >= Lc) return;
    const int gpq = a.ng / a.nq;  // head groups of one q/k head
    float4 sq = make_float4(0.0f, 0.0f, 0.0f, 0.0f), sk = sq;
    for (int gi = 0; gi < gpq; ++gi) {
      const int64_t grp_at = (static_cast<int64_t>(b) * a.nc + c) * a.ng + qh * gpq + gi;
      const float* qp = a.dqp + (grp_at * tri(n_tb) + tri(r)) * kTile * kTile + row * kTile + col;
      for (int j = 0; j <= r; ++j) {
        const float4 x = *reinterpret_cast<const float4*>(qp + j * kTile * kTile);
        sq.x += x.x;
        sq.y += x.y;
        sq.z += x.z;
        sq.w += x.w;
      }
      const float4 y = *reinterpret_cast<const float4*>(
          a.dkp + (grp_at * n_tb + r) * kTile * kTile + row * kTile + col);
      sk.x += y.x;
      sk.y += y.y;
      sk.z += y.z;
      sk.w += y.w;
    }
    const int64_t at = ((static_cast<int64_t>(b) * a.T + c0 + t) * a.nq + qh) * a.DK;
    bf16* qo = static_cast<bf16*>(a.dq) + at;
    bf16* ko = static_cast<bf16*>(a.dk) + at;
    const float xq[4] = {sq.x, sq.y, sq.z, sq.w}, xk[4] = {sk.x, sk.y, sk.z, sk.w};
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (col + e < a.DK) {
        qo[col + e] = __float2bfloat16_rn(xq[e]);
        ko[col + e] = __float2bfloat16_rn(xk[e]);
      }
    return;
  }
  int item = static_cast<int>(blockIdx.x) - n_sum;
  const int c = item % a.nc;
  item /= a.nc;
  const int h = item % a.NH, b = item / a.NH;
  const int c0 = c * a.chunk, Lc = min(a.chunk, a.T - c0);
  const int64_t bh = static_cast<int64_t>(b) * a.NH + h;
  const int64_t pairs = (bh * a.nc + c) * tri(n_tb);
  const float* cb = a.cum + bh * a.T + c0;
  const int t = tid;
  float dcum = 0.0f, hs = 0.0f;
  if (t < Lc) {
    const int tb = t / kTile, r = t % kTile;
    float rows = 0.0f;
    for (int j = 0; j <= tb; ++j)
#pragma unroll
      for (int w = 0; w < kWarps; ++w) rows += a.rpart[((pairs + tri(tb) + j) * kWarps + w) * kTile + r];
    const float cols = a.cpart[bh * a.T + c0 + t];
    const float ct = cb[t], xw = cb[Lc - 1] - ct + a.li[bh * a.T + c0 + t];
    const float inter = passes(ct) ? expf(ct) * a.ipart[bh * a.T + c0 + t] : 0.0f;
    hs = passes(xw) ? expf(xw) * a.hpart[bh * a.T + c0 + t] : 0.0f;
    dcum = rows - cols + inter - hs;
    if (a.dli != nullptr) a.dli[(static_cast<int64_t>(b) * a.T + c0 + t) * a.NH + h] = cols + hs;
  }
  // suffix sums within each warp, then each warp's carry from the warps after it
  float x = dcum;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float down = __shfl_down_sync(0xffffffffu, x, o);
    if (lane + o < 32) x += down;
  }
  const float hw = warp_sum(hs);
  if (lane == 0) {
    wsum[0][warp] = x;  // the warp's total
    wsum[1][warp] = hw;
  }
  __syncthreads();
  float carry = 0.0f, hsum = 0.0f;
  for (int w = kFinishThreads / 32 - 1; w > warp; --w) carry += wsum[0][w];
  for (int w = 0; w < kFinishThreads / 32; ++w) hsum += wsum[1][w];
  if (t < Lc)
    a.dlog_g[(static_cast<int64_t>(b) * a.T + c0 + t) * a.NH + h] = x + carry + (hsum + a.dpart[bh * a.nc + c]);
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
  constexpr int IN = Parts<T>::IN;
  static bool attr_local[kMaxDevices] = {}, attr_out[kMaxDevices] = {},
              attr_state[kMaxDevices] = {}, attr_scores[kMaxDevices] = {}, attr_wide[kMaxDevices] = {};
  constexpr int kMaxChunk = 4096;
  const int padded = (a.chunk + kTile - 1) / kTile * kTile;
  const int n_tb = padded / kTile;
  const bool wide = a.nk > 1 || a.nv > 1;
  if (!wide) {  // narrow states: local states, their fold, the outputs
    const int local_most = 2 * 2 * IN * kPlaneBytes + 2 * kMaxChunk * 4;
    constexpr int out_smem = IN * kPlaneBytes + 2 * (2 * IN * kPlaneBytes + 2 * kTile * 4) + kTile * 4;
    cudaError_t err = allow_smem(local_kernel<T>, local_most, attr_local);
    if (err == cudaSuccess) err = allow_smem(output_kernel<T>, out_smem, attr_out);
    if (err != cudaSuccess) return static_cast<int>(err);
    const int local_smem = 2 * 2 * IN * kPlaneBytes + 2 * padded * 4;
    local_kernel<T><<<dim3(a.nc, a.NH, a.B), kThreads, local_smem, st>>>(a);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    fold_kernel<T><<<dim3(kTile * kTile / 256, a.NH, a.B), 256, 0, st>>>(a);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    output_kernel<T><<<dim3(a.NH, a.B, a.nc * n_tb), kThreads, out_smem, st>>>(a);
    return static_cast<int>(cudaGetLastError());
  }
  // wide states: the state pass, the scores, the outputs
  constexpr int scores_smem = 2 * 2 * IN * kPlaneBytes;
  constexpr int wide_smem = 1024 + 2 * ring_stage_bytes<T, kOutNV<T>, Parts<T>::SCORE>();
  cudaError_t err = allow_smem(state_kernel<T, false>, state_smem<T>(kMaxChunk), attr_state);
  if (err == cudaSuccess) err = allow_smem(scores_kernel<T>, scores_smem, attr_scores);
  if (err == cudaSuccess) err = allow_smem(output_wide_kernel<T>, wide_smem, attr_wide);
  if (err != cudaSuccess) return static_cast<int>(err);
  state_kernel<T, false><<<dim3(a.nk * a.nv, a.NH, a.B), kThreads, state_smem<T>(padded), st>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  scores_kernel<T><<<dim3(a.nc * tri(n_tb), a.NH, a.B), kThreads, scores_smem, st>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  output_wide_kernel<T><<<dim3(a.nc * ((n_tb + 1) / 2) * ((a.nv + kOutNV<T> - 1) / kOutNV<T>), a.NH, a.B),
                          kOutThreads, wide_smem, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}


// the pairs route (any state width and chunk) on the forward's cum, li and
// entering states
template <typename T>
int launch_backward(const Args& a, cudaStream_t st) {
  constexpr int IN = Parts<T>::IN;
  static bool attr_state[kMaxDevices] = {}, attr_q[kMaxDevices] = {}, attr_k[kMaxDevices] = {},
              attr_v[kMaxDevices] = {};
  constexpr int kMaxChunk = 4096;
  constexpr int scores_smem = 2 * 2 * IN * kPlaneBytes;
  constexpr int grad_smem = 1024 + 2 * ring_stage_bytes<T, 1, Parts<T>::MID>();
  cudaError_t err = allow_smem(state_kernel<T, true>, state_smem<T>(kMaxChunk), attr_state);
  if (err == cudaSuccess) err = allow_smem(grad_kernel<T, kDQ>, grad_smem, attr_q);
  if (err == cudaSuccess) err = allow_smem(grad_kernel<T, kDK>, grad_smem, attr_k);
  if (err == cudaSuccess) err = allow_smem(grad_kernel<T, kDV>, grad_smem, attr_v);
  if (err != cudaSuccess) return static_cast<int>(err);

  const int padded = (a.chunk + kTile - 1) / kTile * kTile;
  const int n_tb = padded / kTile;
  state_kernel<T, true><<<dim3(a.nk * a.nv, a.NH, a.B), kThreads, state_smem<T>(padded), st>>>(a);
  bscores_kernel<T><<<dim3(a.nc * tri(n_tb), a.NH, a.B), kThreads, scores_smem, st>>>(a);
  const int n_rp = (n_tb + 1) / 2;
  grad_kernel<T, kDQ><<<dim3(a.nk * n_rp * a.nc, a.NH, a.B), kOutThreads, grad_smem, st>>>(a);
  grad_kernel<T, kDK><<<dim3(a.nk * n_rp * a.nc, a.NH, a.B), kOutThreads, grad_smem, st>>>(a);
  grad_kernel<T, kDV><<<dim3(a.nv * n_rp * a.nc, a.NH, a.B), kOutThreads, grad_smem, st>>>(a);
  gates_kernel<<<dim3(a.nc, a.NH, a.B), 32, 0, st>>>(a, a.nk * a.nv);
  return static_cast<int>(cudaGetLastError());
}

// the heads route (bf16, DK and DV at most 64, chunks of at most 256
// steps) on the forward's cum, li and entering states: `ufold_kernel`,
// `heads_kernel` and `finish_kernel`
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled through the runtime's driver entry point, so the
// library needs no -lcuda; looked up once
EncodeTiledFn encode_fn() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                       cudaEnableDefault, &q);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (err == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// a bf16 map with 128B swizzle and zero fill past every edge: rank 4,
// (feature D, head, time, batch) with strides in elements and 64 x 64 boxes
// of one (head, batch); or rank 2 (64 columns, `rows`), contiguous, with
// boxes of `box_rows` rows
bool encode4(CUtensorMap* map, const void* ptr, int D, int heads, int T, int B, Strides st) {
  EncodeTiledFn fn = encode_fn();
  if (fn == nullptr) return false;
  const uint64_t row = static_cast<uint64_t>(D) * sizeof(bf16);
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(T), static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {heads > 1 ? st.h * sizeof(bf16) : row, T > 1 ? st.t * sizeof(bf16) : row,
                                 B > 1 ? st.b * sizeof(bf16) : row};
  const cuuint32_t box[4] = {kTile, 1, kTile, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides, box,
            elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}
bool encode2(CUtensorMap* map, const void* ptr, int64_t rows, int box_rows) {
  EncodeTiledFn fn = encode_fn();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(kTile), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {kTile * sizeof(bf16)};
  const cuuint32_t box[2] = {kTile, static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr), dims, strides, box,
            elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

int launch_heads(const Args& a, cudaStream_t st) {
  // the tensor maps are encoded through the driver, which needs the
  // device's context current on this thread; autograd's worker thread may
  // not have bound it yet (the runtime binds it lazily)
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaSetDevice(dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  static bool attr_heads[kMaxDevices] = {};
  constexpr int heads_smem = kHeadsSmem;
  constexpr int ufold_smem = kUfoldSmem;
  static bool attr_ufold[kMaxDevices] = {};
  err = allow_smem(heads_kernel, heads_smem, attr_heads);
  if (err == cudaSuccess) err = allow_smem(ufold_kernel, ufold_smem, attr_ufold);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_tb = (a.chunk + kTile - 1) / kTile;
  // a map's rows must be a multiple of 16 bytes: q, v and dy as the
  // wrapper streams them, rows padded with zeros to a multiple of 8 elements
  CUtensorMap tm_q, tm_v, tm_dy, tm_g, tm_s;
  const int64_t planes = static_cast<int64_t>(a.B) * a.NH * a.nc * Parts<bf16>::MID * kTile;
  const int dk8 = (a.DK + 7) / 8 * 8, dv8 = (a.DV + 7) / 8 * 8;
  if (!encode4(&tm_q, a.q, dk8, a.sq.h == 0 ? 1 : a.NH, a.T, a.B, a.sq) ||
      !encode4(&tm_v, a.v, dv8, a.NH, a.T, a.B, a.sv) || !encode4(&tm_dy, a.dy, dv8, a.NH, a.T, a.B, a.sdy) ||
      !encode2(&tm_g, a.gstate, planes, Parts<bf16>::MID * kTile) ||
      !encode2(&tm_s, a.entering, planes, Parts<bf16>::MID * kTile))
    return static_cast<int>(cudaErrorInvalidValue);
  ufold_kernel<<<dim3(a.NH, a.B), kThreads, ufold_smem, st>>>(a, tm_q, tm_dy);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  heads_kernel<<<n_tb * a.ng * a.nc * a.B, kHeadsThreads, heads_smem, st>>>(a, tm_v, tm_dy, tm_g, tm_s);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_sum = a.B * a.nc * a.nq * n_tb * 4;
  finish_kernel<<<n_sum + a.nc * a.NH * a.B, kFinishThreads, 0, st>>>(a, n_sum);
  return static_cast<int>(cudaGetLastError());
}

// the backward's arguments common to both routes
Args backward_args(const void* q, const void* k, const void* v, const void* log_g, const void* log_i,
                   const void* dy, const void* dstate, void* dq, void* dk, void* dv, void* dlog_g,
                   void* dli, void* cum, void* li, void* entering, void* gstate,
                   void* rpart, void* cpart, void* ipart, void* hpart, void* dpart,
                   const int64_t (&s)[18], int B, int T_len, int NH, int DK, int DV, int chunk,
                   int vq, int vk, int vv, int vdy) {
  Args a{};
  a.q = q;
  a.k = k;
  a.v = v;
  a.log_g = static_cast<const float*>(log_g);
  a.log_i = static_cast<const float*>(log_i);
  a.cum = static_cast<float*>(cum);
  a.li = static_cast<float*>(li);
  a.entering = static_cast<bf16*>(entering);
  a.sq = Strides{s[0], s[1], s[2]};
  a.sk = Strides{s[3], s[4], s[5]};
  a.sv = Strides{s[6], s[7], s[8]};
  a.sg = Strides{s[9], s[10], s[11]};
  a.si = Strides{s[12], s[13], s[14]};
  a.sdy = Strides{s[15], s[16], s[17]};
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
  a.dy = dy;
  a.vdy = vdy;
  a.dstate = static_cast<const float*>(dstate);
  a.gstate = static_cast<bf16*>(gstate);
  a.rpart = static_cast<float*>(rpart);
  a.cpart = static_cast<float*>(cpart);
  a.ipart = static_cast<float*>(ipart);
  a.hpart = static_cast<float*>(hpart);
  a.dpart = static_cast<float*>(dpart);
  a.dq = dq;
  a.dk = dk;
  a.dv = dv;
  a.dlog_g = static_cast<float*>(dlog_g);
  a.dli = static_cast<float*>(dli);
  return a;
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
  Args a{};
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
  a.scores = static_cast<bf16*>(scores);
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
  if ((a.nk > 1 || a.nv > 1) ? scores == nullptr : local == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kBF16) return launch<bf16>(a, st);
  if (dtype == kF32) {
    a.vq = a.vk = a.vv = 0;
    return launch<float>(a, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int ssd_backward(const void* q, const void* k, const void* v, const void* log_g,
                            const void* log_i, const void* dy, const void* dstate, void* dq,
                            void* dk, void* dv, void* dlog_g, void* dli, void* cum, void* li,
                            void* entering, void* gstate, void* pmat, void* dsmat,
                            void* rpart, void* cpart, void* ipart, void* hpart, void* dpart,
                            int64_t sqb, int64_t sqt, int64_t sqh,
                            int64_t skb, int64_t skt, int64_t skh,
                            int64_t svb, int64_t svt, int64_t svh,
                            int64_t sgb, int64_t sgt, int64_t sgh,
                            int64_t sib, int64_t sit, int64_t sih,
                            int64_t syb, int64_t syt, int64_t syh,
                            int B, int T_len, int NH, int DK, int DV, int chunk, int dtype,
                            int vq, int vk, int vv, int vdy, void* stream) {
  if (DK < 1 || DV < 1 || chunk < 1 || chunk > 4096 || chunk > T_len || B < 1 || NH < 1 ||
      B > 65535 || NH > 65535 || dtype != kBF16 || (log_i == nullptr) != (dli == nullptr) ||
      pmat == nullptr || dsmat == nullptr || cum == nullptr || li == nullptr || entering == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t s[18] = {sqb, sqt, sqh, skb, skt, skh, svb, svt, svh,
                         sgb, sgt, sgh, sib, sit, sih, syb, syt, syh};
  Args a = backward_args(q, k, v, log_g, log_i, dy, dstate, dq, dk, dv, dlog_g, dli, cum, li,
                         entering, gstate, rpart, cpart, ipart, hpart, dpart, s, B, T_len, NH, DK,
                         DV, chunk, vq, vk, vv, vdy);
  a.pmat = static_cast<bf16*>(pmat);
  a.dsmat = static_cast<bf16*>(dsmat);
  return launch_backward<bf16>(a, static_cast<cudaStream_t>(stream));
}

// The heads route: dq and dk at (B, T, qk_heads, DK), qk_heads 1 (q and k
// broadcast over the heads: their gradients summed over the heads) or NH
// (then a group is one head); cum, li and entering hold the forward's
// scratch (`ssd_forward`'s at the same inputs and chunk)
extern "C" int ssd_backward_heads(const void* q, const void* k, const void* v, const void* log_g,
                                  const void* log_i, const void* dy, const void* dstate, void* dq,
                                  void* dk, void* dv, void* dlog_g, void* dli, void* cum, void* li,
                                  void* entering, void* gstate, void* rpart, void* cpart,
                                  void* ipart, void* hpart, void* dpart, void* dqp, void* dkp,
                                  int64_t sqb, int64_t sqt, int64_t sqh,
                                  int64_t skb, int64_t skt, int64_t skh,
                                  int64_t svb, int64_t svt, int64_t svh,
                                  int64_t sgb, int64_t sgt, int64_t sgh,
                                  int64_t sib, int64_t sit, int64_t sih,
                                  int64_t syb, int64_t syt, int64_t syh,
                                  int B, int T_len, int NH, int DK, int DV, int chunk, int groups,
                                  int heads_a_group, int qk_heads, int vq, int vk, int vv, int vdy,
                                  void* stream) {
  if (DK < 1 || DV < 1 || DK > kTile || DV > kTile || chunk < 1 || chunk > kMaxTb * kTile ||
      chunk > T_len || B < 1 || NH < 1 || groups < 1 || heads_a_group < 1 ||
      (groups - 1) * heads_a_group >= NH || groups * heads_a_group < NH ||
      (qk_heads != 1 && qk_heads != NH) || (qk_heads == NH && NH > 1 && heads_a_group != 1) ||
      groups % qk_heads != 0 || (log_i == nullptr) != (dli == nullptr) || cum == nullptr ||
      li == nullptr || entering == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t s[18] = {sqb, sqt, sqh, skb, skt, skh, svb, svt, svh,
                         sgb, sgt, sgh, sib, sit, sih, syb, syt, syh};
  Args a = backward_args(q, k, v, log_g, log_i, dy, dstate, dq, dk, dv, dlog_g, dli, cum, li,
                         entering, gstate, rpart, cpart, ipart, hpart, dpart, s, B, T_len,
                         NH, DK, DV, chunk, vq, vk, vv, vdy);
  a.dqp = static_cast<float*>(dqp);
  a.dkp = static_cast<float*>(dkp);
  a.hg = heads_a_group;
  a.ng = groups;
  a.nq = qk_heads;
  return launch_heads(a, static_cast<cudaStream_t>(stream));
}
