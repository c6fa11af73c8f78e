// Causal or non-causal GQA flash attention (prefill, cross-attention) for
// Hopper (sm_90a): bf16 on the tensor cores (`fa_forward`), and an f32 route
// on CUDA-core FMAs (`fa_forward_f32`, the section before the host code).
//
// Replaces the Pallas TPU kernel `flash_attention` (`_flash_kernel`) of
// src/repro/kernels/flash_attention/kernel.py: online softmax with f32
// running max m, running sum l and accumulator, scale D^-0.5, masked scores
// set to -1e30, query head h reading KV head h / (H / KH), P cast to bf16
// for the P.V product.  Queries and keys have lengths of their own, Sq and
// Sk, as in the Pallas kernel; the causal mask keeps k_pos <= q_pos,
// aligned top-left as there (query row i sees keys 0..i, all Sk of them
// once i >= Sk - 1).
//
// Bound on the card: bytes.  At the serving shape (8, 32, 128, 80) the four
// tensors are 21.0 MB, 6.26 us at 3.35 TB/s, against 0.68 GFLOP of causal
// products, 0.68 us at the bf16 tensor-core peak; at zamba2-2.7b's prefill
// shape (4, 512, 32, 80) 41.9 MB, 12.5 us, against 5.4 GFLOP, 5.4 us.
//
// Design (warp-specialised, as the Hopper guide sets out):
//  - a work item is 128 query rows of one (head, batch): two consumer
//    warpgroups of 64 rows each share every K/V tile.  The grid is
//    persistent, one block an SM walking the items in turn, those with the
//    most K/V tiles (the far end of the causal diagonal) first; the K/V ring
//    and the barriers' phases run on across items, so the producer loads an
//    item's Q and K/V while the consumers finish the one before (one block an
//    SM over 256 items left the second half a whole wave of load latency);
//  - one producer warp's lane 0 issues TMA loads through rank-4 tensor maps
//    (D, heads, seq, batch), built on the host from the tensors' strides, so
//    the model's (B, T, H, D) tensors are read in place: Q into a tile per
//    consumer (full/empty mbarriers), K and V tiles of 64 keys into a
//    ring (full/empty mbarriers) of four stages, or two past head_dim 128;
//  - head_dim is cut into 64-column panels (128 bytes, the widest a
//    128B-swizzled TMA box may be): D = 80 is one full panel plus one whose
//    columns 80-127 TMA fills with zeros (no bytes read for them), and
//    head_dim pads to the next multiple of 16 in shared memory only, or,
//    past 128, to 192 (three panels; MLA's q and k are 192 wide);
//  - S = Q.K^T runs as m64n64k16 `wgmma`s, A (Q) and B (K) both K-major in
//    shared memory, one k-step of 16 columns at a time (the descriptor's
//    start moves 32 bytes inside the swizzle atom);
//  - the softmax runs on the f32 accumulator in registers (four threads a
//    row pair, as mma.sync's layout), and P, packed to bf16, is directly
//    the register A operand of O += P.V, m64nDk16 `wgmma`s whose B is V as
//    it lies (MN-major, the transpose bit set): V is never transposed;
//  - K/V tiles above a consumer's diagonal are skipped, and the keys of a
//    tile that reaches past Sk are masked explicitly: TMA zero-fills the rows
//    past the end, and a zero key scores 0, not -1e30;
//  - the output is staged in shared memory in the 128B-swizzled layout and
//    written by TMA stores through a fourth map, which clip rows past Sq.
// Shared memory: two Q tiles, two output staging tiles and the K/V ring,
// each tile 64 rows of every panel.  Up to head_dim 128 (two panels, 16 KB a
// tile) a four-stage ring makes 192 KB.  At three panels (24 KB a tile) the
// same ring would take 288 KB, past the 227 KB a block may have, so the
// ring has two stages there (192 KB again).  Staging the output in the Q
// tile instead would keep three stages, but the producer loads the next
// item's Q into that tile while the consumers finish this one, which is
// the overlap the persistent grid is for; the D <= 128 instances keep
// their ring as it was.  At D = 192 a consumer thread holds the 64 x 192
// f32 accumulator (96 registers) beside the 64 x 64 scores (32) and P
// (16): within the 224 registers a thread of a 288-thread block may have.
// The shared-memory attribute is set once per template instance and device.
// Times measured (chip_smoke.py phase 2; NVIDIA H100 80GB HBM3, 700.00 W):
// 10.260 us at (8, 128, 32, 80) against SDPA's 11.372 us and the 6.260 us
// bound (the mma.sync design before it: 35.935 us); 32.807 us at
// (4, 512, 32, 80) against SDPA's 31.861 us and the 12.520 us bound.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "wgmma.cuh"

namespace {

constexpr int kRows = 64;        // query rows per consumer warpgroup; keys per K/V tile
constexpr int kConsumers = 2;    // consumer warpgroups per block
constexpr int kThreads = kConsumers * 128 + 32;  // plus one producer warp
constexpr int kPanelCols = 64;   // bf16 columns per 128-byte swizzled panel
constexpr int kPanelBytes = kRows * 128;
constexpr int kMaxD = 192;       // three panels
constexpr int kMaxDevices = 64;  // devices whose attribute and SM count are kept
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

using bf16 = __nv_bfloat16;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
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

// one 64 x 64 box (columns col0.., rows row0..) of a (D, heads, seq, batch) map
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, int col0, int head,
                                         int row0, int batch, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(col0), "r"(head), "r"(row0), "r"(batch),
      "r"(bar)
      : "memory");
}

// wgmma shared-memory descriptor for a 128B-swizzled operand: start address,
// leading and stride byte offsets (16-byte units), layout type 1 (SW128)
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keep the compiler from moving accumulator reads or writes across the
// asynchronous wgmma
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

struct Strides {
  int64_t b, h, s;  // element strides; head_dim is contiguous
};

// named barrier over one consumer warpgroup (id 0 is __syncthreads)
__device__ __forceinline__ void warpgroup_sync(int c) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + c) : "memory");
}

// one 64 x 64 box of the output from shared memory, asynchronously
__device__ __forceinline__ void tma_store(const CUtensorMap* map, uint32_t src, int col0,
                                          int head, int row0, int batch) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%2, %3, %4, %5}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(col0), "r"(head), "r"(row0), "r"(batch)
      : "memory");
}

template <int DP>
struct Smem {
  static constexpr int kStages = DP > 128 ? 2 : 4;     // K/V ring depth (see the note above)
  static constexpr int kPanels = (DP + kPanelCols - 1) / kPanelCols;
  static constexpr int kTile = kPanels * kPanelBytes;  // one 64-row tile, all panels
  static constexpr int kQ = 0;                          // a Q tile per consumer
  static constexpr int kO = kQ + kConsumers * kTile;    // an output staging tile per consumer
  static constexpr int kK = kO + kConsumers * kTile;
  static constexpr int kV = kK + kStages * kTile;
  static constexpr int kBars = kV + kStages * kTile;    // q_full, q_empty, full[], empty[]
  static constexpr int kBytes = kBars + 8 * (2 + 2 * kStages) + 1024;  // + alignment slack
};

// A work item is 128 query rows of one (head, batch): item w takes query
// block n_qb - 1 - w / (H * B), so the items with the most K/V tiles come
// first.  Its K/V tiles are all ceil(Sk / 64) of them, or under the causal
// mask those up to its last row's (no further than Sk).
struct Item {
  int q0, h, b, n_tiles, n_active;
};
__device__ __forceinline__ Item item_at(int w, int H, int B, int Sq, int Sk, int causal) {
  const int n_qb = (Sq + kConsumers * kRows - 1) / (kConsumers * kRows);
  const int rem = w % (H * B);
  Item it;
  it.q0 = (n_qb - 1 - w / (H * B)) * (kConsumers * kRows);
  it.h = rem % H;
  it.b = rem / H;
  const int n_kv = (Sk + kRows - 1) / kRows;
  const int last_row = min(it.q0 + kConsumers * kRows, Sq) - 1;
  it.n_tiles = causal ? min(n_kv, last_row / kRows + 1) : n_kv;
  it.n_active = min(kConsumers, (Sq - it.q0 + kRows - 1) / kRows);
  return it;
}

// DP: head_dim rounded up to a multiple of 16 (the wgmma k-step), or 192
// past 128.  LSE: also store each query row's log-sum-exp of its scaled
// scores, natural base, f32, at lse[(b H + h) Sq + row] (the training
// forward, `fa_forward_lse`; the backward recomputes P from it).  A
// persistent block walks the work items blockIdx.x, blockIdx.x + gridDim.x,
// ...; the K/V ring and the barriers' phases run on across items, so the
// producer loads the next item's Q and K/V while the consumers finish this one.
template <int DP, bool LSE>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_kernel(const __grid_constant__ CUtensorMap tm_q,
                 const __grid_constant__ CUtensorMap tm_k,
                 const __grid_constant__ CUtensorMap tm_v,
                 const __grid_constant__ CUtensorMap tm_o, int H, int KH, int B, int Sq,
                 int Sk, float scale_log2, int causal, float* __restrict__ lse) {
  using L = Smem<DP>;
  constexpr int KSTEPS = DP / 16;
  extern __shared__ unsigned char smem_raw[];
  // 128B-swizzled tiles start on 1024-byte boundaries of the shared window
  const uint32_t base = (smem_addr(smem_raw) + 1023) & ~1023u;
  const uint32_t bar_q_full = base + L::kBars;
  const uint32_t bar_q_empty = bar_q_full + 8;
  const uint32_t bar_full = bar_q_empty + 8;          // + 8 * stage
  constexpr int kStages = L::kStages;
  const uint32_t bar_empty = bar_full + 8 * kStages;  // + 8 * stage
  const int n_items = (Sq + kConsumers * kRows - 1) / (kConsumers * kRows) * H * B;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    mbar_init(bar_q_full, 1);
    mbar_init(bar_q_empty, kConsumers * 4);  // every consumer warp arrives
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, kConsumers * 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == kConsumers * 4) {
    // ------------------------------------------------------------ producer
    if (lane != 0) return;
    int tile = 0;  // K/V tiles loaded by this block so far
    for (int w = blockIdx.x, n = 0; w < n_items; w += gridDim.x, ++n) {
      const Item it = item_at(w, H, B, Sq, Sk, causal);
      const int kh = it.h / (H / KH);
      if (n > 0) mbar_wait(bar_q_empty, (n - 1) & 1);
      mbar_expect_tx(bar_q_full, it.n_active * L::kTile);
      for (int c = 0; c < it.n_active; ++c)
        for (int p = 0; p < L::kPanels; ++p)
          tma_load(base + L::kQ + c * L::kTile + p * kPanelBytes, &tm_q, p * kPanelCols, it.h,
                   it.q0 + c * kRows, it.b, bar_q_full);
      for (int t = 0; t < it.n_tiles; ++t, ++tile) {
        const int s = tile % kStages;
        if (tile >= kStages) mbar_wait(bar_empty + 8 * s, (tile / kStages - 1) & 1);
        const uint32_t full = bar_full + 8 * s;
        mbar_expect_tx(full, 2 * L::kTile);
        for (int p = 0; p < L::kPanels; ++p) {
          tma_load(base + L::kK + s * L::kTile + p * kPanelBytes, &tm_k, p * kPanelCols, kh,
                   t * kRows, it.b, full);
          tma_load(base + L::kV + s * L::kTile + p * kPanelBytes, &tm_v, p * kPanelCols, kh,
                   t * kRows, it.b, full);
        }
      }
    }
    return;
  }

  // -------------------------------------------------------------- consumers
  const int c = warp / 4, wi = warp % 4;
  const int tq = lane % 4;
  const bool leader = threadIdx.x % 128 == 0;
  const uint32_t q_tile = base + L::kQ + c * L::kTile;
  const uint32_t o_tile = base + L::kO + c * L::kTile;
  int tile = 0;
  for (int w = blockIdx.x, n = 0; w < n_items; w += gridDim.x, ++n) {
    const Item it = item_at(w, H, B, Sq, Sk, causal);
    const int r0 = it.q0 + c * kRows;  // this warpgroup's first query row
    const int row_a = r0 + wi * 16 + lane / 4, row_b = row_a + 8;
    const bool active = c < it.n_active;
    // the last K/V tile this warpgroup reads: its last row's, under the causal mask
    const int my_last = !active ? -1
                        : causal ? min(it.n_tiles - 1, (min(r0 + kRows, Sq) - 1) / kRows)
                                 : it.n_tiles - 1;

    float m_a = kNegInf, m_b = kNegInf, l_a = 0.0f, l_b = 0.0f;
    float oacc[DP / 2];
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) oacc[i] = 0.0f;
    float sacc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) sacc[i] = 0.0f;

    mbar_wait(bar_q_full, n & 1);
    if (!active && lane == 0) mbar_arrive(bar_q_empty);
    for (int t = 0; t < it.n_tiles; ++t, ++tile) {
      const int s = tile % kStages;
      mbar_wait(bar_full + 8 * s, (tile / kStages) & 1);
      if (t <= my_last) {
        const uint32_t k_tile = base + L::kK + s * L::kTile;
        const uint32_t v_tile = base + L::kV + s * L::kTile;
        // S = Q . K^T (64 x 64, f32)
        fence_regs(sacc);
        wgmma_fence();
#pragma unroll
        for (int j = 0; j < KSTEPS; ++j) {
          const uint32_t off = (j / 4) * kPanelBytes + (j % 4) * 32;
          Wgmma<64>::ss(sacc, sw128_desc(q_tile + off, 16, 1024),
                        sw128_desc(k_tile + off, 16, 1024), j > 0);
        }
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(sacc);
        if (t == my_last && lane == 0) mbar_arrive(bar_q_empty);  // Q is free for the next item

        // scale (into the exp2 domain), mask, row maxima over the quad
        const int k0 = t * kRows;
        const bool need_mask = k0 + kRows > Sk || (causal && k0 + kRows - 1 > r0);
        float mx_a = kNegInf, mx_b = kNegInf;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float sa = sacc[4 * j + e] * scale_log2, sb = sacc[4 * j + 2 + e] * scale_log2;
            if (need_mask) {
              const int col = k0 + 8 * j + 2 * tq + e;
              const bool ok = col < Sk;
              sa = (ok && (!causal || col <= row_a)) ? sa : kNegInf;
              sb = (ok && (!causal || col <= row_b)) ? sb : kNegInf;
            }
            sacc[4 * j + e] = sa;
            sacc[4 * j + 2 + e] = sb;
            mx_a = fmaxf(mx_a, sa);
            mx_b = fmaxf(mx_b, sb);
          }
        }
        mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, 1));
        mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, 2));
        mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, 1));
        mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, 2));
        const float mn_a = fmaxf(m_a, mx_a), mn_b = fmaxf(m_b, mx_b);
        const float corr_a = exp2f(m_a - mn_a), corr_b = exp2f(m_b - mn_b);
        m_a = mn_a;
        m_b = mn_b;
        float ps_a = 0.0f, ps_b = 0.0f;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            sacc[4 * j + e] = exp2f(sacc[4 * j + e] - mn_a);
            sacc[4 * j + 2 + e] = exp2f(sacc[4 * j + 2 + e] - mn_b);
            ps_a += sacc[4 * j + e];
            ps_b += sacc[4 * j + 2 + e];
          }
        }
        l_a = l_a * corr_a + ps_a;  // this thread's share; the quad is summed at the end
        l_b = l_b * corr_b + ps_b;
#pragma unroll
        for (int j = 0; j < DP / 8; ++j) {
          oacc[4 * j] *= corr_a;
          oacc[4 * j + 1] *= corr_a;
          oacc[4 * j + 2] *= corr_b;
          oacc[4 * j + 3] *= corr_b;
        }

        // O += P . V: score columns 16kk..16kk+15 are the A fragment of k-step kk
        uint32_t pa[4][4];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          pa[kk][0] = pack_bf16(sacc[8 * kk], sacc[8 * kk + 1]);
          pa[kk][1] = pack_bf16(sacc[8 * kk + 2], sacc[8 * kk + 3]);
          pa[kk][2] = pack_bf16(sacc[8 * kk + 4], sacc[8 * kk + 5]);
          pa[kk][3] = pack_bf16(sacc[8 * kk + 6], sacc[8 * kk + 7]);
        }
        fence_regs(oacc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          Wgmma<DP>::rs(oacc, pa[kk], sw128_desc(v_tile + kk * 16 * 128, kPanelBytes, 1024), 1);
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(oacc);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(bar_empty + 8 * s);
    }
    if (!active) continue;

    // epilogue: O / l into this warpgroup's staging tile (128B-swizzled, as
    // the output map reads it), then one TMA store a panel
    l_a += __shfl_xor_sync(0xffffffffu, l_a, 1);
    l_a += __shfl_xor_sync(0xffffffffu, l_a, 2);
    l_b += __shfl_xor_sync(0xffffffffu, l_b, 1);
    l_b += __shfl_xor_sync(0xffffffffu, l_b, 2);
    const float inv_a = 1.0f / fmaxf(l_a, 1e-30f), inv_b = 1.0f / fmaxf(l_b, 1e-30f);
    if constexpr (LSE) {
      // m is in the base-2 domain of the scaled scores: lse = (m + log2 l) ln 2
      float* lrow = lse + (static_cast<int64_t>(it.b) * H + it.h) * Sq;
      if (tq == 0 && row_a < Sq) lrow[row_a] = (m_a + log2f(fmaxf(l_a, 1e-30f))) * kLn2;
      if (tq == 0 && row_b < Sq) lrow[row_b] = (m_b + log2f(fmaxf(l_b, 1e-30f))) * kLn2;
    }
    if (leader) asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
    warpgroup_sync(c);  // the previous item's store has read the staging tile
    const int ra = wi * 16 + lane / 4, rb = ra + 8;  // rows within the tile
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      const uint32_t panel = o_tile + (j / 8) * kPanelBytes;
      const uint32_t col = 4 * tq;  // byte within the 16-byte chunk
      const uint32_t pa_ = pack_bf16(oacc[4 * j] * inv_a, oacc[4 * j + 1] * inv_a);
      const uint32_t pb_ = pack_bf16(oacc[4 * j + 2] * inv_b, oacc[4 * j + 3] * inv_b);
      asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(panel + ra * 128 + (((j % 8) ^ (ra % 8)) << 4) + col),
                   "r"(pa_) : "memory");
      asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(panel + rb * 128 + (((j % 8) ^ (rb % 8)) << 4) + col),
                   "r"(pb_) : "memory");
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // visible to the TMA unit
    warpgroup_sync(c);
    if (leader) {
      for (int p = 0; p < L::kPanels; ++p)
        tma_store(&tm_o, o_tile + p * kPanelBytes, p * kPanelCols, it.h, r0, it.b);
      asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    }
  }
  if (leader) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// ----------------------------------------------------------- the f32 route
//
// f32 q, k and v (the Pallas kernel's f32 instance, held at 3e-5): CUDA-core
// f32 FMAs, since TF32 (10 mantissa bits) and two bf16 parts (~16) both miss
// that bound.  A block takes 64 query rows of one (head, batch), four
// threads a row: a thread keeps q and the accumulator of every fourth
// 4-column chunk of the row in registers (columns 16 m + 4 t .. + 3 for
// thread t), so the four read 64 contiguous bytes of a K or V row and the
// 16 rows of a warp read the same ones (a broadcast).  K/V tiles of 16 keys
// of the row's KV head stream through a three-stage ring in shared memory
// (48 KB at D = 128; 72 KB at D = 192, past the 48 KB a launch has
// without opting in, so `launch_f32` sets the attribute for the instances
// that may need it) by 16-byte `cp.async` where
// the tensors allow it, 4-byte copies else; keys past Sk are zero-filled.  A
// score is the thread's partial dot product summed over the four threads by
// two shuffles; the online softmax keeps f32 m, l and the accumulator, in
// base 2 with the scale folded into log2(e), as the bf16 route does.
// Tiles past the block's last row are skipped under the causal mask.

constexpr int kF32Rows = 64;                       // query rows a block
constexpr int kF32Quad = 4;                        // threads a query row
constexpr int kF32Threads = kF32Rows * kF32Quad;
constexpr int kF32Keys = 16;                       // keys a K/V tile
constexpr int kF32Stages = 3;                      // ring depth

struct F32Args {
  const float *q, *k, *v;
  float* o;
  Strides sq, sk, sv, so;
  int H, KH, Sq, Sk, D, Dp;  // Dp: D rounded up to 4, the row length in shared memory
  float scale_log2;
  int causal;
};

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

// NC: 4-column chunks a thread owns (ceil(Dp / 16), or 12 for any Dp in
// (128, 192]: the chunks past Dp are skipped); VB: the cp.async width
template <int NC, int VB>
__global__ void __launch_bounds__(kF32Threads) flash_f32_kernel(const F32Args a) {
  extern __shared__ __align__(16) float ring[];
  const int tile = gridDim.x - 1 - blockIdx.x;  // the far end of the diagonal first
  const int h = blockIdx.y, b = blockIdx.z;
  const int kh = h / (a.H / a.KH);
  const int t = threadIdx.x % kF32Quad;
  const int qi = tile * kF32Rows + threadIdx.x / kF32Quad;  // this thread's query row
  const int D = a.D, Dp = a.Dp;
  const int n_keys = a.causal ? min(a.Sk, (tile + 1) * kF32Rows) : a.Sk;
  const int n_tiles = (n_keys + kF32Keys - 1) / kF32Keys;
  const float* kb = a.k + b * a.sk.b + kh * a.sk.h;
  const float* vb = a.v + b * a.sv.b + kh * a.sv.h;
  const int stage_floats = 2 * kF32Keys * Dp;
  const uint32_t ring_addr = static_cast<uint32_t>(__cvta_generic_to_shared(ring));

  auto issue = [&](int c) {
    constexpr int E = VB / 4;  // floats a copy
    const uint32_t ks = ring_addr + (c % kF32Stages) * stage_floats * 4;
    const uint32_t vs = ks + kF32Keys * Dp * 4;
    const int pieces = Dp / E;
    for (int idx = threadIdx.x; idx < kF32Keys * pieces; idx += kF32Threads) {
      const int r = idx / pieces, col = (idx - r * pieces) * E;
      const int j = c * kF32Keys + r;
      const bool ok = j < n_keys && col < D;
      const int64_t jj = ok ? j : 0;
      const int cc = ok ? col : 0;
      const uint32_t off = (r * Dp + col) * 4;
      cp_async<VB>(ks + off, kb + jj * a.sk.s + cc, ok ? VB : 0);
      cp_async<VB>(vs + off, vb + jj * a.sv.s + cc, ok ? VB : 0);
    }
  };
  // every stage full from the start; a stage is refilled as soon as its tile
  // is used (one commit group a tile)
#pragma unroll
  for (int c = 0; c < kF32Stages; ++c) {
    if (c < n_tiles) issue(c);
    cp_async_commit();
  }

  float qr[NC][4], acc[NC][4];
  const float* qrow = a.q + b * a.sq.b + h * a.sq.h + static_cast<int64_t>(qi) * a.sq.s;
#pragma unroll
  for (int m = 0; m < NC; ++m) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = 16 * m + 4 * t + e;
      qr[m][e] = qi < a.Sq && col < D ? qrow[col] : 0.0f;
      acc[m][e] = 0.0f;
    }
  }
  float mrow = kNegInf, lrow = 0.0f;

  for (int c = 0; c < n_tiles; ++c) {
    cp_async_wait<kF32Stages - 1>();  // tile c has landed
    __syncthreads();
    const float* ks = ring + (c % kF32Stages) * stage_floats;
    const float* vs = ks + kF32Keys * Dp;
    const int j0 = c * kF32Keys;
    float s[kF32Keys];
    float mx = kNegInf;
#pragma unroll
    for (int u = 0; u < kF32Keys; ++u) {
      float dot = 0.0f;
#pragma unroll
      for (int m = 0; m < NC; ++m) {
        const int col = 16 * m + 4 * t;
        if (col < Dp) {
          const float4 kk = *reinterpret_cast<const float4*>(ks + u * Dp + col);
          dot = fmaf(qr[m][0], kk.x, dot);
          dot = fmaf(qr[m][1], kk.y, dot);
          dot = fmaf(qr[m][2], kk.z, dot);
          dot = fmaf(qr[m][3], kk.w, dot);
        }
      }
      dot += __shfl_xor_sync(0xffffffffu, dot, 1);
      dot += __shfl_xor_sync(0xffffffffu, dot, 2);
      const int j = j0 + u;
      const bool ok = j < a.Sk && (!a.causal || j <= qi);
      s[u] = ok ? dot * a.scale_log2 : kNegInf;
      mx = fmaxf(mx, s[u]);
    }
    const float m_new = fmaxf(mrow, mx);
    const float corr = exp2f(mrow - m_new);
#pragma unroll
    for (int m = 0; m < NC; ++m)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][e] *= corr;
    float psum = 0.0f;
#pragma unroll
    for (int u = 0; u < kF32Keys; ++u) {
      const float p = s[u] > kNegInf ? exp2f(s[u] - m_new) : 0.0f;
      psum += p;
#pragma unroll
      for (int m = 0; m < NC; ++m) {
        const int col = 16 * m + 4 * t;
        if (col < Dp) {
          const float4 vv = *reinterpret_cast<const float4*>(vs + u * Dp + col);
          acc[m][0] = fmaf(p, vv.x, acc[m][0]);
          acc[m][1] = fmaf(p, vv.y, acc[m][1]);
          acc[m][2] = fmaf(p, vv.z, acc[m][2]);
          acc[m][3] = fmaf(p, vv.w, acc[m][3]);
        }
      }
    }
    lrow = lrow * corr + psum;
    mrow = m_new;
    __syncthreads();  // every thread is done with this stage before it is refilled
    if (c + kF32Stages < n_tiles) issue(c + kF32Stages);
    cp_async_commit();
  }
  cp_async_wait<0>();

  if (qi < a.Sq) {
    const float den = fmaxf(lrow, 1e-30f);
    float* orow = a.o + b * a.so.b + h * a.so.h + static_cast<int64_t>(qi) * a.so.s;
#pragma unroll
    for (int m = 0; m < NC; ++m)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 16 * m + 4 * t + e;
        if (col < D) orow[col] = acc[m][e] / den;
      }
  }
}

// ------------------------------------------------------------------- host

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

// a (D, heads, seq, batch) map with 64 x 64 boxes, 128B swizzle, zero fill
// past every edge.  Strides in elements; a dimension of size 1 takes any
// valid stride (its stride is never used).
bool encode(CUtensorMap* map, const void* ptr, int D, int heads, int S, int B, Strides st) {
  EncodeTiledFn fn = encode_fn();
  if (fn == nullptr) return false;
  const uint64_t row = static_cast<uint64_t>(D) * sizeof(bf16);
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(S), static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {heads > 1 ? st.h * sizeof(bf16) : row,
                                 S > 1 ? st.s * sizeof(bf16) : row,
                                 B > 1 ? st.b * sizeof(bf16) : row};
  const cuuint32_t box[4] = {kPanelCols, 1, kRows, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides, box,
            elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// the SM count of device `dev`, looked up once a device
int sm_count(int dev) {
  static int counts[kMaxDevices] = {};
  int n = dev < kMaxDevices ? counts[dev] : 0;
  if (n == 0 && cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return 0;
  if (dev < kMaxDevices) counts[dev] = n;
  return n;
}

template <int DP, bool LSE>
int launch(const CUtensorMap (&maps)[4], int B, int H, int KH, int Sq, int Sk, float scale,
           int causal, float* lse, cudaStream_t st) {
  constexpr int smem = Smem<DP>::kBytes;
  // once per template instance and device: the attribute belongs to the
  // current device's context
  static bool attr_set[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= kMaxDevices || !attr_set[dev]) {
    err = cudaFuncSetAttribute(flash_fwd_kernel<DP, LSE>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dev < kMaxDevices) attr_set[dev] = true;
  }
  const int per_block = kConsumers * kRows;
  const int n_items = (Sq + per_block - 1) / per_block * H * B;
  const int n_sm = sm_count(dev);
  if (n_sm == 0) return static_cast<int>(cudaErrorInvalidDevice);
  flash_fwd_kernel<DP, LSE><<<min(n_items, n_sm), kThreads, smem, st>>>(
      maps[0], maps[1], maps[2], maps[3], H, KH, B, Sq, Sk, scale * kLog2e, causal, lse);
  return static_cast<int>(cudaGetLastError());
}

// the ring's most shared memory at NC (Dp = 16 NC) past the 48 KB a launch
// has by default: opted in once per instance and device
template <int NC, int VB>
cudaError_t f32_smem_attr() {
  constexpr int kMax = kF32Stages * 2 * kF32Keys * 16 * NC * static_cast<int>(sizeof(float));
  if constexpr (kMax <= 48 * 1024) {
    return cudaSuccess;
  } else {
    static bool attr_set[kMaxDevices] = {};
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess || (dev < kMaxDevices && attr_set[dev])) return err;
    err = cudaFuncSetAttribute(flash_f32_kernel<NC, VB>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, kMax);
    if (err == cudaSuccess && dev < kMaxDevices) attr_set[dev] = true;
    return err;
  }
}

template <int NC>
int launch_f32(const F32Args& a, int B, bool vec, cudaStream_t st) {
  const int smem = kF32Stages * 2 * kF32Keys * a.Dp * static_cast<int>(sizeof(float));
  const dim3 grid((a.Sq + kF32Rows - 1) / kF32Rows, a.H, B);
  cudaError_t err = vec ? f32_smem_attr<NC, 16>() : f32_smem_attr<NC, 4>();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (vec)
    flash_f32_kernel<NC, 16><<<grid, kF32Threads, smem, st>>>(a);
  else
    flash_f32_kernel<NC, 4><<<grid, kF32Threads, smem, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// true if every row of t starts on a 16-byte boundary: the base, and each
// stride of a dimension longer than one, a multiple of 4 floats
bool rows_aligned(const void* p, Strides s, int B, int heads, int S) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && (B == 1 || s.b % 4 == 0) &&
         (heads == 1 || s.h % 4 == 0) && (S == 1 || s.s % 4 == 0);
}

// ------------------------------------------------------ the backward (bf16)
//
// The gradient of causal attention with Sq == Sk (the dense training path),
// as `jax.grad` takes it through the reference's `chunked_attention`: no
// Pallas kernel has a backward, the reference differentiates its plain XLA
// math.  The FA2 form: the training forward (`fa_forward_lse`) also writes
// each query row's log-sum-exp, so the backward recomputes P = exp(s - lse)
// tile by tile and never holds the (S, S) scores:
//   Delta = rowsum(dO * O)                     (`fa_bwd_delta_kernel`)
//   dV = P^T dO, dS = P * (dO V^T - Delta), dK = scale dS^T Q
//                                              (`fa_bwd_dkdv_kernel`)
//   dQ = scale dS K                            (`fa_bwd_dq_kernel`)
// Bound: operations (five S x S x D products a head, causal halves, against
// the inputs' bytes).
//
// Design (simple first: no TMA, no wgmma, no pipeline).  Every product is
// `mma.sync` m16n8k16 in bf16 with f32 accumulators; operands come from
// shared memory by `ldmatrix` (`.trans` where the product reads a tile
// along its rows), tiles land there by 16-byte `cp.async` with rows past S
// and columns past D zero-filled, each row padded by 16 bytes so the eight
// rows of an `ldmatrix` fall in distinct banks.  A block is four warps of
// 16 rows.  dK/dV: a block a (64-key tile, KV head, batch) walks the G query
// heads of its KV head and, under the causal mask, the 32-row query tiles
// from its first key on, so the sum over GQA's heads stays inside the block
// (no atomics, deterministic); each warp keeps its 16 keys' dK and dV in
// registers.  dQ: a block a (64-row query tile, head, batch) walks the
// 64-key tiles up to its diagonal.  P and dS go to bf16 for the products
// that take them as the A operand, as P does in the forward.

constexpr int kBwdRows = 64;       // query rows a dQ block; keys a dK/dV block
constexpr int kBwdQ = 32;          // query rows a tile of the dK/dV loop
constexpr int kBwdThreads = 128;   // four warps of 16 rows
constexpr int kBwdMaxD = 128;

struct BwdArgs {
  const bf16 *q, *k, *v, *o, *dout;
  bf16 *dq, *dk, *dv;
  const float* lse;  // (B, H, S), natural base
  float* delta;      // (B, H, S)
  Strides sq, sk, sv, so, sdo, sdq, sdk, sdv;
  int H, KH, S, D;
  float scale;
};

// D (16x8, f32) += A (16x16, bf16, row) * B (16x8, bf16, col)
__device__ __forceinline__ void mma16816(float* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// rows [r0, r0 + n) of one (batch, head) of a (.., S, D) bf16 tensor whose
// rows are `row_stride` elements apart, into n shared rows of DP + 8
// elements; rows past S and columns past D are zeros
template <int DP>
__device__ __forceinline__ void load_tile(uint32_t dst, const bf16* src, int64_t row_stride,
                                          int r0, int n, int S, int D) {
  constexpr int RS = DP + 8, CH = DP / 8;
  for (int idx = threadIdx.x; idx < n * CH; idx += kBwdThreads) {
    const int r = idx / CH, c = (idx - r * CH) * 8;
    const bool ok = r0 + r < S && c < D;
    const bf16* p = src + (ok ? (r0 + r) * row_stride + c : 0);
    cp_async<16>(dst + (r * RS + c) * 2, p, ok ? 16 : 0);
  }
}

// the A fragment (16 rows x k-step ks) of a warp's rows r0.. of a shared tile
template <int RS>
__device__ __forceinline__ void ld_a(uint32_t tile, int r0, int ks, uint32_t (&r)[4]) {
  const int lane = threadIdx.x % 32;
  ldsm_x4(tile + ((r0 + lane % 16) * RS + ks * 16 + (lane / 16) * 8) * 2, r);
}

// B fragments of two 8-row n-tiles (rows n0.., n0 + 8..) at k-step ks of a
// shared tile whose rows are the product's n and columns its k:
// {b0, b1} of the first, {b0, b1} of the second
template <int RS>
__device__ __forceinline__ void ld_b(uint32_t tile, int n0, int ks, uint32_t (&r)[4]) {
  const int lane = threadIdx.x % 32;
  ldsm_x4(tile + ((n0 + (lane / 16) * 8 + lane % 8) * RS + ks * 16 + ((lane / 8) % 2) * 8) * 2,
          r);
}

// B fragments of two 8-column n-tiles (columns c0.., c0 + 8..) at the
// k-step of rows k0..k0 + 15 of a shared tile whose rows are the product's k
template <int RS>
__device__ __forceinline__ void ld_b_t(uint32_t tile, int k0, int c0, uint32_t (&r)[4]) {
  const int lane = threadIdx.x % 32;
  ldsm_x4_t(tile + ((k0 + lane % 16) * RS + c0 + (lane / 16) * 8) * 2, r);
}

// a 16 x 16 A fragment from two 16 x 8 accumulators (n-tiles j, j + 1)
__device__ __forceinline__ void acc_to_a(const float (&c0)[4], const float (&c1)[4],
                                         uint32_t (&a)[4]) {
  a[0] = pack_bf16(c0[0], c0[1]);
  a[1] = pack_bf16(c0[2], c0[3]);
  a[2] = pack_bf16(c1[0], c1[1]);
  a[3] = pack_bf16(c1[2], c1[3]);
}

// Delta[(b H + h) S + s] = sum_d dO O, one warp a row
__global__ void __launch_bounds__(256) fa_bwd_delta_kernel(const BwdArgs a, int64_t n_rows) {
  const int64_t idx = static_cast<int64_t>(blockIdx.x) * 8 + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (idx >= n_rows) return;
  const int s = static_cast<int>(idx % a.S);
  const int64_t bh = idx / a.S;
  const int h = static_cast<int>(bh % a.H), b = static_cast<int>(bh / a.H);
  const bf16* o = a.o + b * a.so.b + h * a.so.h + s * a.so.s;
  const bf16* g = a.dout + b * a.sdo.b + h * a.sdo.h + s * a.sdo.s;
  float acc = 0.0f;
  for (int c = lane * 8; c < a.D; c += 256) {
    const uint4 ov = *reinterpret_cast<const uint4*>(o + c);
    const uint4 gv = *reinterpret_cast<const uint4*>(g + c);
    const bf16* op = reinterpret_cast<const bf16*>(&ov);
    const bf16* gp = reinterpret_cast<const bf16*>(&gv);
#pragma unroll
    for (int e = 0; e < 8; ++e) acc += __bfloat162float(op[e]) * __bfloat162float(gp[e]);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) a.delta[idx] = acc;
}

template <int KS>
__global__ void __launch_bounds__(kBwdThreads) fa_bwd_dkdv_kernel(const BwdArgs a) {
  constexpr int DP = 16 * KS, RS = DP + 8;
  constexpr int KT = kBwdRows * RS * 2, QT = kBwdQ * RS * 2;  // tile bytes
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t sK = smem_addr(smem_raw), sV = sK + KT, sQ = sV + KT, sdO = sQ + QT;
  float* sL = reinterpret_cast<float*>(smem_raw + 2 * KT + 2 * QT);  // lse, base 2
  float* sD = sL + kBwdQ;
  const int kt = blockIdx.x, kh = blockIdx.y, b = blockIdx.z;
  const int k0 = kt * kBwdRows, G = a.H / a.KH;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  load_tile<DP>(sK, a.k + b * a.sk.b + kh * a.sk.h, a.sk.s, k0, kBwdRows, a.S, a.D);
  load_tile<DP>(sV, a.v + b * a.sv.b + kh * a.sv.h, a.sv.s, k0, kBwdRows, a.S, a.D);
  cp_async_commit();
  const int key_a = k0 + warp * 16 + g, key_b = key_a + 8;
  const float sl2 = a.scale * kLog2e;
  float dk[2 * KS][4], dv[2 * KS][4];
#pragma unroll
  for (int i = 0; i < 2 * KS; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[i][e] = dv[i][e] = 0.0f;

  for (int gi = 0; gi < G; ++gi) {
    const int h = kh * G + gi;
    const bf16* qb = a.q + b * a.sq.b + h * a.sq.h;
    const bf16* ob = a.dout + b * a.sdo.b + h * a.sdo.h;
    const float* lrow = a.lse + (static_cast<int64_t>(b) * a.H + h) * a.S;
    const float* drow = a.delta + (static_cast<int64_t>(b) * a.H + h) * a.S;
    for (int q0 = k0; q0 < a.S; q0 += kBwdQ) {  // causal: no query before k0 sees these keys
      __syncthreads();  // every warp is done with the previous query tile
      load_tile<DP>(sQ, qb, a.sq.s, q0, kBwdQ, a.S, a.D);
      load_tile<DP>(sdO, ob, a.sdo.s, q0, kBwdQ, a.S, a.D);
      cp_async_commit();
      if (threadIdx.x < kBwdQ) {
        const int r = q0 + threadIdx.x;
        sL[threadIdx.x] = r < a.S ? lrow[r] * kLog2e : 0.0f;
        sD[threadIdx.x] = r < a.S ? drow[r] : 0.0f;
      }
      cp_async_wait<0>();
      __syncthreads();

      // S^T = K_w Q^T and dP^T = V_w dO^T, 16 keys x 32 queries a warp
      float st[4][4], dpt[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) st[i][e] = dpt[i][e] = 0.0f;
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        uint32_t ak[4], av[4];
        ld_a<RS>(sK, warp * 16, ks, ak);
        ld_a<RS>(sV, warp * 16, ks, av);
#pragma unroll
        for (int np = 0; np < 2; ++np) {
          uint32_t bq[4], bo[4];
          ld_b<RS>(sQ, np * 16, ks, bq);
          ld_b<RS>(sdO, np * 16, ks, bo);
          mma16816(st[2 * np], ak, bq[0], bq[1]);
          mma16816(st[2 * np + 1], ak, bq[2], bq[3]);
          mma16816(dpt[2 * np], av, bo[0], bo[1]);
          mma16816(dpt[2 * np + 1], av, bo[2], bo[3]);
        }
      }
      // P^T (key j, query i) = exp(s - lse_i) where j <= i < S; dS^T = P^T (dP^T - Delta_i)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qi = nt * 8 + 2 * t + (e & 1), row = q0 + qi;
          const int key = e < 2 ? key_a : key_b;
          const float p = row < a.S && key <= row ? exp2f(st[nt][e] * sl2 - sL[qi]) : 0.0f;
          st[nt][e] = p;
          dpt[nt][e] = p * (dpt[nt][e] - sD[qi]);
        }
      // dV += P^T dO, dK += dS^T Q (the queries are the k of these products)
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        uint32_t ap[4], as[4];
        acc_to_a(st[2 * kk], st[2 * kk + 1], ap);
        acc_to_a(dpt[2 * kk], dpt[2 * kk + 1], as);
#pragma unroll
        for (int nd = 0; nd < KS; ++nd) {
          uint32_t bo[4], bq[4];
          ld_b_t<RS>(sdO, kk * 16, nd * 16, bo);
          ld_b_t<RS>(sQ, kk * 16, nd * 16, bq);
          mma16816(dv[2 * nd], ap, bo[0], bo[1]);
          mma16816(dv[2 * nd + 1], ap, bo[2], bo[3]);
          mma16816(dk[2 * nd], as, bq[0], bq[1]);
          mma16816(dk[2 * nd + 1], as, bq[2], bq[3]);
        }
      }
    }
  }
  bf16* dkb = a.dk + b * a.sdk.b + kh * a.sdk.h;
  bf16* dvb = a.dv + b * a.sdv.b + kh * a.sdv.h;
#pragma unroll
  for (int nd = 0; nd < 2 * KS; ++nd) {
    const int col = nd * 8 + 2 * t;
    if (col >= a.D) continue;
    if (key_a < a.S) {
      *reinterpret_cast<uint32_t*>(dkb + key_a * a.sdk.s + col) =
          pack_bf16(dk[nd][0] * a.scale, dk[nd][1] * a.scale);
      *reinterpret_cast<uint32_t*>(dvb + key_a * a.sdv.s + col) = pack_bf16(dv[nd][0], dv[nd][1]);
    }
    if (key_b < a.S) {
      *reinterpret_cast<uint32_t*>(dkb + key_b * a.sdk.s + col) =
          pack_bf16(dk[nd][2] * a.scale, dk[nd][3] * a.scale);
      *reinterpret_cast<uint32_t*>(dvb + key_b * a.sdv.s + col) = pack_bf16(dv[nd][2], dv[nd][3]);
    }
  }
}

template <int KS>
__global__ void __launch_bounds__(kBwdThreads) fa_bwd_dq_kernel(const BwdArgs a) {
  constexpr int DP = 16 * KS, RS = DP + 8;
  constexpr int T = kBwdRows * RS * 2;  // tile bytes
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t sQ = smem_addr(smem_raw), sdO = sQ + T, sK = sdO + T, sV = sK + T;
  const int qt = gridDim.x - 1 - blockIdx.x;  // the far end of the diagonal first
  const int h = blockIdx.y, b = blockIdx.z, kh = h / (a.H / a.KH);
  const int q0 = qt * kBwdRows;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  load_tile<DP>(sQ, a.q + b * a.sq.b + h * a.sq.h, a.sq.s, q0, kBwdRows, a.S, a.D);
  load_tile<DP>(sdO, a.dout + b * a.sdo.b + h * a.sdo.h, a.sdo.s, q0, kBwdRows, a.S, a.D);
  cp_async_commit();
  const int row_a = q0 + warp * 16 + g, row_b = row_a + 8;
  const float* lrow = a.lse + (static_cast<int64_t>(b) * a.H + h) * a.S;
  const float* drow = a.delta + (static_cast<int64_t>(b) * a.H + h) * a.S;
  const float lse_a = row_a < a.S ? lrow[row_a] * kLog2e : 0.0f;
  const float lse_b = row_b < a.S ? lrow[row_b] * kLog2e : 0.0f;
  const float dl_a = row_a < a.S ? drow[row_a] : 0.0f;
  const float dl_b = row_b < a.S ? drow[row_b] : 0.0f;
  const float sl2 = a.scale * kLog2e;
  const bf16* kb = a.k + b * a.sk.b + kh * a.sk.h;
  const bf16* vb = a.v + b * a.sv.b + kh * a.sv.h;
  float dq[2 * KS][4];
#pragma unroll
  for (int i = 0; i < 2 * KS; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[i][e] = 0.0f;
  const int n_kt = min((a.S + kBwdRows - 1) / kBwdRows, qt + 1);  // causal, Sq == Sk
  for (int kt = 0; kt < n_kt; ++kt) {
    __syncthreads();  // every warp is done with the previous K/V tiles
    load_tile<DP>(sK, kb, a.sk.s, kt * kBwdRows, kBwdRows, a.S, a.D);
    load_tile<DP>(sV, vb, a.sv.s, kt * kBwdRows, kBwdRows, a.S, a.D);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    // S = Q_w K^T and dP = dO_w V^T, 16 queries x 64 keys a warp
    float s[8][4], dp[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[i][e] = dp[i][e] = 0.0f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      uint32_t aq[4], ao[4];
      ld_a<RS>(sQ, warp * 16, ks, aq);
      ld_a<RS>(sdO, warp * 16, ks, ao);
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t bk[4], bv[4];
        ld_b<RS>(sK, np * 16, ks, bk);
        ld_b<RS>(sV, np * 16, ks, bv);
        mma16816(s[2 * np], aq, bk[0], bk[1]);
        mma16816(s[2 * np + 1], aq, bk[2], bk[3]);
        mma16816(dp[2 * np], ao, bv[0], bv[1]);
        mma16816(dp[2 * np + 1], ao, bv[2], bv[3]);
      }
    }
    // dS = P (dP - Delta), P = exp(s - lse) where key <= row < S
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = e < 2 ? row_a : row_b;
        const int key = kt * kBwdRows + nt * 8 + 2 * t + (e & 1);
        const float p = row < a.S && key <= row
                            ? exp2f(s[nt][e] * sl2 - (e < 2 ? lse_a : lse_b)) : 0.0f;
        s[nt][e] = p * (dp[nt][e] - (e < 2 ? dl_a : dl_b));
      }
    // dQ += dS K (the keys are the k of this product)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t as[4];
      acc_to_a(s[2 * kk], s[2 * kk + 1], as);
#pragma unroll
      for (int nd = 0; nd < KS; ++nd) {
        uint32_t bk[4];
        ld_b_t<RS>(sK, kk * 16, nd * 16, bk);
        mma16816(dq[2 * nd], as, bk[0], bk[1]);
        mma16816(dq[2 * nd + 1], as, bk[2], bk[3]);
      }
    }
  }
  bf16* dqb = a.dq + b * a.sdq.b + h * a.sdq.h;
#pragma unroll
  for (int nd = 0; nd < 2 * KS; ++nd) {
    const int col = nd * 8 + 2 * t;
    if (col >= a.D) continue;
    if (row_a < a.S)
      *reinterpret_cast<uint32_t*>(dqb + row_a * a.sdq.s + col) =
          pack_bf16(dq[nd][0] * a.scale, dq[nd][1] * a.scale);
    if (row_b < a.S)
      *reinterpret_cast<uint32_t*>(dqb + row_b * a.sdq.s + col) =
          pack_bf16(dq[nd][2] * a.scale, dq[nd][3] * a.scale);
  }
}

template <int KS>
int launch_bwd(const BwdArgs& a, int B, cudaStream_t st) {
  constexpr int RS = 16 * KS + 8;
  constexpr int dq_smem = 4 * kBwdRows * RS * 2;
  constexpr int kv_smem = 2 * kBwdRows * RS * 2 + 2 * kBwdQ * RS * 2 + 2 * kBwdQ * 4;
  static bool attr_set[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= kMaxDevices || !attr_set[dev]) {
    err = cudaFuncSetAttribute(fa_bwd_dq_kernel<KS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               dq_smem);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(fa_bwd_dkdv_kernel<KS>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, kv_smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dev < kMaxDevices) attr_set[dev] = true;
  }
  const int64_t n_rows = static_cast<int64_t>(B) * a.H * a.S;
  fa_bwd_delta_kernel<<<static_cast<unsigned>((n_rows + 7) / 8), 256, 0, st>>>(a, n_rows);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_tiles = (a.S + kBwdRows - 1) / kBwdRows;
  fa_bwd_dkdv_kernel<KS><<<dim3(n_tiles, a.KH, B), kBwdThreads, kv_smem, st>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  fa_bwd_dq_kernel<KS><<<dim3(n_tiles, a.H, B), kBwdThreads, dq_smem, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// the bf16 forward through `fa_forward`'s maps; LSE: the training instance
template <bool LSE>
int forward_bf16(const void* q, const void* k, const void* v, void* o, Strides sq, Strides sk,
                 Strides sv, Strides so, int B, int H, int KH, int Sq, int Sk, int D,
                 float scale, int causal, float* lse, cudaStream_t st) {
  CUtensorMap maps[4];
  if (!encode(&maps[0], q, D, H, Sq, B, sq) || !encode(&maps[1], k, D, KH, Sk, B, sk) ||
      !encode(&maps[2], v, D, KH, Sk, B, sv) || !encode(&maps[3], o, D, H, Sq, B, so))
    return static_cast<int>(cudaErrorInvalidValue);
  switch ((D + 15) / 16) {
    case 1: return launch<16, LSE>(maps, B, H, KH, Sq, Sk, scale, causal, lse, st);
    case 2: return launch<32, LSE>(maps, B, H, KH, Sq, Sk, scale, causal, lse, st);
    case 3: return launch<48, LSE>(maps, B, H, KH, Sq, Sk, scale, causal, lse, st);
    case 4: return launch<64, LSE>(maps, B, H, KH, Sq, Sk, scale, causal, lse, st);
    case 5: return launch<80, LSE>(maps, B, H, KH, Sq, Sk, scale, causal, lse, st);
    case 6: return launch<96, LSE>(maps, B, H, KH, Sq, Sk, scale, causal, lse, st);
    case 7: return launch<112, LSE>(maps, B, H, KH, Sq, Sk, scale, causal, lse, st);
    case 8: return launch<128, LSE>(maps, B, H, KH, Sq, Sk, scale, causal, lse, st);
    default:
      if constexpr (LSE) return static_cast<int>(cudaErrorInvalidValue);  // D <= 128 only
      else return launch<192, LSE>(maps, B, H, KH, Sq, Sk, scale, causal, lse, st);
  }
}

}  // namespace

extern "C" int fa_forward(const void* q, const void* k, const void* v, void* o,
                          int64_t sqb, int64_t sqh, int64_t sqs,
                          int64_t skb, int64_t skh, int64_t sks,
                          int64_t svb, int64_t svh, int64_t svs,
                          int64_t sob, int64_t soh, int64_t sos,
                          int B, int H, int KH, int Sq, int Sk, int D, float scale,
                          int causal, void* stream) {
  if (D < 8 || D > kMaxD || D % 8 != 0 || KH < 1 || H % KH != 0 || Sq < 1 || Sk < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  return forward_bf16<false>(q, k, v, o, Strides{sqb, sqh, sqs}, Strides{skb, skh, sks},
                             Strides{svb, svh, svs}, Strides{sob, soh, sos}, B, H, KH, Sq, Sk,
                             D, scale, causal, nullptr, static_cast<cudaStream_t>(stream));
}

// The training forward: fa_forward's arguments, D <= 128, and `lse`, an f32
// (B, H, Sq) output of each query row's log-sum-exp (natural base) of its
// scaled, masked scores.
extern "C" int fa_forward_lse(const void* q, const void* k, const void* v, void* o,
                              int64_t sqb, int64_t sqh, int64_t sqs,
                              int64_t skb, int64_t skh, int64_t sks,
                              int64_t svb, int64_t svh, int64_t svs,
                              int64_t sob, int64_t soh, int64_t sos,
                              int B, int H, int KH, int Sq, int Sk, int D, float scale,
                              int causal, void* lse, void* stream) {
  if (D < 8 || D > kBwdMaxD || D % 8 != 0 || KH < 1 || H % KH != 0 || Sq < 1 || Sk < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  return forward_bf16<true>(q, k, v, o, Strides{sqb, sqh, sqs}, Strides{skb, skh, sks},
                            Strides{svb, svh, svs}, Strides{sob, soh, sos}, B, H, KH, Sq, Sk,
                            D, scale, causal, static_cast<float*>(lse),
                            static_cast<cudaStream_t>(stream));
}

// The backward of causal bf16 attention with Sq == Sk == S: dq, dk, dv
// (each at its own strides, head_dim contiguous) from q, k, v, the forward's
// o and lse, and dout.  delta: an f32 (B, H, S) scratch.  Rows of q, k, v,
// o and dout must be 16-byte aligned (D a multiple of 8, every stride a
// multiple of 8 elements); D <= 128.
extern "C" int fa_backward(const void* q, const void* k, const void* v, const void* o,
                           const void* dout, void* dq, void* dk, void* dv, const void* lse,
                           void* delta,
                           int64_t sqb, int64_t sqh, int64_t sqs,
                           int64_t skb, int64_t skh, int64_t sks,
                           int64_t svb, int64_t svh, int64_t svs,
                           int64_t sob, int64_t soh, int64_t sos,
                           int64_t sgb, int64_t sgh, int64_t sgs,
                           int64_t sdqb, int64_t sdqh, int64_t sdqs,
                           int64_t sdkb, int64_t sdkh, int64_t sdks,
                           int64_t sdvb, int64_t sdvh, int64_t sdvs,
                           int B, int H, int KH, int S, int D, float scale, void* stream) {
  if (D < 8 || D > kBwdMaxD || D % 8 != 0 || KH < 1 || H % KH != 0 || S < 1 || B < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  BwdArgs a;
  a.q = static_cast<const bf16*>(q);
  a.k = static_cast<const bf16*>(k);
  a.v = static_cast<const bf16*>(v);
  a.o = static_cast<const bf16*>(o);
  a.dout = static_cast<const bf16*>(dout);
  a.dq = static_cast<bf16*>(dq);
  a.dk = static_cast<bf16*>(dk);
  a.dv = static_cast<bf16*>(dv);
  a.lse = static_cast<const float*>(lse);
  a.delta = static_cast<float*>(delta);
  a.sq = Strides{sqb, sqh, sqs};
  a.sk = Strides{skb, skh, sks};
  a.sv = Strides{svb, svh, svs};
  a.so = Strides{sob, soh, sos};
  a.sdo = Strides{sgb, sgh, sgs};
  a.sdq = Strides{sdqb, sdqh, sdqs};
  a.sdk = Strides{sdkb, sdkh, sdks};
  a.sdv = Strides{sdvb, sdvh, sdvs};
  a.H = H;
  a.KH = KH;
  a.S = S;
  a.D = D;
  a.scale = scale;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch ((D + 15) / 16) {
    case 1: return launch_bwd<1>(a, B, st);
    case 2: return launch_bwd<2>(a, B, st);
    case 3: return launch_bwd<3>(a, B, st);
    case 4: return launch_bwd<4>(a, B, st);
    case 5: return launch_bwd<5>(a, B, st);
    case 6: return launch_bwd<6>(a, B, st);
    case 7: return launch_bwd<7>(a, B, st);
    default: return launch_bwd<8>(a, B, st);
  }
}

// The f32 route: same arguments as fa_forward, f32 tensors at any stride
// with a unit head_dim stride.
extern "C" int fa_forward_f32(const void* q, const void* k, const void* v, void* o,
                              int64_t sqb, int64_t sqh, int64_t sqs,
                              int64_t skb, int64_t skh, int64_t sks,
                              int64_t svb, int64_t svh, int64_t svs,
                              int64_t sob, int64_t soh, int64_t sos,
                              int B, int H, int KH, int Sq, int Sk, int D, float scale,
                              int causal, void* stream) {
  if (D < 1 || D > kMaxD || KH < 1 || H % KH != 0 || B < 1 || Sq < 1 || Sk < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  F32Args a;
  a.q = static_cast<const float*>(q);
  a.k = static_cast<const float*>(k);
  a.v = static_cast<const float*>(v);
  a.o = static_cast<float*>(o);
  a.sq = Strides{sqb, sqh, sqs};
  a.sk = Strides{skb, skh, sks};
  a.sv = Strides{svb, svh, svs};
  a.so = Strides{sob, soh, sos};
  a.H = H;
  a.KH = KH;
  a.Sq = Sq;
  a.Sk = Sk;
  a.D = D;
  a.Dp = (D + 3) / 4 * 4;
  a.scale_log2 = scale * kLog2e;
  a.causal = causal;
  const bool vec =
      D % 4 == 0 && rows_aligned(k, a.sk, B, KH, Sk) && rows_aligned(v, a.sv, B, KH, Sk);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch ((a.Dp + 15) / 16) {
    case 1: return launch_f32<1>(a, B, vec, st);
    case 2: return launch_f32<2>(a, B, vec, st);
    case 3: return launch_f32<3>(a, B, vec, st);
    case 4: return launch_f32<4>(a, B, vec, st);
    case 5: return launch_f32<5>(a, B, vec, st);
    case 6: return launch_f32<6>(a, B, vec, st);
    case 7: return launch_f32<7>(a, B, vec, st);
    case 8: return launch_f32<8>(a, B, vec, st);
    default: return launch_f32<12>(a, B, vec, st);  // (128, 192]
  }
}
