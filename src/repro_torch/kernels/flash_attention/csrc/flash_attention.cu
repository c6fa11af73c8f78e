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
// Bound on the card: bytes at the serving shapes, operations at the long
// prefills.  At the serving shape (8, 32, 128, 80) the four tensors are
// 21.0 MB, 6.26 us at 3.35 TB/s, against 0.68 GFLOP of causal products,
// 0.68 us at the bf16 tensor-core peak; at llava-next-34b's prefill (2,
// 3008, 56/8, 128) 259.5 GFLOP, 262.4 us, against 92 MB.
//
// Design (warp-specialised, as FA3 shapes it for Hopper):
//  - a work item is 128 query rows of one (head, batch): two consumer
//    warpgroups of 64 rows each share every K/V tile.  The grid is
//    persistent, one block an SM walking the items in turn; the K/V ring
//    and the barriers' phases run on across items, so the producer loads an
//    item's Q and K/V while the consumers finish the one before;
//  - the work order (`item_at`): chunks of (batch, head) pairs, heads of a
//    KV head adjacent, as many as keep the chunk's K and V within 24 MB
//    (half the L2); in each chunk the query blocks with the most K/V tiles
//    (the far end of the causal diagonal) first.  A head's K and V then stay
//    in L2 while its query blocks come round (at deepseek-v3's MLA, G = 1,
//    335 MB of K and V at its training shape) one chunk of every pair read
//    them again from HBM for each query block: 635 against 421 us).
//    Where the order is one chunk, every other wave hands the blocks its
//    items in reverse, so a block that drew a long item draws a short one;
//  - one producer warp's lane 0 issues TMA loads through rank-4 tensor maps
//    (columns, heads, seq, batch), built on the host from the tensors'
//    strides, so the model's (B, T, H, D) tensors are read in place: Q into
//    a tile per consumer (full/empty mbarriers), K and V tiles into a ring
//    (full/empty mbarriers), 64 keys a tile, or 128 for a non-causal call
//    up to head_dim 64 with both warpgroups busy (`forward_choice`: half
//    the waits, shuffles and rescales a key; seamless's encoder 62 against
//    57 us);
//  - v and the output at their own width Dv: an instance (DP, DVP) pads
//    head_dim and Dv each to a multiple of 16, or past 128 to 192; the
//    instances are (DP, DP) and MLA's (192, 128) (q and k 128 + 64 of rope
//    beside 128-wide values), the backward's set (`instance`), so no v is
//    ever padded in device memory;
//  - columns are cut into 64-column panels (128 bytes, the widest a
//    128B-swizzled TMA box may be): D = 80 is one full panel plus one whose
//    columns 80-127 TMA fills with zeros (no bytes read for them);
//  - S = Q.K^T runs as m64nKEYSk16 `wgmma`s, A (Q) and B (K) both K-major
//    in shared memory, one k-step of 16 columns at a time (the descriptor's
//    start moves 32 bytes inside the swizzle atom);
//  - the softmax runs on the f32 accumulator in registers (four threads a
//    row pair, as mma.sync's layout), and P, packed to bf16, is directly
//    the register A operand of O += P.V, m64nDVPk16 `wgmma`s whose B is V
//    as it lies (MN-major, the transpose bit set): V is never transposed;
//  - the tensor cores and the softmax overlap (DVP <= 128), FA3's two ways.
//    Within a warpgroup: tile t's S = Q.K^T and tile t-1's P.V are issued
//    together, and the softmax of tile t runs as soon as S is done
//    (`wgmma.wait_group 1`) while P.V still runs; O is rescaled and P_t
//    packed after it.  S (KEYS/2 registers a thread) and P_{t-1} (KEYS/4)
//    are both live across the softmax, beside DVP/2 of O.  Between the
//    warpgroups (ping-pong, `forward_choice`: only where both are busy and
//    the longest item walks 1024 keys or more): two named barriers hand the
//    turn to issue products from one warpgroup to the other, so one's
//    products run while the other's softmax does.  At DVP 192 O alone takes
//    96 registers and both sets do not fit the 168 a thread of this block
//    has (its nine warps share the SM's four register partitions, three to
//    one: 3 x 32 x 168 <= 16,384), so that instance runs each tile's S,
//    softmax and P.V in turn, as does a launch whose blocks each walk one
//    item of at most two tiles;
//  - `ptxas` serialises every `wgmma` (an arrive and a wait around each)
//    unless it can see that the issuing code is not divergent and that
//    each `wait_group` retires the same groups on every path: the warp
//    index is broadcast from lane 0 (C7520 otherwise; the serial loop of
//    single short walks keeps the plain index, faster there), and the
//    overlapped loop issues a prologue (S of the first tile), steady rounds
//    that always commit two groups, and an epilogue (the last P.V), with no
//    product issued under a condition (C7514 otherwise);
//  - K/V tiles above a consumer's diagonal are skipped, and the keys of a
//    tile that reaches past Sk are masked explicitly: TMA zero-fills the rows
//    past the end, and a zero key scores 0, not -1e30;
//  - the output is staged in shared memory in the 128B-swizzled layout and
//    written by TMA stores through a fourth map, which clip rows past Sq.
// With 64-key tiles every launch choice (serial or overlapped, with or
// without turns, in chunks or not) runs each tile's arithmetic in the same
// order, so their outputs are bit-equal (each was so checked on the card
// against the others when it was designed: PERF.md section 6).
// Shared memory (`FwdSmem`): two Q tiles and two output staging tiles (64
// rows), and the K and V rings (KEYS rows), each of every panel of its
// width.  Up to head_dim 128 (16 KB a 64-row tile) a four-stage ring makes
// 192 KB; at (192, 128) three stages (Q and K tiles 24 KB, V and O 16 KB)
// make 200 KB; at (192, 192) two stages, 192 KB (three would pass the 227
// KB a block may have).  `ops.forward_plan` computes the same launch shape
// in Python (`fa_forward_plan` reports the source's, for a card test).
// The shared-memory attribute is set once per template instance and device.
// Times: PERF.md section 6 (chip_smoke.py phase 2, in turns with an older
// tree under `--parent`).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "wgmma.cuh"


namespace {

constexpr int kRows = 64;        // query rows per consumer warpgroup (and the backward's key tiles)
constexpr int kConsumers = 2;    // consumer warpgroups per block
constexpr int kThreads = kConsumers * 128 + 32;  // plus one producer warp
constexpr int kPanelCols = 64;   // bf16 columns per 128-byte swizzled panel
constexpr int kPanelBytes = kRows * 128;
constexpr int kMaxD = 192;       // three panels
constexpr int kRegCols = 128;    // accumulator columns a consumer keeps in registers
constexpr int kMaxSmem = 232448; // dynamic shared memory a block may have
constexpr int kMaxDevices = 64;  // devices whose attribute and SM count are kept
constexpr float kNegInf = -1e30f;
constexpr int kNoQuery = 0x7fffffff;  // a first query no row reaches
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr int kTurnKeys = 1024;  // keys the longest item walks before the warpgroups take turns
// the bytes of K and V a chunk of the forward's work items may read: half
// the H100's 50 MB L2, so a head's K and V stay there while its query
// blocks come round
constexpr int64_t kChunkBytes = 24ll << 20;

__host__ __device__ constexpr int panels(int dp) { return (dp + kPanelCols - 1) / kPanelCols; }
// head_dim as the kernels take it: a multiple of 16 up to 128, else 192
__host__ __device__ constexpr int padded_dim(int d) { return d <= 128 ? (d + 15) / 16 * 16 : kMaxD; }


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
// until at most N of this warpgroup's committed groups are pending (groups
// complete in the order they were committed)
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ void wgmma_wait_all() { wgmma_wait<0>(); }
// keep the compiler from moving accumulator reads or writes across the
// asynchronous wgmma
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
// the same for a register A operand, which a wgmma reads until it completes
template <int K>
__device__ __forceinline__ void fence_frag(uint32_t (&a)[K][4]) {
#pragma unroll
  for (int i = 0; i < K; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[i][j])::"memory");
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

// The forward's ping-pong: consumer warpgroup c issues its products after
// `turn_wait(c)` and hands the turn to the other with `turn_pass(1 - c)`
// (named barriers 3 and 4, each met by 128 threads waiting and 128
// arriving)
__device__ __forceinline__ void turn_wait(int c) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(3 + c) : "memory");
}
__device__ __forceinline__ void turn_pass(int c) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(3 + c) : "memory");
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

// the forward's shared memory at (DP, DVP) with K/V tiles of KEYS keys: a
// Q tile and an output staging tile (64 rows each) per consumer, then the
// K and V rings (see the note above)
template <int DP, int DVP, int KEYS>
struct FwdSmem {
  static constexpr int kStages = DVP > kRegCols ? 2 : DP > kRegCols ? 3 : 4;  // ring depth
  static constexpr int kKeys = KEYS;
  static constexpr int kKPanel = kKeys * 128;               // one panel of a K or V tile
  static constexpr int kTile = panels(DP) * kPanelBytes;    // a Q tile
  static constexpr int kOTile = panels(DVP) * kPanelBytes;  // an output staging tile
  static constexpr int kKTile = panels(DP) * kKPanel;       // a K tile
  static constexpr int kVTile = panels(DVP) * kKPanel;      // a V tile
  static constexpr int kQ = 0;
  static constexpr int kO = kQ + kConsumers * kTile;
  static constexpr int kK = kO + kConsumers * kOTile;
  static constexpr int kV = kK + kStages * kKTile;
  static constexpr int kBars = kV + kStages * kVTile;  // q_full, q_empty, full[], empty[]
  static constexpr int kBytes = kBars + 8 * (2 + 2 * kStages) + 1024;  // + alignment slack
  static_assert(kBytes <= kMaxSmem, "more shared memory than a block may have");
};

// A work item is 128 query rows of one (head, batch).  The items come in
// chunks of `chunk` (batch, head) pairs, heads fastest; within a chunk,
// item w takes query block n_qb - 1 - w / pairs, so its items with the
// most K/V tiles come first.  Its K/V tiles of KEYS keys are all
// ceil(Sk / KEYS) of them, or under the causal mask those up to its last
// row's (no further than Sk).  One chunk of all H * B pairs is the order
// longest first throughout.
struct Item {
  int q0, h, b, n_tiles, n_active;
};
template <int KEYS>
__device__ __forceinline__ Item item_at(int w, int H, int B, int Sq, int Sk, int causal,
                                        int chunk) {
  const int n_qb = (Sq + kConsumers * kRows - 1) / (kConsumers * kRows);
  int r = w, pairs = H * B, pair;
  if (chunk < H * B) {  // (one chunk spares the producer two divisions before its first load)
    const int ci = w / (chunk * n_qb);
    r = w - ci * chunk * n_qb;
    pairs = min(chunk, H * B - ci * chunk);  // the last chunk may be short
    pair = ci * chunk + r % pairs;
  } else {
    pair = w % pairs;
  }
  Item it;
  it.q0 = (n_qb - 1 - r / pairs) * (kConsumers * kRows);
  it.h = pair % H;
  it.b = pair / H;
  const int n_kv = (Sk + KEYS - 1) / KEYS;
  const int last_row = min(it.q0 + kConsumers * kRows, Sq) - 1;
  it.n_tiles = causal ? min(n_kv, last_row / KEYS + 1) : n_kv;
  it.n_active = min(kConsumers, (Sq - it.q0 + kRows - 1) / kRows);
  return it;
}

// One K/V tile's online-softmax step on a warp's rows row_a and row_b =
// row_a + 8 (four threads a row pair; r0 the warpgroup's first row): the
// N scores a row in s are scaled into the exp2 domain and masked (keys past Sk,
// and under the causal mask keys past the row), the running maxima move to
// the tile's, s becomes exp2(s - m), and this thread's share of the running
// sums is rescaled and added to (the quad is summed at the end).  Returns
// in corr_a, corr_b the factors that rescale O's rows.
template <int N>
__device__ __forceinline__ void softmax_step(float (&s)[N / 2], float& m_a, float& m_b,
                                             float& l_a, float& l_b, float& corr_a,
                                             float& corr_b, int k0, int r0, int row_a, int row_b,
                                             int tq, int Sk, int causal, float scale_log2) {
  const bool need_mask = k0 + N > Sk || (causal && k0 + N - 1 > r0);
  float mx_a = kNegInf, mx_b = kNegInf;
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float sa = s[4 * j + e] * scale_log2, sb = s[4 * j + 2 + e] * scale_log2;
      if (need_mask) {
        const int col = k0 + 8 * j + 2 * tq + e;
        const bool ok = col < Sk;
        sa = (ok && (!causal || col <= row_a)) ? sa : kNegInf;
        sb = (ok && (!causal || col <= row_b)) ? sb : kNegInf;
      }
      s[4 * j + e] = sa;
      s[4 * j + 2 + e] = sb;
      mx_a = fmaxf(mx_a, sa);
      mx_b = fmaxf(mx_b, sb);
    }
  }
  mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, 1));
  mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, 2));
  mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, 1));
  mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, 2));
  const float mn_a = fmaxf(m_a, mx_a), mn_b = fmaxf(m_b, mx_b);
  corr_a = exp2f(m_a - mn_a);
  corr_b = exp2f(m_b - mn_b);
  m_a = mn_a;
  m_b = mn_b;
  float ps_a = 0.0f, ps_b = 0.0f;
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      s[4 * j + e] = exp2f(s[4 * j + e] - mn_a);
      s[4 * j + 2 + e] = exp2f(s[4 * j + 2 + e] - mn_b);
      ps_a += s[4 * j + e];
      ps_b += s[4 * j + 2 + e];
    }
  }
  l_a = l_a * corr_a + ps_a;
  l_b = l_b * corr_b + ps_b;
}

// O's rows times their factors (skipping the multiply where a warp's
// factors are all 1, bit-exact, measured slower: the vote and branch cost
// more than the multiplies, 14.835 against 14.282 us at a ragged LSE row)
template <int N>
__device__ __forceinline__ void rescale(float (&o)[N], float corr_a, float corr_b) {
#pragma unroll
  for (int j = 0; j < N / 4; ++j) {
    o[4 * j] *= corr_a;
    o[4 * j + 1] *= corr_a;
    o[4 * j + 2] *= corr_b;
    o[4 * j + 3] *= corr_b;
  }
}

// P in bf16 as the A operand of P.V: score columns 16kk..16kk+15 are the
// A fragment of k-step kk
template <int N>
__device__ __forceinline__ void pack_p(uint32_t (&pa)[N / 16][4], const float (&s)[N / 2]) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk) {
    pa[kk][0] = pack_bf16(s[8 * kk], s[8 * kk + 1]);
    pa[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
    pa[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
    pa[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
  }
}

// S = Q . K^T (64 x N, f32) on one K tile of N keys, uncommitted
template <int DP, int N>
__device__ __forceinline__ void issue_s(float (&s)[N / 2], uint32_t q_tile, uint32_t k_tile) {
#pragma unroll
  for (int j = 0; j < DP / 16; ++j) {
    const uint32_t col = (j % 4) * 32;  // bytes into the panel's 128-byte rows
    Wgmma<N>::ss(s, sw128_desc(q_tile + (j / 4) * kPanelBytes + col, 16, 1024),
                 sw128_desc(k_tile + (j / 4) * N * 128 + col, 16, 1024), j > 0);
  }
}

// O += P . V on one V tile of N keys (its panels N rows apart), uncommitted
template <int DVP, int N>
__device__ __forceinline__ void issue_pv(float (&o)[DVP / 2], uint32_t (&pa)[N / 16][4],
                                         uint32_t v_tile) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk)
    Wgmma<DVP>::rs(o, pa[kk], sw128_desc(v_tile + kk * 16 * 128, N * 128, 1024), 1);
}

// DP: head_dim rounded up to a multiple of 16 (the wgmma k-step), or 192
// past 128; DVP: v's width so rounded (DP, or 128 beside 192).  LSE: also
// store each query row's log-sum-exp of its scaled scores, natural base,
// f32, at lse[(b H + h) Sq + row] (the training forward, `fa_forward_lse`;
// the backward recomputes P from it).  A persistent block walks the work
// items blockIdx.x, blockIdx.x + gridDim.x, ...; the K/V ring and the
// barriers' phases run on across items, so the producer loads the next
// item's Q and K/V while the consumers finish this one.  KEYS: keys a K/V
// tile; OVERLAP: the products overlap the softmax; TURNS: the two consumer
// warpgroups take turns to issue them (`forward_choice`).  Each is a
// compile-time choice: a branch on a run-time flag around the turns
// measured ~8% slower at the serve's shape even where the flag was off.
template <int DP, int DVP, int KEYS, bool LSE, bool OVERLAP, bool TURNS>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_kernel(const __grid_constant__ CUtensorMap tm_q,
                 const __grid_constant__ CUtensorMap tm_k,
                 const __grid_constant__ CUtensorMap tm_v,
                 const __grid_constant__ CUtensorMap tm_o, int H, int KH, int B, int Sq,
                 int Sk, float scale_log2, int causal, int chunk, float* __restrict__ lse) {
  using L = FwdSmem<DP, DVP, KEYS>;
  constexpr int kKeys = KEYS;
  constexpr bool kOverlap = OVERLAP, turns = TURNS;
  static_assert(!OVERLAP || DVP <= kRegCols, "O and both score sets must fit the registers");
  static_assert(!TURNS || OVERLAP, "turns are taken by the overlapped loop");
  extern __shared__ unsigned char smem_raw[];
  // 128B-swizzled tiles start on 1024-byte boundaries of the shared window
  const uint32_t base = (smem_addr(smem_raw) + 1023) & ~1023u;
  const uint32_t bar_q_full = base + L::kBars;
  const uint32_t bar_q_empty = bar_q_full + 8;
  const uint32_t bar_full = bar_q_empty + 8;          // + 8 * stage
  constexpr int kStages = L::kStages;
  const uint32_t bar_empty = bar_full + 8 * kStages;  // + 8 * stage
  const int n_items = (Sq + kConsumers * kRows - 1) / (kConsumers * kRows) * H * B;
  // the warp's index broadcast from lane 0: `ptxas` then knows it (and the
  // warpgroup's) is the same across the warp, so the branches on it that
  // gate the `wgmma`s are not divergent (else it serialises every `wgmma`,
  // C7520, and nothing overlaps).  The serial loop of a launch of single
  // short walks (DVP <= 128, `forward_choice`) keeps the plain index, which
  // measured faster there (the serve_pipeline example's 4.144 against 4.363
  // us)
  constexpr bool kUniformWarp = OVERLAP || DVP > kRegCols;
  const int warp =
      kUniformWarp ? __shfl_sync(0xffffffffu, threadIdx.x / 32, 0) : threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  // the block's n-th item, wave by wave; where the order is one chunk
  // (longest first throughout) the blocks' order is reversed in every other
  // wave, so a block that drew one of a wave's longest items draws one of
  // the next wave's shortest (in several chunks, whose lengths already
  // alternate, the reversal measured slower)
  const bool reverse_odd = chunk == H * B;
  const auto item_of = [&](int n) {
    const int g = static_cast<int>(gridDim.x), b = static_cast<int>(blockIdx.x);
    return n * g + ((n & 1) && reverse_odd ? g - 1 - b : b);
  };

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
    for (int n = 0;; ++n) {
      const int w = item_of(n);
      if (w >= n_items) break;
      const Item it = item_at<kKeys>(w, H, B, Sq, Sk, causal, chunk);
      const int kh = it.h / (H / KH);
      if (n > 0) mbar_wait(bar_q_empty, (n - 1) & 1);
      mbar_expect_tx(bar_q_full, it.n_active * L::kTile);
      for (int c = 0; c < it.n_active; ++c)
        for (int p = 0; p < panels(DP); ++p)
          tma_load(base + L::kQ + c * L::kTile + p * kPanelBytes, &tm_q, p * kPanelCols, it.h,
                   it.q0 + c * kRows, it.b, bar_q_full);
      for (int t = 0; t < it.n_tiles; ++t, ++tile) {
        const int s = tile % kStages;
        if (tile >= kStages) mbar_wait(bar_empty + 8 * s, (tile / kStages - 1) & 1);
        const uint32_t full = bar_full + 8 * s;
        mbar_expect_tx(full, L::kKTile + L::kVTile);
        // a panel of kKeys rows is kKeys / 64 boxes of 64 rows, 8 KB apart
        for (int h = 0; h < kKeys / kRows; ++h) {
          for (int p = 0; p < panels(DP); ++p)
            tma_load(base + L::kK + s * L::kKTile + p * L::kKPanel + h * kPanelBytes, &tm_k,
                     p * kPanelCols, kh, t * kKeys + h * kRows, it.b, full);
          for (int p = 0; p < panels(DVP); ++p)
            tma_load(base + L::kV + s * L::kVTile + p * L::kKPanel + h * kPanelBytes, &tm_v,
                     p * kPanelCols, kh, t * kKeys + h * kRows, it.b, full);
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
  const uint32_t o_tile = base + L::kO + c * L::kOTile;
  if (turns && c == 1) turn_pass(0);  // warpgroup 0 issues first
  int tile = 0;  // K/V tiles this block has walked so far
  for (int n = 0;; ++n) {
    const int w = item_of(n);
    if (w >= n_items) break;
    const Item it = item_at<kKeys>(w, H, B, Sq, Sk, causal, chunk);
    const int r0 = it.q0 + c * kRows;  // this warpgroup's first query row
    const int row_a = r0 + wi * 16 + lane / 4, row_b = row_a + 8;
    const bool active = c < it.n_active;
    // the last K/V tile this warpgroup reads: its last row's, under the causal mask
    const int my_last = !active ? -1
                        : causal ? min(it.n_tiles - 1, (min(r0 + kRows, Sq) - 1) / kKeys)
                                 : it.n_tiles - 1;

    float m_a = kNegInf, m_b = kNegInf, l_a = 0.0f, l_b = 0.0f, corr_a, corr_b;
    float oacc[DVP / 2];
#pragma unroll
    for (int i = 0; i < DVP / 2; ++i) oacc[i] = 0.0f;
    float sacc[kKeys / 2];
    uint32_t pa[kKeys / 16][4];

    mbar_wait(bar_q_full, n & 1);
    if (!active && lane == 0) mbar_arrive(bar_q_empty);
    if constexpr (kOverlap) {
      // n_tiles + 1 rounds in both warpgroups, whatever each skips (the
      // turns alternate): an active warpgroup's round 0 issues S of tile 0,
      // round t in 1..my_last S of tile t and P.V of tile t-1, round
      // my_last + 1 P.V of tile my_last; the rest issue nothing.  Each
      // steady round commits its two groups unconditionally, so `ptxas`
      // sees `wait_group 1` retire S on every path (a group count that
      // differs by path serialises every `wgmma`, C7514).
      const uint32_t k_ring = base + L::kK, v_ring = base + L::kV;
      int t = 0;
      if (active) {
        int s = tile % kStages;
        mbar_wait(bar_full + 8 * s, (tile / kStages) & 1);
        if (turns) turn_wait(c);
        fence_regs(sacc);
        wgmma_fence();
        issue_s<DP, kKeys>(sacc, q_tile, k_ring + s * L::kKTile);
        wgmma_commit();
        if (turns) turn_pass(1 - c);
        wgmma_wait<0>();
        fence_regs(sacc);
        if (my_last == 0 && lane == 0) mbar_arrive(bar_q_empty);
        softmax_step<kKeys>(sacc, m_a, m_b, l_a, l_b, corr_a, corr_b, 0, r0, row_a, row_b, tq,
                            Sk, causal, scale_log2);
        pack_p<kKeys>(pa, sacc);
        for (t = 1; t <= my_last; ++t) {
          const int seq = tile + t, sp = s;  // sp: tile t-1's stage
          s = seq % kStages;
          mbar_wait(bar_full + 8 * s, (seq / kStages) & 1);
          if (turns) turn_wait(c);
          fence_regs(sacc);
          fence_regs(oacc);
          fence_frag(pa);
          wgmma_fence();
          issue_s<DP, kKeys>(sacc, q_tile, k_ring + s * L::kKTile);
          wgmma_commit();
          issue_pv<DVP, kKeys>(oacc, pa, v_ring + sp * L::kVTile);
          wgmma_commit();
          if (turns) turn_pass(1 - c);
          wgmma_wait<1>();  // S is done; P.V may still run
          fence_regs(sacc);
          if (t == my_last && lane == 0) mbar_arrive(bar_q_empty);  // Q is free for the next item
          softmax_step<kKeys>(sacc, m_a, m_b, l_a, l_b, corr_a, corr_b, t * kKeys, r0, row_a,
                              row_b, tq, Sk, causal, scale_log2);
          wgmma_wait<0>();
          fence_regs(oacc);
          fence_frag(pa);
          __syncwarp();
          if (lane == 0) mbar_arrive(bar_empty + 8 * sp);  // tile t-1 is done with
          rescale(oacc, corr_a, corr_b);
          pack_p<kKeys>(pa, sacc);
        }
        // round my_last + 1: P.V of the last tile
        const int seq = tile + t;
        if (t < it.n_tiles) mbar_wait(bar_full + 8 * (seq % kStages), (seq / kStages) & 1);
        if (turns) turn_wait(c);
        fence_regs(oacc);
        fence_frag(pa);
        wgmma_fence();
        issue_pv<DVP, kKeys>(oacc, pa, v_ring + s * L::kVTile);
        wgmma_commit();
        if (turns) turn_pass(1 - c);
        wgmma_wait<0>();
        fence_regs(oacc);
        fence_frag(pa);
        __syncwarp();
        if (lane == 0) {
          mbar_arrive(bar_empty + 8 * s);
          if (t < it.n_tiles) mbar_arrive(bar_empty + 8 * (seq % kStages));  // skipped
        }
        ++t;
      }
      for (; t <= it.n_tiles; ++t) {  // rounds that issue nothing: tiles this warpgroup skips
        const int seq = tile + t;
        if (t < it.n_tiles) mbar_wait(bar_full + 8 * (seq % kStages), (seq / kStages) & 1);
        if (turns) {
          turn_wait(c);
          turn_pass(1 - c);
        }
        __syncwarp();
        if (t < it.n_tiles && lane == 0) mbar_arrive(bar_empty + 8 * (seq % kStages));
      }
    } else {
      // each tile's S, softmax and P.V in turn
      for (int t = 0; t < it.n_tiles; ++t) {
        const int seq = tile + t, s = seq % kStages;
        mbar_wait(bar_full + 8 * s, (seq / kStages) & 1);
        if (t <= my_last) {
          fence_regs(sacc);
          wgmma_fence();
          issue_s<DP, kKeys>(sacc, q_tile, base + L::kK + s * L::kKTile);
          wgmma_commit();
          wgmma_wait<0>();
          fence_regs(sacc);
          if (t == my_last && lane == 0) mbar_arrive(bar_q_empty);
          softmax_step<kKeys>(sacc, m_a, m_b, l_a, l_b, corr_a, corr_b, t * kKeys, r0, row_a,
                              row_b, tq, Sk, causal, scale_log2);
          rescale(oacc, corr_a, corr_b);
          pack_p<kKeys>(pa, sacc);
          fence_regs(oacc);
          wgmma_fence();
          issue_pv<DVP, kKeys>(oacc, pa, base + L::kV + s * L::kVTile);
          wgmma_commit();
          wgmma_wait<0>();
          fence_regs(oacc);
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(bar_empty + 8 * s);
      }
    }
    tile += it.n_tiles;
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
    for (int j = 0; j < DVP / 8; ++j) {
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
      for (int p = 0; p < panels(DVP); ++p)
        tma_store(&tm_o, o_tile + p * kPanelBytes, p * kPanelCols, it.h, r0, it.b);
      asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    }
  }
  if (turns && c == 0) turn_wait(0);  // the pass warpgroup 1 made in its last round
  if (leader) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// ----------------------------------------------------------- the f32 route
//
// f32 q, k and v (the Pallas kernel's f32 instance, held at 3e-5): CUDA-core
// f32 FMAs, since TF32 (10 mantissa bits) and two bf16 parts (~16) both miss
// that bound.  Bound on the card: operations at the model shapes (67 TFLOP/s
// of f32 FMAs), so the design is an SGEMM's: FA2's loop with register-tiled
// micro-kernels on the CUDA cores.
//  - A block of 256 threads takes 128 query rows of one (head, batch), or 64
//    when Sq <= 64 (seamless's cross-attention: 33 rows).  Warp w owns the
//    4 TM rows from 4 TM w on; its lane (ty, tx) (ty = lane / 8, tx = lane
//    % 8) owns rows ty + 4 i of them (TM of them), keys tx + 8 u of each
//    K/V tile (TN of them) and the 4-column chunks tx + 8 m of the output
//    (CV of them).
//  - Q is copied once into shared memory; K and V tiles of 64 keys (32 past
//    head_dim 128) stream through a three-buffer ring by `cp.async` (16-byte
//    copies where the rows are 16-byte aligned, 4-byte ones else, zeros past
//    Sk and past D), in the order K_0, V_0, K_1, ...: item n + 2 is issued
//    as item n starts, after the one barrier an item takes.
//  - S = Q.K^T: for each 4-column chunk of head_dim a thread reads TM rows
//    of Q and TN rows of K as float4s and does TM x TN x 4 FMAs (128 for 12
//    loads at TM 4, TN 8).  Rows in shared memory are an odd number of
//    16-byte chunks apart, so the 4 rows (or 8 keys) a warp reads at once
//    fall on distinct banks.
//  - The online softmax works on the thread's TM x TN scores, in base 2
//    with the scale folded into log2(e): the row max is reduced over the
//    8 lanes of a row (three shuffles a row, once a tile); each lane keeps
//    its own partial row sum, reduced once at the end.  Only tiles that
//    reach past Sk or above the causal diagonal are masked, and a warp
//    whose rows all lie above a tile's first key skips the tile.
//  - O += P.V: P goes through shared memory in f32 (the rows of a warp are
//    written and read by that warp only: a __syncwarp, no block barrier),
//    and each thread accumulates its TM x 4 CV slab of O in registers,
//    reading float4s of P (TM) and of V (CV a key).  v is read at its own
//    width Dv (MLA's 128 beside q and k of 192): nothing is padded.
//  - Work items in launch order: the query tiles with the most K/V tiles
//    first (far end of the causal diagonal), heads of one KV head adjacent.
// Shared memory: Q (rows x stride), the ring (3 x keys x stride), P (rows x
// (keys + 8)): 201 KB at D = 128, 192 KB at D = 192; one block an SM.
// `ops.f32_plan` computes the same launch shape in Python
// (`fa_forward_f32_plan` reports the source's, for a card test).

constexpr int kF32Threads = 256;
constexpr int kF32Lanes = 8;                             // threads of a query row
constexpr int kF32Groups = kF32Threads / kF32Lanes;      // row groups: 32
constexpr int kF32Stages = 3;                            // ring buffers
constexpr int kF32SmallSq = 64;                          // Sq up to this: 64 rows a block

struct F32Args {
  const float *q, *k, *v;
  float* o;
  Strides sq, sk, sv, so;
  int H, KH, B, Sq, Sk, D, Dv;
  int Dp, DVp;     // D and Dv rounded up to 4
  int qs, vs;      // shared-memory row strides (floats) of Q and K, and of V
  float scale_log2;
  int causal;
  int n_qt;        // query tiles
  int flags;       // 16-byte rows: bit 0 q, 1 k, 2 v, 3 o
};

// a row stride of Dp floats rounded up to an odd number of 16-byte chunks
constexpr int f32_stride(int dp) { return ((dp / 4) | 1) * 4; }

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

// `rows` rows of a tile into shared memory at `dst` (row stride `stride`
// floats), each row `cols` floats of global memory (padded to `cols_p`, a
// multiple of 4, with zeros), rows from `valid` on zero-filled.  vec:
// 16-byte copies (every row 16-byte aligned and cols == cols_p).
__device__ __forceinline__ void f32_tile(uint32_t dst, int stride, const float* src,
                                         int64_t src_stride, int rows, int valid, int cols,
                                         int cols_p, bool vec) {
  const int chunks = cols_p / 4;
  for (int idx = threadIdx.x; idx < rows * chunks; idx += kF32Threads) {
    const int r = idx / chunks, c = (idx - r * chunks) * 4;
    const bool ok = r < valid;
    const float* p = src + (ok ? r : 0) * src_stride;
    const uint32_t d = dst + (r * stride + c) * 4;
    if (vec) {
      cp_async<16>(d, p + c, ok ? 16 : 0);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool in = ok && c + e < cols;
        cp_async<4>(d + 4 * e, p + (in ? c + e : 0), in ? 4 : 0);
      }
    }
  }
}

__device__ __forceinline__ float f4_at(const float4& v, int e) {
  return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
}

// TM: query rows a thread (rows a block 32 TM); TN: keys a thread (keys a
// tile 8 TN); CV: 4-column output chunks a thread (Dv <= 32 CV)
template <int TM, int TN, int CV>
__global__ void __launch_bounds__(kF32Threads, 1) flash_f32_kernel(const F32Args a) {
  constexpr int kBr = kF32Groups * TM;
  constexpr int kBc = kF32Lanes * TN;
  constexpr int kPs = kBc + 8;  // P's row stride: 4 rows of a warp on distinct banks
  extern __shared__ __align__(16) float f32_smem[];
  float* qsm = f32_smem;
  float* ring = qsm + kBr * a.qs;
  float* psm = ring + kF32Stages * kBc * a.qs;
  const uint32_t q_addr = static_cast<uint32_t>(__cvta_generic_to_shared(qsm));
  const uint32_t ring_addr = static_cast<uint32_t>(__cvta_generic_to_shared(ring));

  const int hb = a.H * a.B;
  const int q0 = (a.n_qt - 1 - static_cast<int>(blockIdx.x) / hb) * kBr;
  const int rem = blockIdx.x % hb;
  const int h = rem % a.H, b = rem / a.H;
  const int kh = h / (a.H / a.KH);
  const int row_end = min(q0 + kBr, a.Sq);
  const int n_keys = a.causal ? min(a.Sk, row_end) : a.Sk;
  const int n_tiles = (n_keys + kBc - 1) / kBc;
  constexpr int kWarpRows = kBr / (kF32Threads / 32);  // 4 TM
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int tx = lane % kF32Lanes;
  const int ty = warp * kWarpRows + lane / kF32Lanes;  // row i of the thread: ty + 4 i
  const int warp_last = q0 + warp * kWarpRows + kWarpRows - 1;
  const float* kb = a.k + b * a.sk.b + kh * a.sk.h;
  const float* vb = a.v + b * a.sv.b + kh * a.sv.h;

  // item n: K of tile n / 2 (n even) or its V, into ring buffer n % 3
  auto issue = [&](int n) {
    const int j0 = (n / 2) * kBc;
    const uint32_t dst = ring_addr + (n % kF32Stages) * kBc * a.qs * 4;
    if (n % 2 == 0)
      f32_tile(dst, a.qs, kb + j0 * a.sk.s, a.sk.s, kBc, n_keys - j0, a.D, a.Dp, a.flags & 2);
    else
      f32_tile(dst, a.vs, vb + j0 * a.sv.s, a.sv.s, kBc, n_keys - j0, a.Dv, a.DVp, a.flags & 4);
  };
  f32_tile(q_addr, a.qs, a.q + b * a.sq.b + h * a.sq.h + static_cast<int64_t>(q0) * a.sq.s,
           a.sq.s, kBr, a.Sq - q0, a.D, a.Dp, a.flags & 1);
  issue(0);
  cp_async_commit();  // group 0: Q and K_0
  issue(1);
  cp_async_commit();  // group 1: V_0
  // at item n, groups 0..n+1 are committed: wait for n, and once every
  // thread is past item n - 1, refill its buffer with item n + 2
  auto stage = [&](int n) {
    cp_async_wait<1>();
    __syncthreads();
    if (n + 2 < 2 * n_tiles) issue(n + 2);
    cp_async_commit();
  };

  float4 acc[TM][CV];
  float m_run[TM], l_run[TM];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    m_run[i] = kNegInf;
    l_run[i] = 0.0f;
#pragma unroll
    for (int m = 0; m < CV; ++m) acc[i][m] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
  const int nvc = a.DVp / 4;  // v's 4-column chunks

  for (int c = 0; c < n_tiles; ++c) {
    const int j0 = c * kBc;
    // ------------------------------------------------ S = Q K^T (TM x TN)
    stage(2 * c);
    // every key of the tile above every row of this warp: nothing to add
    const bool skip = a.causal && j0 > warp_last;
    const float* ks = ring + ((2 * c) % kF32Stages) * kBc * a.qs;
    float s[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int u = 0; u < TN; ++u) s[i][u] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < (skip ? 0 : a.Dp); d += 4) {
      float4 qv[TM];
#pragma unroll
      for (int i = 0; i < TM; ++i)
        qv[i] = *reinterpret_cast<const float4*>(qsm + (ty + 4 * i) * a.qs + d);
#pragma unroll
      for (int u = 0; u < TN; ++u) {
        const float4 kv = *reinterpret_cast<const float4*>(ks + (tx + kF32Lanes * u) * a.qs + d);
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          s[i][u] = fmaf(qv[i].x, kv.x, s[i][u]);
          s[i][u] = fmaf(qv[i].y, kv.y, s[i][u]);
          s[i][u] = fmaf(qv[i].z, kv.z, s[i][u]);
          s[i][u] = fmaf(qv[i].w, kv.w, s[i][u]);
        }
      }
    }
    // ---------------------------------------------------- online softmax
    const bool masked = j0 + kBc > a.Sk || (a.causal && j0 + kBc - 1 > q0);
    if (!skip) {
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const int r = ty + 4 * i;
        float mx = kNegInf;
#pragma unroll
        for (int u = 0; u < TN; ++u) {
          float x = s[i][u] * a.scale_log2;
          if (masked) {
            const int j = j0 + tx + kF32Lanes * u;
            if (j >= a.Sk || (a.causal && j > q0 + r)) x = kNegInf;
          }
          s[i][u] = x;
          mx = fmaxf(mx, x);
        }
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
        const float m_new = fmaxf(m_run[i], mx);
        const float corr = exp2f(m_run[i] - m_new);
        m_run[i] = m_new;
        float ls = 0.0f;
#pragma unroll
        for (int u = 0; u < TN; ++u) {
          const float p = s[i][u] > kNegInf ? exp2f(s[i][u] - m_new) : 0.0f;
          ls += p;
          psm[r * kPs + tx + kF32Lanes * u] = p;
        }
        l_run[i] = l_run[i] * corr + ls;
#pragma unroll
        for (int m = 0; m < CV; ++m) {
          acc[i][m].x *= corr;
          acc[i][m].y *= corr;
          acc[i][m].z *= corr;
          acc[i][m].w *= corr;
        }
      }
    }
    __syncwarp();  // this warp's rows of P are written
    // ------------------------------------------------------ O += P V
    stage(2 * c + 1);
    const float* vs = ring + ((2 * c + 1) % kF32Stages) * kBc * a.qs;
#pragma unroll 4
    for (int j = 0; j < (skip ? 0 : kBc); j += 4) {
      float4 pv[TM];
#pragma unroll
      for (int i = 0; i < TM; ++i)
        pv[i] = *reinterpret_cast<const float4*>(psm + (ty + 4 * i) * kPs + j);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float* vrow = vs + (j + e) * a.vs;
#pragma unroll
        for (int m = 0; m < CV; ++m) {
          const int ch = tx + kF32Lanes * m;
          if (m < CV - 1 || ch < nvc) {
            const float4 vv = *reinterpret_cast<const float4*>(vrow + 4 * ch);
#pragma unroll
            for (int i = 0; i < TM; ++i) {
              const float p = f4_at(pv[i], e);
              acc[i][m].x = fmaf(p, vv.x, acc[i][m].x);
              acc[i][m].y = fmaf(p, vv.y, acc[i][m].y);
              acc[i][m].z = fmaf(p, vv.z, acc[i][m].z);
              acc[i][m].w = fmaf(p, vv.w, acc[i][m].w);
            }
          }
        }
      }
    }
    __syncwarp();  // this warp's reads of P are done before the next tile writes it
  }
  cp_async_wait<0>();

  const bool vec_o = a.flags & 8;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    float l = l_run[i];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    l += __shfl_xor_sync(0xffffffffu, l, 4);
    const int qi = q0 + ty + 4 * i;
    if (qi >= a.Sq) continue;
    const float den = fmaxf(l, 1e-30f);
    float* orow = a.o + b * a.so.b + h * a.so.h + static_cast<int64_t>(qi) * a.so.s;
#pragma unroll
    for (int m = 0; m < CV; ++m) {
      const int col = 4 * (tx + kF32Lanes * m);
      if (col >= a.Dv) continue;
      const float4 r = make_float4(acc[i][m].x / den, acc[i][m].y / den, acc[i][m].z / den,
                                   acc[i][m].w / den);
      if (vec_o) {
        *reinterpret_cast<float4*>(orow + col) = r;
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (col + e < a.Dv) orow[col + e] = f4_at(r, e);
      }
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

// the current device's context bound on this thread: `cuTensorMapEncodeTiled`
// needs it, and autograd's worker thread (the backward, remat's recomputed
// forward) may not have bound it yet (the runtime binds it lazily)
cudaError_t bind_device() {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  return err == cudaSuccess ? cudaSetDevice(dev) : err;
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

// the forward's work items (`item_at`): 128 query rows of one (head, batch)
int forward_items(int B, int H, int Sq) {
  return (Sq + kConsumers * kRows - 1) / (kConsumers * kRows) * H * B;
}

// (batch, head) pairs a chunk of the forward's items takes: whole groups
// of the G query heads that read one KV head, as many as keep the chunk's
// K and V (Sk rows, D + Dv columns a KV head) within kChunkBytes, at least
// one group, at most all H * B pairs
int forward_chunk(int B, int H, int KH, int Sk, int D, int Dv) {
  const int64_t kv = static_cast<int64_t>(Sk) * (D + Dv) * static_cast<int64_t>(sizeof(bf16));
  const int64_t groups = kChunkBytes / kv > 1 ? kChunkBytes / kv : 1;
  const int64_t pairs = groups * (H / KH);
  return pairs < static_cast<int64_t>(H) * B ? static_cast<int>(pairs) : H * B;
}

// The forward's launch choices at these shapes on n_sm SMs
// (`ops.forward_plan` makes the same from the same numbers):
//  - overlap: the products overlap the softmax, where O and both score
//    sets fit the registers (DVP <= 128), unless every block walks a single
//    item (items <= SMs) of at most two K/V tiles: there is nothing to
//    overlap across tiles then, and the overlapped loop measured slower on
//    such a walk (the serve_pipeline example's 4.55 against 4.30 us);
//  - keys: 128 a K/V tile for an overlapped, non-causal call up to head_dim
//    64 whose items hold two busy warpgroups (Sq past 64): half the waits,
//    shuffles and rescales a key (S of 128 columns, 64 registers a thread,
//    beside P's 32 and O's 32 at most); else 64 (under the causal mask a
//    tile of 128 keys wastes more on the diagonal, and past Sk, than it
//    saves);
//  - turns: the warpgroups take turns where both are busy and the longest
//    item walks kTurnKeys keys or more (its last row sees min(Sq, Sk) of
//    them under the causal mask); on shorter walks the turns cost more than
//    they gain;
//  - chunk: `forward_chunk`.
struct FwdChoice {
  int keys, overlap, turns, chunk, items, grid;
};
FwdChoice forward_choice(int B, int H, int KH, int Sq, int Sk, int D, int Dv, int causal,
                         int n_sm) {
  const int DP = padded_dim(D), DVP = padded_dim(Dv);
  const int longest = causal ? min(Sq, Sk) : Sk;  // keys the longest item walks
  FwdChoice c;
  c.items = forward_items(B, H, Sq);
  c.grid = min(c.items, n_sm);
  c.overlap = DVP <= kRegCols &&
              (c.items > n_sm || (longest + kRows - 1) / kRows > 2);
  c.keys = c.overlap && DP <= 64 && !causal && Sq > kRows ? 128 : kRows;
  c.turns = c.overlap && Sq > kRows && longest >= kTurnKeys;
  c.chunk = forward_chunk(B, H, KH, Sk, D, Dv);
  return c;
}

template <int DP, int DVP, int KEYS, bool LSE, bool OVERLAP, bool TURNS>
int launch_fwd(const CUtensorMap (&maps)[4], int B, int H, int KH, int Sq, int Sk, float scale,
               int causal, const FwdChoice& c, float* lse, cudaStream_t st) {
  constexpr int smem = FwdSmem<DP, DVP, KEYS>::kBytes;
  // once per template instance and device: the attribute belongs to the
  // current device's context
  static bool attr_set[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= kMaxDevices || !attr_set[dev]) {
    err = cudaFuncSetAttribute(flash_fwd_kernel<DP, DVP, KEYS, LSE, OVERLAP, TURNS>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dev < kMaxDevices) attr_set[dev] = true;
  }
  flash_fwd_kernel<DP, DVP, KEYS, LSE, OVERLAP, TURNS><<<c.grid, kThreads, smem, st>>>(
      maps[0], maps[1], maps[2], maps[3], H, KH, B, Sq, Sk, scale * kLog2e, causal, c.chunk,
      lse);
  return static_cast<int>(cudaGetLastError());
}

// the instance of `forward_choice`'s keys, overlap and turns (128 keys only
// up to head_dim 64, overlapped; turns only overlapped)
template <int DP, int DVP, bool LSE>
int launch(const CUtensorMap (&maps)[4], int B, int H, int KH, int Sq, int Sk, int D, int Dv,
           float scale, int causal, float* lse, cudaStream_t st) {
  int dev = 0;
  const cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_sm = sm_count(dev);
  if (n_sm == 0) return static_cast<int>(cudaErrorInvalidDevice);
  const FwdChoice c = forward_choice(B, H, KH, Sq, Sk, D, Dv, causal, n_sm);
  if constexpr (DVP <= kRegCols) {
    if constexpr (DP <= 64) {
      if (c.keys == 128)
        return c.turns ? launch_fwd<DP, DVP, 128, LSE, true, true>(maps, B, H, KH, Sq, Sk, scale,
                                                                   causal, c, lse, st)
                       : launch_fwd<DP, DVP, 128, LSE, true, false>(maps, B, H, KH, Sq, Sk,
                                                                    scale, causal, c, lse, st);
    }
    if (c.turns)
      return launch_fwd<DP, DVP, kRows, LSE, true, true>(maps, B, H, KH, Sq, Sk, scale, causal,
                                                         c, lse, st);
    if (c.overlap)
      return launch_fwd<DP, DVP, kRows, LSE, true, false>(maps, B, H, KH, Sq, Sk, scale, causal,
                                                          c, lse, st);
  }
  return launch_fwd<DP, DVP, kRows, LSE, false, false>(maps, B, H, KH, Sq, Sk, scale, causal, c,
                                                       lse, st);
}

// The f32 route's launch shape from (Sq, D, Dv) alone (`ops.f32_plan`):
// query rows a block (64 when Sq <= 64, else 128), keys a tile (64 up to
// head_dim 128, else 32: the Q tile and the ring must fit 227 KB at 192),
// the ring's buffers, shared-memory bytes, and the output chunks a thread.
struct F32Plan {
  int tm, tn, cv, qs, vs, smem;
};
F32Plan f32_plan(int Sq, int D, int Dv) {
  F32Plan p;
  const int dp = (D + 3) / 4 * 4, dvp = (Dv + 3) / 4 * 4;
  p.tm = Sq <= kF32SmallSq ? 2 : 4;
  p.tn = dp <= 128 ? 8 : 4;
  const int cv = (dvp / 4 + kF32Lanes - 1) / kF32Lanes;  // chunks a thread, built for 2, 3, 4, 6
  p.cv = cv <= 2 ? 2 : cv <= 4 ? cv : 6;
  p.qs = f32_stride(dp);
  p.vs = dvp;
  const int rows = kF32Groups * p.tm, keys = kF32Lanes * p.tn;
  p.smem = (rows * p.qs + kF32Stages * keys * p.qs + rows * (keys + 8)) *
           static_cast<int>(sizeof(float));
  return p;
}

// the most shared memory an instance takes (head_dim 128 for 64-key
// tiles, 192 for 32-key ones), opted in once per instance and device
template <int TM, int TN, int CV>
int launch_f32(const F32Args& a, int smem, cudaStream_t st) {
  constexpr int kQs = f32_stride(TN == 8 ? 128 : kMaxD);
  constexpr int kBr = kF32Groups * TM, kBc = kF32Lanes * TN;
  constexpr int kMax = (kBr * kQs + kF32Stages * kBc * kQs + kBr * (kBc + 8)) *
                       static_cast<int>(sizeof(float));
  static bool attr_set[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= kMaxDevices || !attr_set[dev]) {
    err = cudaFuncSetAttribute(flash_f32_kernel<TM, TN, CV>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, kMax);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dev < kMaxDevices) attr_set[dev] = true;
  }
  if (smem > kMax) return static_cast<int>(cudaErrorInvalidValue);
  flash_f32_kernel<TM, TN, CV><<<a.n_qt * a.H * a.B, kF32Threads, smem, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <int TM>
int dispatch_f32(const F32Args& a, const F32Plan& p, cudaStream_t st) {
  if (p.tn == 8) {
    switch (p.cv) {
      case 2: return launch_f32<TM, 8, 2>(a, p.smem, st);
      case 3: return launch_f32<TM, 8, 3>(a, p.smem, st);
      case 4: return launch_f32<TM, 8, 4>(a, p.smem, st);
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  switch (p.cv) {
    case 2: return launch_f32<TM, 4, 2>(a, p.smem, st);
    case 3: return launch_f32<TM, 4, 3>(a, p.smem, st);
    case 4: return launch_f32<TM, 4, 4>(a, p.smem, st);
    default: return launch_f32<TM, 4, 6>(a, p.smem, st);
  }
}

// true if every row of t starts on a 16-byte boundary: the base, and each
// stride of a dimension longer than one, a multiple of 4 floats
bool rows_aligned(const void* p, Strides s, int B, int heads, int S) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && (B == 1 || s.b % 4 == 0) &&
         (heads == 1 || s.h % 4 == 0) && (S == 1 || s.s % 4 == 0);
}

// ------------------------------------------------------ the backward (bf16)
//
// The gradient of attention, Sq query rows over Sk keys, causal (top-left)
// or not (the decoders' causal self-attention; the enc-dec's encoder and
// its cross-attention), as `jax.grad` takes it through the reference's
// `chunked_attention`: no
// Pallas kernel has a backward, the reference differentiates its plain XLA
// math.  The FA2 form: the training forward (`fa_forward_lse`) also writes
// each query row's log-sum-exp, so the backward recomputes P = exp(s - lse)
// tile by tile and never holds the (Sq, Sk) scores:
//   Delta = rowsum(dO * O)                     (`fa_bwd_delta_kernel`)
//   dV = P^T dO, dS = P * (dO V^T - Delta), dK = scale dS^T Q
//                                              (`fa_bwd_dkdv_kernel`)
//   dQ = scale dS K                            (`fa_bwd_dq_kernel`)
// Bound: operations, five products a head over the (query, key) pairs the
// mask keeps (S^T and dK D wide, dP^T and dV Dv wide, and dQ D wide; the
// dQ kernel computes S and dP again, seven products in all), against the
// inputs' bytes.
//
// Widths.  q, k, dq and dk are D wide, v, o, dout and dv Dv <= D wide
// (MLA: D 192 = 128 + 64 of rope, Dv 128).  The instances (DP, DVP), each
// rounded as the forward rounds head_dim, are (DP, DP) for every DP the
// forward takes (16 to 128 by 16, and 192) and (192, 128); the wrapper pads
// v, o and dout with zero columns to one of them (`ops.grad_v_width`), exact
// since dv is sliced back.  A consumer holds at most 128 columns of an
// accumulator in registers (`kRegCols`); at 192 the third panel's 64
// columns (dK's rope columns, dV's at DVP 192, dQ's) are a 64 x 64 f32
// accumulator in shared memory, one a warpgroup: a step loads the thread's
// 32 values of it, adds its product there with the same A fragments
// (m64n64k16 `wgmma`s on B's third panel, in the same commit group as the
// register columns' product) and stores them back.  A thread so holds at
// 192 what it holds at 128: 64 accumulator registers beside a 64 x 64
// product and the bf16 fragments.  Each element of that accumulator is
// read and written by one thread only, in a fixed order: deterministic.
//
// Design (the forward's: TMA into a ring, `wgmma`, warp-specialised):
//  - Delta stays its own launch, sixteen lanes a row (8 columns a lane, a
//    second pass past 128), which also writes each
//    row's lse in base 2; both go to an f32 scratch of (B, H, Sp) rows each,
//    Sp = Sq rounded up to 64 (zeros past Sq), so a query tile's 64 values
//    of each are one 256-byte bulk copy;
//  - dK/dV: a block a (64-key tile of Sk, batch) and hpb query heads of
//    one KV head, walked in turn.  One producer warp loads the tile's K and
//    V once and streams, head by head, the query tiles its keys meet (all
//    of Sq; under the causal mask those from the tile's first key on)
//    through a ring of three stages (two at D = Dv = 192, where three take
//    more shared memory than a block has): Q, dO, and the tile's lse and
//    Delta beside them.  Consumer warpgroup 0
//    runs S^T = K Q^T as an SS `wgmma` (K as A, Q K-major as B), turns it
//    into P^T = exp2(S^T scale log2e - lse) in registers, hands P^T in f32
//    to warpgroup 1 through the stage's slot in shared memory (an mbarrier
//    a stage), packs it to bf16 and runs dV += P^T dO as an RS `wgmma`
//    whose B is the swizzled dO tile read MN-major (as the forward reads
//    V).  Warpgroup 1 runs dP^T = V dO^T (SS) meanwhile, then
//    dS^T = P^T (dP^T - Delta) and dK += dS^T Q (RS, Q read MN-major).
//    Each consumer holds one 64 x min(D, 128) f32 accumulator (64
//    registers a thread at D = 128) beside its 64 x 64 product (32): within
//    the 168 registers a thread of a 288-thread block may have.  (A block's
//    nine warps share the SM's four register partitions of 16,384, three to
//    one: 3 x 32 x 168 fits, 224 does not.  A first design kept dK and dV of
//    64 keys in one warpgroup, 128 + 64 registers, with a producer
//    warpgroup and `setmaxnreg` 24/240; `ptxas` 12.9 held it at 168, spilled
//    and serialised its `wgmma`s (C7512).  A third consumer warpgroup would
//    put four warps on a partition: 128 registers a thread.)  No product
//    is computed twice;
//  - the C blocks of a KV head are one thread block cluster, C a divisor of
//    the G query heads a KV head with C <= 8 (the portable size), each block
//    walking hpb = G / C heads; a prime G past 8 takes C = 1, one block
//    walking all G heads.  Each block's partial dK and dV go, in
//    f32, to its own shared memory over the finished tiles; the cluster
//    synchronises, and the block of rank r sums rows [r R, r R + R),
//    R = ceil(64 / C), of every rank's partials through distributed shared
//    memory in rank order 0..C-1, scales dK and writes bf16.
//    Deterministic, no atomics, no global scratch.  `heads_a_block` picks
//    C from the card's cluster occupancy: clusters of G full-SM blocks
//    pack unevenly into the GPCs (at G = 6 an H100 holds 17 at once, 102
//    SMs), and a block that walks several heads also spreads its K/V load
//    and its share of the reduction over more steps;
//  - dQ: the forward's persistent kernel with dO beside Q: a work item is
//    128 query rows of one (head, batch), the items with the most K/V tiles
//    first (`item_at`); K/V tiles of 64 keys stream through the ring;
//    S = Q K^T and dP = dO V^T as SS `wgmma`s, dS packed to bf16 in
//    registers, and dQ += dS K as an RS `wgmma` (K read MN-major);
//  - ragged edges and the mask: query rows past Sq and keys past Sk are
//    masked explicitly in both kernels (TMA zero-fills the rows past either
//    end, and a zero key scores 0, so without the mask P = exp2(-lse) there,
//    not 0); dK and dV are stored for keys below Sk only.  Under the causal
//    mask with Sq < Sk a key tile at or past Sq meets no query: its blocks
//    walk no step, their partials stay zero, and the cluster's reduction
//    writes zero dK and dV for its keys (the outputs are not zeroed on the
//    host);
//  - the dK/dV grid is (H / hpb, B, key tiles), key tile 0, which walks
//    the most query tiles, launched first; each launch is captured in a
//    CUDA graph as it is: the maps are `__grid_constant__` parameters, and
//    nothing is allocated or synchronised on the host.
// What bounds it: the tensor cores wait on each warpgroup's elementwise
// pass between its products (each consumer waits for its own `wgmma`s; the
// other warpgroup's products fill the gap), warpgroup 1 waits for P^T, the
// diagonal tiles' masked halves, and in dK/dV the cluster's reduction
// (64 x D x 2 f32 a block over distributed shared memory).
// Times measured (chip_smoke.py phase 2; NVIDIA H100 80GB HBM3, 700.00 W):
// 143.245 us at qwen2-1.5b's (4, 1024, 12/2, 128), three heads a dK/dV
// block in clusters of two, against the mma.sync design's 480.894 us in
// the same run, SDPA's backward 157.779 us and the 32.602 us bound (Delta
// 10.894, dK/dV 70.218, dQ 57.451 us; a head a block in clusters of six:
// dK/dV 117.765 us); 73.883 us at (2, 1024, 8/8, 128) against 157.982,
// 62.035 and 10.867 us.
// At deepseek-v3's MLA training shape (4, 1024, 128/128, 192), v 128,
// causal: 2385.645 us against the 452.086 us bound and SDPA's backward
// 1661.203 us (Delta 97.185, dK/dV 1547.619, dQ 733.576 us): the 8,192
// one-head dK/dV blocks each load K and V and reduce their partials for
// 8.5 steps on average.  `ptxas -v` (the H100 machine's toolkit): dK/dV
// 156 registers at (128, 128), 160 at (192, 192), 168 at (192, 128) with 4
// bytes spilled; dQ 168 at each of the three, no spill.

constexpr int kBwdMaxD = kMaxD;
constexpr int kBwdKeys = kRows;  // keys a dK/dV block
constexpr int kMaxGroup = 8;     // dK/dV blocks a cluster: the portable size

struct BwdArgs {
  const bf16 *o, *dout;
  bf16 *dq, *dk, *dv;
  const float* lse;  // (B, H, Sq), natural base
  float* scratch;    // Delta, then lse in base 2: each (B, H, Sp)
  Strides so, sdo, sdq, sdk, sdv;
  int B, H, KH, Sq, Sk, Sp, D;  // Sp: Sq rounded up to kRows
  int Dv;                       // v, o, dout and dv: Dv <= D columns
  int causal;                   // top-left: query row i sees keys 0..i
  int hpb;  // query heads a dK/dV block, walked in turn (G / hpb blocks a cluster)
  float scale;
};

// one cluster barrier, every thread of the cluster (not warp-aligned: the
// producer warp arrives from divergent lanes); release and acquire
// order the shared-memory writes before it against the reads after it
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
}

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// a shared::cta address of this block -> the same offset in block `rank`'s
// shared memory, as a shared::cluster address
__device__ __forceinline__ uint32_t cluster_addr(uint32_t addr, uint32_t rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(r) : "r"(addr), "r"(rank));
  return r;
}

__device__ __forceinline__ float4 ld_cluster(uint32_t addr) {
  float4 v;
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(addr)
               : "memory");
  return v;
}

// `bytes` contiguous bytes (a multiple of 16, both ends 16-byte aligned)
// from global to shared memory, completing on `bar`
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
          dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// Delta[(b H + h) Sp + s] = sum_d dO O and, B H Sp values further on, lse
// in base 2; rows s in [Sq, Sp) get zeros.  Sixteen lanes a row, two rows a
// warp: one 16-byte load of each of O and dO a lane covers Dv <= 128, a
// second pass the columns past it.
constexpr int kDeltaLanes = 16;

__global__ void __launch_bounds__(256) fa_bwd_delta_kernel(const BwdArgs a) {
  const int64_t n_rows = static_cast<int64_t>(a.B) * a.H * a.Sp;
  const int64_t idx = (static_cast<int64_t>(blockIdx.x) * 256 + threadIdx.x) / kDeltaLanes;
  const int col = (threadIdx.x % kDeltaLanes) * 8;
  const bool row_ok = idx < n_rows;  // every lane reaches the shuffles
  const int s = row_ok ? static_cast<int>(idx % a.Sp) : a.Sq;
  const int64_t bh = idx / a.Sp;
  float acc = 0.0f;
  if (s < a.Sq) {
    const int h = static_cast<int>(bh % a.H), b = static_cast<int>(bh / a.H);
    const bf16* orow = a.o + b * a.so.b + h * a.so.h + s * a.so.s;
    const bf16* grow = a.dout + b * a.sdo.b + h * a.sdo.h + s * a.sdo.s;
    for (int c0 = col; c0 < a.Dv; c0 += kDeltaLanes * 8) {
      const uint4 ov = *reinterpret_cast<const uint4*>(orow + c0);
      const uint4 gv = *reinterpret_cast<const uint4*>(grow + c0);
      const bf16* op = reinterpret_cast<const bf16*>(&ov);
      const bf16* gp = reinterpret_cast<const bf16*>(&gv);
#pragma unroll
      for (int e = 0; e < 8; ++e) acc += __bfloat162float(op[e]) * __bfloat162float(gp[e]);
    }
  }
#pragma unroll
  for (int off = kDeltaLanes / 2; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (row_ok && col == 0) {
    a.scratch[idx] = acc;
    a.scratch[n_rows + idx] = s < a.Sq ? a.lse[bh * a.Sq + s] * kLog2e : 0.0f;
  }
}

// The 64 x 64 f32 accumulator of a warpgroup's columns past kRegCols, in
// shared memory: thread t's 32 values (the m64n64 accumulator fragment) as
// float4 m at index m * 128 + t
constexpr int kRopeBytes = kRows * kRows * 4;

__device__ __forceinline__ void rope_zero(float4* slot) {
#pragma unroll
  for (int m = 0; m < 8; ++m) slot[m * 128] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
}
__device__ __forceinline__ void rope_load(float (&r)[32], const float4* slot) {
#pragma unroll
  for (int m = 0; m < 8; ++m) {
    const float4 v = slot[m * 128];
    r[4 * m] = v.x;
    r[4 * m + 1] = v.y;
    r[4 * m + 2] = v.z;
    r[4 * m + 3] = v.w;
  }
}
__device__ __forceinline__ void rope_store(const float (&r)[32], float4* slot) {
#pragma unroll
  for (int m = 0; m < 8; ++m) slot[m * 128] = make_float4(r[4 * m], r[4 * m + 1], r[4 * m + 2], r[4 * m + 3]);
}

// the dK/dV kernel's shared memory at (DP, DVP): K and V of the block, then
// a ring of Q, dO, P^T (f32), lse and Delta, three stages where they fit
// (two at DP = DVP = 192), then the shared accumulators of dV's and dK's
// columns past kRegCols
template <int DP, int DVP>
struct BwdSmem {
  static constexpr int kPanels = panels(DP), kVPanels = panels(DVP);
  static constexpr int kTile = kPanels * kPanelBytes;    // 64 rows of Q or K, every panel
  static constexpr int kVTile = kVPanels * kPanelBytes;  // of V or dO
  static constexpr int kPBytes = kRows * kRows * 4;
  static constexpr int kRopes = (DVP > kRegCols) + (DP > kRegCols);
  static constexpr int kStageBytes = kTile + kVTile + kPBytes + 2 * kRows * 4;
  static constexpr int kFixed = kTile + kVTile + kRopes * kRopeBytes + 1024;
  static constexpr int kStages = kFixed + 3 * kStageBytes + 8 * 10 <= kMaxSmem ? 3 : 2;
  static constexpr int kK = 0;                                // the block's K tile
  static constexpr int kV = kK + kTile;                       // and V tile
  static constexpr int kQ = kV + kVTile;                      // the Q ring
  static constexpr int kdO = kQ + kStages * kTile;            // the dO ring
  static constexpr int kP = kdO + kStages * kVTile;           // P^T, f32, a stage each
  static constexpr int kLse = kP + kStages * kPBytes;         // each stage's 64 base-2 lse
  static constexpr int kDelta = kLse + kStages * kRows * 4;   // and 64 Delta
  static constexpr int kRopeV = kDelta + kStages * kRows * 4; // dV's columns past kRegCols
  static constexpr int kRopeK = kRopeV + (DVP > kRegCols) * kRopeBytes;  // dK's
  static constexpr int kBars = kRopeK + (DP > kRegCols) * kRopeBytes;  // kv_full, full[], empty[], p_full[]
  static constexpr int kBytes = kBars + 8 * (1 + 3 * kStages) + 1024;  // + alignment slack
  // after the loop: the f32 partial dV, then dK, of the block's 64 keys,
  // rows padded to DP + 8 floats (a half-warp's 8-byte stores and 16-byte
  // loads fall in distinct banks), over the tiles (not the accumulators
  // past kRegCols, which the partials are copied from)
  static constexpr int kPartRow = DP + 8;
  static_assert(2 * kBwdKeys * kPartRow * 4 <= kRopeV, "the partials overlay the tiles only");
  static_assert(kBytes <= kMaxSmem, "more shared memory than a block may have");
};

template <int DP, int DVP>
__global__ void __launch_bounds__(kThreads, 1)
fa_bwd_dkdv_kernel(const __grid_constant__ CUtensorMap tm_q,
                   const __grid_constant__ CUtensorMap tm_k,
                   const __grid_constant__ CUtensorMap tm_v,
                   const __grid_constant__ CUtensorMap tm_do, const BwdArgs a) {
  using L = BwdSmem<DP, DVP>;
  constexpr int KSTEPS = DP / 16, VSTEPS = DVP / 16;
  constexpr int kStages = L::kStages;
  constexpr int AW = DP < kRegCols ? DP : kRegCols;  // register columns of dV and of dK
  static_assert((DVP < kRegCols ? DVP : kRegCols) == AW, "dV and dK keep as many in registers");
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023) & ~1023u;
  unsigned char* gbase = smem_raw + (base - smem_addr(smem_raw));  // generic pointer to base
  const uint32_t bar_kv = base + L::kBars;
  const uint32_t bar_full = bar_kv + 8;                 // + 8 * stage
  const uint32_t bar_empty = bar_full + 8 * kStages;    // + 8 * stage
  const uint32_t bar_p = bar_empty + 8 * kStages;       // + 8 * stage
  const int b = blockIdx.y, k0 = blockIdx.z * kBwdKeys;
  const int G = a.H / a.KH, C = G / a.hpb;  // blocks a cluster: rank blockIdx.x % C
  const int kh = blockIdx.x / C, h0 = kh * G + (blockIdx.x % C) * a.hpb;  // the first head
  // the query tiles the block's keys meet: every one, or under the causal
  // mask those from its first key on (none once k0 >= Sq: the walk has no
  // step, and the block writes zero dK and dV for its keys)
  const int q_first = a.causal ? k0 : 0;
  const int n_q = max(0, (a.Sq - q_first + kRows - 1) / kRows);
  const int n_it = a.hpb * n_q;  // (head, query tile) steps, head-major
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    mbar_init(bar_kv, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, kConsumers * 4);  // every consumer warp arrives
      mbar_init(bar_p + 8 * s, 4);                   // the P^T warpgroup's warps
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == kConsumers * 4) {
    // ------------------------------------------------------------ producer
    constexpr int kMostPanels = L::kPanels > L::kVPanels ? L::kPanels : L::kVPanels;
    if (lane == 0) {
      mbar_expect_tx(bar_kv, L::kTile + L::kVTile);
      for (int p = 0; p < kMostPanels; ++p) {
        if (p < L::kPanels)
          tma_load(base + L::kK + p * kPanelBytes, &tm_k, p * kPanelCols, kh, k0, b, bar_kv);
        if (p < L::kVPanels)
          tma_load(base + L::kV + p * kPanelBytes, &tm_v, p * kPanelCols, kh, k0, b, bar_kv);
      }
      const int64_t lse_off = static_cast<int64_t>(a.B) * a.H * a.Sp;  // the lse plane
      for (int step = 0; step < n_it; ++step) {
        const int s = step % kStages, h = h0 + step / n_q;
        const int q0 = q_first + (step % n_q) * kRows;
        if (step >= kStages) mbar_wait(bar_empty + 8 * s, (step / kStages - 1) & 1);
        const float* delta = a.scratch + (static_cast<int64_t>(b) * a.H + h) * a.Sp;
        const float* lse2 = delta + lse_off;
        const uint32_t full = bar_full + 8 * s;
        mbar_expect_tx(full, L::kTile + L::kVTile + 2 * kRows * 4);
        for (int p = 0; p < kMostPanels; ++p) {
          if (p < L::kPanels)
            tma_load(base + L::kQ + s * L::kTile + p * kPanelBytes, &tm_q, p * kPanelCols, h,
                     q0, b, full);
          if (p < L::kVPanels)
            tma_load(base + L::kdO + s * L::kVTile + p * kPanelBytes, &tm_do, p * kPanelCols, h,
                     q0, b, full);
        }
        bulk_load(base + L::kLse + s * kRows * 4, lse2 + q0, kRows * 4, full);
        bulk_load(base + L::kDelta + s * kRows * 4, delta + q0, kRows * 4, full);
      }
    }
    cluster_sync();  // the partials are written
    cluster_sync();  // and read
    return;
  }

  // -------------------------------------------------------------- consumers
  // Warpgroup 0 takes P^T and dV, warpgroup 1 dP^T, dS^T and dK.  A thread
  // of either holds the same accumulator elements: 4 j + 2 r + e is key row
  // a (r = 0) or b, query column 8 j + 2 tq + e of the tile; query columns
  // 16 kk.. are the A fragments of k-step kk of the RS products.
  const int c = warp / 4, wi = warp % 4, tq = lane % 4, tid = threadIdx.x % 128;
  const int key_a = k0 + wi * 16 + lane / 4, key_b = key_a + 8;
  // the first query each of this thread's key rows keeps: the key itself
  // under the causal mask, 0 without it, none for a key past Sk (TMA
  // zero-fills those rows, and a zero key scores 0, so P^T = exp2(-lse)
  // there unless masked); the tail tile masks every step
  const int lo_a = key_a >= a.Sk ? kNoQuery : a.causal ? key_a : 0;
  const int lo_b = key_b >= a.Sk ? kNoQuery : a.causal ? key_b : 0;
  const bool key_tail = k0 + kBwdKeys > a.Sk;
  const float sl2 = a.scale * kLog2e;
  // this warpgroup's accumulator past kRegCols (dV's at DVP 192, dK's at DP 192)
  const bool rope = c == 0 ? DVP > kRegCols : DP > kRegCols;
  float4* rope_slot = reinterpret_cast<float4*>(gbase + (c == 0 ? L::kRopeV : L::kRopeK)) + tid;
  if (rope) rope_zero(rope_slot);
  float acc[AW / 2];  // dV (warpgroup 0) or dK (1) of the block's 64 keys, columns < kRegCols
#pragma unroll
  for (int i = 0; i < AW / 2; ++i) acc[i] = 0.0f;

  mbar_wait(bar_kv, 0);
  for (int step = 0; step < n_it; ++step) {
    const int s = step % kStages, t = step % n_q;  // t: the query tile of this head
    mbar_wait(bar_full + 8 * s, (step / kStages) & 1);
    const uint32_t q_tile = base + L::kQ + s * L::kTile;
    const uint32_t do_tile = base + L::kdO + s * L::kVTile;
    // this thread's P^T values of the stage, 16 bytes a step of 128 threads
    float4* p_slot = reinterpret_cast<float4*>(gbase + L::kP + s * L::kPBytes) + tid;
    uint32_t af[4][4];  // the A fragments: P^T (warpgroup 0) or dS^T (1), bf16
    if (c == 0) {
      // S^T = K Q^T (64 keys x 64 queries, f32), fresh a tile
      float st[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) st[i] = 0.0f;
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < KSTEPS; ++j) {
        const uint32_t off = (j / 4) * kPanelBytes + (j % 4) * 32;
        Wgmma<64>::ss(st, sw128_desc(base + L::kK + off, 16, 1024),
                      sw128_desc(q_tile + off, 16, 1024), j > 0);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(st);
      // P^T (key, query) = exp2(s scale log2e - lse2) where query < Sq,
      // key < Sk and, under the causal mask, key <= query (the diagonal
      // tile is the walk's first)
      const int q0 = q_first + t * kRows;
      const bool need_mask = (a.causal && t == 0) || q0 + kRows > a.Sq || key_tail;
      const float* sl = reinterpret_cast<const float*>(gbase + L::kLse) + s * kRows;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 l2 = *reinterpret_cast<const float2*>(sl + 8 * j + 2 * tq);
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float lq = e ? l2.y : l2.x;
          float pa = exp2f(st[4 * j + e] * sl2 - lq), pb = exp2f(st[4 * j + 2 + e] * sl2 - lq);
          if (need_mask) {
            const int q = q0 + 8 * j + 2 * tq + e;
            pa = q >= lo_a && q < a.Sq ? pa : 0.0f;
            pb = q >= lo_b && q < a.Sq ? pb : 0.0f;
          }
          st[4 * j + e] = pa;
          st[4 * j + 2 + e] = pb;
        }
      }
      // hand P^T to warpgroup 1 in f32, as it lies in the registers
#pragma unroll
      for (int m = 0; m < 8; ++m)
        p_slot[m * 128] = make_float4(st[4 * m], st[4 * m + 1], st[4 * m + 2], st[4 * m + 3]);
      __syncwarp();
      if (lane == 0) mbar_arrive(bar_p + 8 * s);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int i = 0; i < 4; ++i) af[kk][i] = pack_bf16(st[8 * kk + 2 * i], st[8 * kk + 2 * i + 1]);
    } else {
      // dP^T = V dO^T (Dv wide), then dS^T = P^T (dP^T - Delta) with warpgroup 0's P^T
      float dpt[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) dpt[i] = 0.0f;
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < VSTEPS; ++j) {
        const uint32_t off = (j / 4) * kPanelBytes + (j % 4) * 32;
        Wgmma<64>::ss(dpt, sw128_desc(base + L::kV + off, 16, 1024),
                      sw128_desc(do_tile + off, 16, 1024), j > 0);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(dpt);
      const float* sd = reinterpret_cast<const float*>(gbase + L::kDelta) + s * kRows;
      mbar_wait(bar_p + 8 * s, (step / kStages) & 1);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        // P^T's columns 16 kk..: elements 8 kk .. 8 kk + 7
        const float4 p0 = p_slot[(2 * kk) * 128], p1 = p_slot[(2 * kk + 1) * 128];
        const float p[8] = {p0.x, p0.y, p0.z, p0.w, p1.x, p1.y, p1.z, p1.w};
        float ds[8];
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          const float2 dl = *reinterpret_cast<const float2*>(sd + 8 * (2 * kk + jj) + 2 * tq);
#pragma unroll
          for (int i = 0; i < 4; ++i)
            ds[4 * jj + i] = p[4 * jj + i] * (dpt[8 * kk + 4 * jj + i] - (i % 2 ? dl.y : dl.x));
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) af[kk][i] = pack_bf16(ds[2 * i], ds[2 * i + 1]);
      }
    }
    // dV += P^T dO (warpgroup 0) or dK += dS^T Q (1): B is the tile's rows
    // 16 kk.. read MN-major, its first kRegCols columns into the registers
    // and its third panel, if any, into the shared accumulator
    const uint32_t b_tile = c == 0 ? do_tile : q_tile;
    float r[32];
    fence_regs(acc);
    if (rope) {
      rope_load(r, rope_slot);
      fence_regs(r);
    }
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      Wgmma<AW>::rs(acc, af[kk], sw128_desc(b_tile + kk * 16 * 128, kPanelBytes, 1024), 1);
    if constexpr (L::kRopes > 0) {
      if (rope) {
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          Wgmma<64>::rs(r, af[kk], sw128_desc(b_tile + 2 * kPanelBytes + kk * 16 * 128,
                                              kPanelBytes, 1024), 1);
      }
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc);
    if (rope) {
      fence_regs(r);
      rope_store(r, rope_slot);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(bar_empty + 8 * s);
  }

  // both consumer warpgroups are done with the tiles the partials overlay
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers * 128) : "memory");
  float* part = reinterpret_cast<float*>(gbase);  // dV rows 0..63, then dK rows
  const int ra = c * kRows + wi * 16 + lane / 4, rb = ra + 8;
#pragma unroll
  for (int j = 0; j < AW / 8; ++j) {
    const int col = 8 * j + 2 * tq;
    *reinterpret_cast<float2*>(part + ra * L::kPartRow + col) = make_float2(acc[4 * j], acc[4 * j + 1]);
    *reinterpret_cast<float2*>(part + rb * L::kPartRow + col) =
        make_float2(acc[4 * j + 2], acc[4 * j + 3]);
  }
  if (rope) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = kRegCols + 8 * j + 2 * tq;
      const float4 v = rope_slot[j * 128];
      *reinterpret_cast<float2*>(part + ra * L::kPartRow + col) = make_float2(v.x, v.y);
      *reinterpret_cast<float2*>(part + rb * L::kPartRow + col) = make_float2(v.z, v.w);
    }
  }
  cluster_sync();  // every block's partials are written

  // rank r sums rows [r R, r R + R) over ranks 0..C-1, in that order: dV's
  // DVP / 4 four-column chunks a row, then dK's DP / 4
  const int rank = static_cast<int>(cluster_rank());
  const int R = (kBwdKeys + C - 1) / C;
  const int r_lo = rank * R, n_rows = max(0, min(kBwdKeys, r_lo + R) - r_lo);
  constexpr int CHV = DVP / 4, CHK = DP / 4;
  const int n_v = n_rows * CHV;
  for (int idx = threadIdx.x; idx < n_v + n_rows * CHK; idx += kConsumers * 128) {
    const int which = idx >= n_v;  // 0: dV, 1: dK
    const int rem = which ? idx - n_v : idx, ch = which ? CHK : CHV;
    const int row = r_lo + rem / ch, col = (rem % ch) * 4, key = k0 + row;
    if (key >= a.Sk || col >= (which ? a.D : a.Dv)) continue;
    const uint32_t off = base + ((which * kBwdKeys + row) * L::kPartRow + col) * 4;
    float4 v[kMaxGroup];
#pragma unroll
    for (int q = 0; q < kMaxGroup; ++q)
      if (q < C) v[q] = ld_cluster(cluster_addr(off, q));
    float4 sum = v[0];
#pragma unroll
    for (int q = 1; q < kMaxGroup; ++q)
      if (q < C) {
        sum.x += v[q].x;
        sum.y += v[q].y;
        sum.z += v[q].z;
        sum.w += v[q].w;
      }
    const float m = which ? a.scale : 1.0f;
    bf16* dst = which ? a.dk + b * a.sdk.b + kh * a.sdk.h + key * a.sdk.s
                      : a.dv + b * a.sdv.b + kh * a.sdv.h + key * a.sdv.s;
    reinterpret_cast<uint32_t*>(dst + col)[0] = pack_bf16(sum.x * m, sum.y * m);
    reinterpret_cast<uint32_t*>(dst + col)[1] = pack_bf16(sum.z * m, sum.w * m);
  }
  cluster_sync();  // no block leaves while another reads its partials
}

// the dQ kernel's shared memory at (DP, DVP): a Q and a dO tile (DVP
// wide) per consumer, the K/V ring (V tiles DVP wide; four stages, two
// past head_dim 128), then each consumer's accumulator of dQ's columns
// past kRegCols
template <int DP, int DVP>
struct DqSmem {
  static constexpr int kStages = DP > kRegCols ? 2 : 4;
  static constexpr int kPanels = panels(DP), kVPanels = panels(DVP);
  static constexpr int kTile = kPanels * kPanelBytes, kVTile = kVPanels * kPanelBytes;
  static constexpr int kQ = 0;                          // a Q tile per consumer
  static constexpr int kdO = kQ + kConsumers * kTile;   // a dO tile per consumer
  static constexpr int kK = kdO + kConsumers * kVTile;
  static constexpr int kV = kK + kStages * kTile;
  static constexpr int kRope = kV + kStages * kVTile;   // a consumer's columns past kRegCols each
  static constexpr int kBars = kRope + (DP > kRegCols ? kConsumers * kRopeBytes : 0);
  static constexpr int kBytes = kBars + 8 * (2 + 2 * kStages) + 1024;  // + alignment slack
  static_assert(kBytes <= kMaxSmem, "more shared memory than a block may have");
};

// dQ: the forward's persistent walk (`item_at` at Sq, Sk and the mask),
// with a dO tile beside each consumer's Q tile and the K/V ring as there
template <int DP, int DVP>
__global__ void __launch_bounds__(kThreads, 1)
fa_bwd_dq_kernel(const __grid_constant__ CUtensorMap tm_q,
                 const __grid_constant__ CUtensorMap tm_k,
                 const __grid_constant__ CUtensorMap tm_v,
                 const __grid_constant__ CUtensorMap tm_do, const BwdArgs a) {
  using L = DqSmem<DP, DVP>;
  constexpr int KSTEPS = DP / 16, VSTEPS = DVP / 16;
  constexpr int kStages = L::kStages;
  constexpr int AW = DP < kRegCols ? DP : kRegCols;  // dQ's register columns
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023) & ~1023u;
  unsigned char* gbase = smem_raw + (base - smem_addr(smem_raw));  // generic pointer to base
  const uint32_t bar_q_full = base + L::kBars;
  const uint32_t bar_q_empty = bar_q_full + 8;
  const uint32_t bar_full = bar_q_empty + 8;          // + 8 * stage
  const uint32_t bar_empty = bar_full + 8 * kStages;  // + 8 * stage
  const int H = a.H, B = a.B, Sq = a.Sq, Sk = a.Sk, causal = a.causal;
  const int n_items = (Sq + kConsumers * kRows - 1) / (kConsumers * kRows) * H * B;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    mbar_init(bar_q_full, 1);
    mbar_init(bar_q_empty, kConsumers * 4);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, kConsumers * 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == kConsumers * 4) {
    // ------------------------------------------------------------ producer
    constexpr int kMostPanels = L::kPanels > L::kVPanels ? L::kPanels : L::kVPanels;
    if (lane != 0) return;
    int tile = 0;
    for (int w = blockIdx.x, n = 0; w < n_items; w += gridDim.x, ++n) {
      const Item it = item_at<kRows>(w, H, B, Sq, Sk, causal, H * B);
      const int kh = it.h / (H / a.KH);
      if (n > 0) mbar_wait(bar_q_empty, (n - 1) & 1);
      mbar_expect_tx(bar_q_full, it.n_active * (L::kTile + L::kVTile));
      for (int c = 0; c < it.n_active; ++c)
        for (int p = 0; p < kMostPanels; ++p) {
          if (p < L::kPanels)
            tma_load(base + L::kQ + c * L::kTile + p * kPanelBytes, &tm_q, p * kPanelCols, it.h,
                     it.q0 + c * kRows, it.b, bar_q_full);
          if (p < L::kVPanels)
            tma_load(base + L::kdO + c * L::kVTile + p * kPanelBytes, &tm_do, p * kPanelCols,
                     it.h, it.q0 + c * kRows, it.b, bar_q_full);
        }
      for (int t = 0; t < it.n_tiles; ++t, ++tile) {
        const int s = tile % kStages;
        if (tile >= kStages) mbar_wait(bar_empty + 8 * s, (tile / kStages - 1) & 1);
        const uint32_t full = bar_full + 8 * s;
        mbar_expect_tx(full, L::kTile + L::kVTile);
        for (int p = 0; p < kMostPanels; ++p) {
          if (p < L::kPanels)
            tma_load(base + L::kK + s * L::kTile + p * kPanelBytes, &tm_k, p * kPanelCols, kh,
                     t * kRows, it.b, full);
          if (p < L::kVPanels)
            tma_load(base + L::kV + s * L::kVTile + p * kPanelBytes, &tm_v, p * kPanelCols, kh,
                     t * kRows, it.b, full);
        }
      }
    }
    return;
  }

  // -------------------------------------------------------------- consumers
  const int c = warp / 4, wi = warp % 4, tq = lane % 4;
  const uint32_t q_tile = base + L::kQ + c * L::kTile;
  const uint32_t do_tile = base + L::kdO + c * L::kVTile;
  float4* rope_slot = reinterpret_cast<float4*>(gbase + L::kRope + c * kRopeBytes) +
                      threadIdx.x % 128;  // dQ's columns past kRegCols (DP 192)
  const float sl2 = a.scale * kLog2e;
  const float* delta = a.scratch;
  const float* lse2 = a.scratch + static_cast<int64_t>(B) * H * a.Sp;
  float sacc[32], pacc[32], dq[AW / 2];
#pragma unroll
  for (int i = 0; i < 32; ++i) sacc[i] = pacc[i] = 0.0f;
  int tile = 0;
  for (int w = blockIdx.x, n = 0; w < n_items; w += gridDim.x, ++n) {
    const Item it = item_at<kRows>(w, H, B, Sq, Sk, causal, H * B);
    const int r0 = it.q0 + c * kRows;
    const int row_a = r0 + wi * 16 + lane / 4, row_b = row_a + 8;
    const bool active = c < it.n_active;
    // the last K/V tile this warpgroup reads: its last row's, under the causal mask
    const int my_last = !active ? -1
                        : causal ? min(it.n_tiles - 1, (min(r0 + kRows, Sq) - 1) / kRows)
                                 : it.n_tiles - 1;
    // each row's keys end here: at Sk, or under the causal mask after the row
    const int hi_a = causal ? min(row_a + 1, Sk) : Sk, hi_b = causal ? min(row_b + 1, Sk) : Sk;
    const int64_t rows = (static_cast<int64_t>(it.b) * H + it.h) * a.Sp;
    const float l2_a = row_a < Sq ? lse2[rows + row_a] : 0.0f;
    const float l2_b = row_b < Sq ? lse2[rows + row_b] : 0.0f;
    const float dl_a = row_a < Sq ? delta[rows + row_a] : 0.0f;
    const float dl_b = row_b < Sq ? delta[rows + row_b] : 0.0f;
#pragma unroll
    for (int i = 0; i < AW / 2; ++i) dq[i] = 0.0f;
    if constexpr (DP > kRegCols) rope_zero(rope_slot);

    mbar_wait(bar_q_full, n & 1);
    if (!active && lane == 0) mbar_arrive(bar_q_empty);
    for (int t = 0; t < it.n_tiles; ++t, ++tile) {
      const int s = tile % kStages;
      mbar_wait(bar_full + 8 * s, (tile / kStages) & 1);
      if (t <= my_last) {
        const uint32_t k_tile = base + L::kK + s * L::kTile;
        const uint32_t v_tile = base + L::kV + s * L::kVTile;
        // S = Q K^T (D wide) and dP = dO V^T (Dv wide), 64 x 64, f32
        fence_regs(sacc);
        fence_regs(pacc);
        wgmma_fence();
#pragma unroll
        for (int j = 0; j < KSTEPS; ++j) {
          const uint32_t off = (j / 4) * kPanelBytes + (j % 4) * 32;
          Wgmma<64>::ss(sacc, sw128_desc(q_tile + off, 16, 1024),
                        sw128_desc(k_tile + off, 16, 1024), j > 0);
        }
#pragma unroll
        for (int j = 0; j < VSTEPS; ++j) {
          const uint32_t off = (j / 4) * kPanelBytes + (j % 4) * 32;
          Wgmma<64>::ss(pacc, sw128_desc(do_tile + off, 16, 1024),
                        sw128_desc(v_tile + off, 16, 1024), j > 0);
        }
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(sacc);
        fence_regs(pacc);
        if (t == my_last && lane == 0) mbar_arrive(bar_q_empty);  // Q and dO are free

        // dS = P (dP - Delta), P = exp2(s scale log2e - lse2) where key < Sk
        // and, under the causal mask, key <= row: the keys of a tile past Sk
        // are TMA's zero rows, which would score 0, not be masked
        const int k0 = t * kRows;
        const bool need_mask = k0 + kRows > Sk || (causal && k0 + kRows - 1 > r0);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float pa = exp2f(sacc[4 * j + e] * sl2 - l2_a);
            float pb = exp2f(sacc[4 * j + 2 + e] * sl2 - l2_b);
            if (need_mask) {
              const int col = k0 + 8 * j + 2 * tq + e;
              pa = col < hi_a ? pa : 0.0f;
              pb = col < hi_b ? pb : 0.0f;
            }
            pacc[4 * j + e] = pa * (pacc[4 * j + e] - dl_a);
            pacc[4 * j + 2 + e] = pb * (pacc[4 * j + 2 + e] - dl_b);
          }
        }
        // dQ += dS K: key columns 16 kk.. are the A fragment of k-step kk;
        // K's first kRegCols columns into the registers, its third panel,
        // if any, into the shared accumulator
        uint32_t as[4][4];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int i = 0; i < 4; ++i)
            as[kk][i] = pack_bf16(pacc[8 * kk + 2 * i], pacc[8 * kk + 2 * i + 1]);
        float r[32];
        fence_regs(dq);
        if constexpr (DP > kRegCols) {
          rope_load(r, rope_slot);
          fence_regs(r);
        }
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          Wgmma<AW>::rs(dq, as[kk], sw128_desc(k_tile + kk * 16 * 128, kPanelBytes, 1024), 1);
        if constexpr (DP > kRegCols) {
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            Wgmma<64>::rs(r, as[kk], sw128_desc(k_tile + 2 * kPanelBytes + kk * 16 * 128,
                                                kPanelBytes, 1024), 1);
        }
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(dq);
        if constexpr (DP > kRegCols) {
          fence_regs(r);
          rope_store(r, rope_slot);
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(bar_empty + 8 * s);
    }
    if (!active) continue;

    bf16* dqb = a.dq + it.b * a.sdq.b + it.h * a.sdq.h;
#pragma unroll
    for (int j = 0; j < AW / 8; ++j) {
      const int col = 8 * j + 2 * tq;
      if (col >= a.D) continue;
      if (row_a < Sq)
        *reinterpret_cast<uint32_t*>(dqb + row_a * a.sdq.s + col) =
            pack_bf16(dq[4 * j] * a.scale, dq[4 * j + 1] * a.scale);
      if (row_b < Sq)
        *reinterpret_cast<uint32_t*>(dqb + row_b * a.sdq.s + col) =
            pack_bf16(dq[4 * j + 2] * a.scale, dq[4 * j + 3] * a.scale);
    }
    if constexpr (DP > kRegCols) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = kRegCols + 8 * j + 2 * tq;
        if (col >= a.D) continue;
        const float4 v = rope_slot[j * 128];
        if (row_a < Sq)
          *reinterpret_cast<uint32_t*>(dqb + row_a * a.sdq.s + col) =
              pack_bf16(v.x * a.scale, v.y * a.scale);
        if (row_b < Sq)
          *reinterpret_cast<uint32_t*>(dqb + row_b * a.sdq.s + col) =
              pack_bf16(v.z * a.scale, v.w * a.scale);
      }
    }
  }
}

// the shared-memory ceilings of the backward's two tensor-core kernels at
// (DP, DVP), set once per instance and device
template <int DP, int DVP>
cudaError_t bwd_smem_attr() {
  static bool attr_set[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || (dev < kMaxDevices && attr_set[dev])) return err;
  err = cudaFuncSetAttribute(fa_bwd_dkdv_kernel<DP, DVP>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, BwdSmem<DP, DVP>::kBytes);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(fa_bwd_dq_kernel<DP, DVP>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               DqSmem<DP, DVP>::kBytes);
  if (err == cudaSuccess && dev < kMaxDevices) attr_set[dev] = true;
  return err;
}

// the dK/dV launch: grid (H / hpb, B, key tiles), the G / hpb blocks of a
// KV head one cluster
template <int DP, int DVP>
cudaLaunchConfig_t dkdv_config(const BwdArgs& a, cudaLaunchAttribute* cluster,
                               cudaStream_t st) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.H / a.hpb, a.B, (a.Sk + kBwdKeys - 1) / kBwdKeys);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = BwdSmem<DP, DVP>::kBytes;
  cfg.stream = st;
  cluster->id = cudaLaunchAttributeClusterDimension;
  cluster->val.clusterDim.x = a.H / a.KH / a.hpb;
  cluster->val.clusterDim.y = 1;
  cluster->val.clusterDim.z = 1;
  cfg.attrs = cluster;
  cfg.numAttrs = 1;
  return cfg;
}

// clusters of C dK/dV blocks the card holds at once at (DP, DVP)
template <int DP, int DVP>
int max_clusters(int C, int* out) {
  cudaError_t err = bwd_smem_attr<DP, DVP>();
  if (err != cudaSuccess) return static_cast<int>(err);
  BwdArgs a = {};
  a.H = C;
  a.KH = 1;
  a.B = 1;
  a.Sq = a.Sk = kBwdKeys;
  a.hpb = 1;
  cudaLaunchAttribute cluster[1];
  const cudaLaunchConfig_t cfg = dkdv_config<DP, DVP>(a, cluster, nullptr);
  return static_cast<int>(
      cudaOccupancyMaxActiveClusters(out, fa_bwd_dkdv_kernel<DP, DVP>, &cfg));
}

// Query heads a dK/dV block walks, hpb = G / C for the divisor C <= 8 of G
// (the cluster) that minimises the launch's estimated makespan in (head,
// query tile) steps: max(all steps / SMs the card fills with clusters of C,
// the longest block's steps), the larger C on a tie.  The steps are those
// of the walk launched: every key tile meets every query tile, or under
// the causal mask key tile kb the query tiles from kb on (the triangle,
// clipped at Sq and Sk).  Clusters of G full-SM blocks pack unevenly into
// the GPCs (17 of 6 at once on an H100, 102 SMs); smaller clusters fill
// more SMs with longer blocks.  The occupancy is looked up once a device,
// instance and C.  `ops.backward_plan` makes the same choice from the same
// numbers.
template <int DP, int DVP>
int heads_a_block(int B, int H, int G, int Sq, int Sk, int causal, int* hpb) {
  static int at_once[kMaxDevices][kMaxGroup + 1] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t n_qt = (Sq + kRows - 1) / kRows, n_kt = (Sk + kBwdKeys - 1) / kBwdKeys;
  int64_t pairs = 0;  // (key tile, query tile) steps a head
  for (int64_t kb = 0; kb < n_kt; ++kb) pairs += causal ? (n_qt > kb ? n_qt - kb : 0) : n_qt;
  const double steps = static_cast<double>(B) * H * pairs;
  double best = 0.0;
  *hpb = 0;
  for (int C = G < kMaxGroup ? G : kMaxGroup; C >= 1; --C) {
    if (G % C != 0) continue;
    int n = dev < kMaxDevices ? at_once[dev][C] : 0;
    if (n == 0) {
      err = static_cast<cudaError_t>(max_clusters<DP, DVP>(C, &n));
      if (err != cudaSuccess) return static_cast<int>(err);
      if (dev < kMaxDevices) at_once[dev][C] = n;
    }
    if (n == 0) continue;
    const double spread = steps / (static_cast<double>(C) * n);
    const double longest = static_cast<double>(G / C) * n_qt;  // key tile 0's walk
    const double est = spread > longest ? spread : longest;
    if (*hpb == 0 || est < best) {
      best = est;
      *hpb = G / C;
    }
  }
  return *hpb == 0 ? static_cast<int>(cudaErrorInvalidConfiguration) : 0;
}

template <int DP, int DVP>
int launch_bwd(const CUtensorMap (&maps)[4], BwdArgs a, cudaStream_t st) {
  cudaError_t err = bwd_smem_attr<DP, DVP>();
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_sm = sm_count(dev);
  if (n_sm == 0) return static_cast<int>(cudaErrorInvalidDevice);
  const int e = heads_a_block<DP, DVP>(a.B, a.H, a.H / a.KH, a.Sq, a.Sk, a.causal, &a.hpb);
  if (e != 0) return e;
  const int64_t n_rows = static_cast<int64_t>(a.B) * a.H * a.Sp;
  const int64_t delta_rows = 256 / kDeltaLanes;  // rows a block
  fa_bwd_delta_kernel<<<static_cast<unsigned>((n_rows + delta_rows - 1) / delta_rows), 256, 0,
                        st>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute cluster[1];
  const cudaLaunchConfig_t cfg = dkdv_config<DP, DVP>(a, cluster, st);
  err = cudaLaunchKernelEx(&cfg, fa_bwd_dkdv_kernel<DP, DVP>, maps[0], maps[1], maps[2], maps[3],
                           a);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_items = (a.Sq + kConsumers * kRows - 1) / (kConsumers * kRows) * a.H * a.B;
  fa_bwd_dq_kernel<DP, DVP><<<min(n_items, n_sm), kThreads, DqSmem<DP, DVP>::kBytes, st>>>(
      maps[0], maps[1], maps[2], maps[3], a);
  return static_cast<int>(cudaGetLastError());
}

template <int N>
using Dim = std::integral_constant<int, N>;

// f(Dim<DP>, Dim<DVP>) at the instance for head_dim D and v's width Dv,
// the forward's and the backward's: (DP, DP) for each padded head_dim, and
// (192, 128); cudaErrorInvalidValue for a pair no instance takes (the
// wrapper pads v to one: `ops.grad_v_width`)
template <typename F>
int instance(int D, int Dv, F&& f) {
  const int dp = padded_dim(D), dvp = padded_dim(Dv);
  if (dp == kMaxD && dvp == kRegCols) return f(Dim<kMaxD>{}, Dim<kRegCols>{});
  if (dp != dvp) return static_cast<int>(cudaErrorInvalidValue);
  switch (dp) {
    case 16: return f(Dim<16>{}, Dim<16>{});
    case 32: return f(Dim<32>{}, Dim<32>{});
    case 48: return f(Dim<48>{}, Dim<48>{});
    case 64: return f(Dim<64>{}, Dim<64>{});
    case 80: return f(Dim<80>{}, Dim<80>{});
    case 96: return f(Dim<96>{}, Dim<96>{});
    case 112: return f(Dim<112>{}, Dim<112>{});
    case 128: return f(Dim<128>{}, Dim<128>{});
    default: return f(Dim<kMaxD>{}, Dim<kMaxD>{});
  }
}

// the bf16 forward through `fa_forward`'s maps (q and k D wide, v and o
// Dv); LSE: the training instance
template <bool LSE>
int forward_bf16(const void* q, const void* k, const void* v, void* o, Strides sq, Strides sk,
                 Strides sv, Strides so, int B, int H, int KH, int Sq, int Sk, int D, int Dv,
                 float scale, int causal, float* lse, cudaStream_t st) {
  const cudaError_t bound = bind_device();
  if (bound != cudaSuccess) return static_cast<int>(bound);
  CUtensorMap maps[4];
  if (!encode(&maps[0], q, D, H, Sq, B, sq) || !encode(&maps[1], k, D, KH, Sk, B, sk) ||
      !encode(&maps[2], v, Dv, KH, Sk, B, sv) || !encode(&maps[3], o, Dv, H, Sq, B, so))
    return static_cast<int>(cudaErrorInvalidValue);
  return instance(D, Dv, [&](auto dp, auto dvp) {
    return launch<decltype(dp)::value, decltype(dvp)::value, LSE>(maps, B, H, KH, Sq, Sk, D, Dv,
                                                                  scale, causal, lse, st);
  });
}

// the bf16 forward's arguments: head_dim and v's width multiples of 8, v
// no wider than q and k, up to kMaxD
bool forward_takes(int D, int Dv, int B, int H, int KH, int Sq, int Sk) {
  return D >= 8 && D <= kMaxD && D % 8 == 0 && Dv >= 8 && Dv <= D && Dv % 8 == 0 && KH >= 1 &&
         H % KH == 0 && B >= 1 && Sq >= 1 && Sk >= 1;
}

}  // namespace

// q, k (D wide), v and o (Dv wide, Dv <= D; (D, Dv) must round to an
// instance, `instance`), each at its own strides with head_dim contiguous
extern "C" int fa_forward(const void* q, const void* k, const void* v, void* o,
                          int64_t sqb, int64_t sqh, int64_t sqs,
                          int64_t skb, int64_t skh, int64_t sks,
                          int64_t svb, int64_t svh, int64_t svs,
                          int64_t sob, int64_t soh, int64_t sos,
                          int B, int H, int KH, int Sq, int Sk, int D, int Dv, float scale,
                          int causal, void* stream) {
  if (!forward_takes(D, Dv, B, H, KH, Sq, Sk)) return static_cast<int>(cudaErrorInvalidValue);
  return forward_bf16<false>(q, k, v, o, Strides{sqb, sqh, sqs}, Strides{skb, skh, sks},
                             Strides{svb, svh, svs}, Strides{sob, soh, sos}, B, H, KH, Sq, Sk,
                             D, Dv, scale, causal, nullptr, static_cast<cudaStream_t>(stream));
}

// The training forward: fa_forward's arguments and `lse`, an f32
// (B, H, Sq) output of each query row's log-sum-exp (natural base) of its
// scaled, masked scores.
extern "C" int fa_forward_lse(const void* q, const void* k, const void* v, void* o,
                              int64_t sqb, int64_t sqh, int64_t sqs,
                              int64_t skb, int64_t skh, int64_t sks,
                              int64_t svb, int64_t svh, int64_t svs,
                              int64_t sob, int64_t soh, int64_t sos,
                              int B, int H, int KH, int Sq, int Sk, int D, int Dv, float scale,
                              int causal, void* lse, void* stream) {
  if (!forward_takes(D, Dv, B, H, KH, Sq, Sk)) return static_cast<int>(cudaErrorInvalidValue);
  return forward_bf16<true>(q, k, v, o, Strides{sqb, sqh, sqs}, Strides{skb, skh, sks},
                            Strides{svb, svh, svs}, Strides{sob, soh, sos}, B, H, KH, Sq, Sk,
                            D, Dv, scale, causal, static_cast<float*>(lse),
                            static_cast<cudaStream_t>(stream));
}

// out[0..11]: the bf16 forward's launch shape at these shapes on the
// current device, as `fa_forward` launches it: the instance (DP, DVP),
// query rows a consumer warpgroup, keys a K/V tile, consumer warpgroups,
// ring stages, dynamic shared-memory bytes, work items, blocks, 1 where the
// products overlap the softmax (0: each tile in turn), the (batch, head)
// pairs a chunk of the work order takes, and 1 where the warpgroups take
// turns.
extern "C" int fa_forward_plan(int B, int H, int KH, int Sq, int Sk, int D, int Dv, int causal,
                               int* out) {
  if (!forward_takes(D, Dv, B, H, KH, Sq, Sk)) return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_sm = sm_count(dev);
  if (n_sm == 0) return static_cast<int>(cudaErrorInvalidDevice);
  const FwdChoice c = forward_choice(B, H, KH, Sq, Sk, D, Dv, causal, n_sm);
  return instance(D, Dv, [&](auto dp, auto dvp) {
    constexpr int DP = decltype(dp)::value, DVP = decltype(dvp)::value;
    int smem = FwdSmem<DP, DVP, kRows>::kBytes;
    if constexpr (DP <= 64) {
      if (c.keys == 128) smem = FwdSmem<DP, DVP, 128>::kBytes;
    }
    const int plan[12] = {DP, DVP, kRows, c.keys, kConsumers, FwdSmem<DP, DVP, kRows>::kStages,
                          smem, c.items, c.grid, c.overlap, c.chunk, c.turns};
    for (int i = 0; i < 12; ++i) out[i] = plan[i];
    return 0;
  });
}

// The backward of bf16 attention, Sq query rows over Sk keys, causal
// (top-left, as the forward) or not: dq, dk (D wide), dv (Dv wide; each at
// its own strides, head_dim contiguous, rows 4-byte aligned) from q, k (D
// wide), v, the forward's o, dout (Dv wide) and lse.  delta: an f32 scratch
// of 2 B H Sp values, Sp = Sq rounded up to 64 (Delta, then lse in base 2).
// q, k, v and dout are read through TMA, o by 16-byte loads: their rows
// must be 16-byte aligned (D and Dv multiples of 8, every stride a multiple
// of 8 elements); D <= 192, and (D, Dv) must round to an instance
// (`instance`); any number of query heads a KV head.
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
                           int B, int H, int KH, int Sq, int Sk, int D, int Dv, float scale,
                           int causal, void* stream) {
  if (D < 8 || D > kBwdMaxD || D % 8 != 0 || Dv < 8 || Dv > D || Dv % 8 != 0 || KH < 1 ||
      H % KH != 0 || Sq < 1 || Sk < 1 || B < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t bound = bind_device();
  if (bound != cudaSuccess) return static_cast<int>(bound);
  CUtensorMap maps[4];
  if (!encode(&maps[0], q, D, H, Sq, B, Strides{sqb, sqh, sqs}) ||
      !encode(&maps[1], k, D, KH, Sk, B, Strides{skb, skh, sks}) ||
      !encode(&maps[2], v, Dv, KH, Sk, B, Strides{svb, svh, svs}) ||
      !encode(&maps[3], dout, Dv, H, Sq, B, Strides{sgb, sgh, sgs}))
    return static_cast<int>(cudaErrorInvalidValue);
  BwdArgs a;
  a.o = static_cast<const bf16*>(o);
  a.dout = static_cast<const bf16*>(dout);
  a.dq = static_cast<bf16*>(dq);
  a.dk = static_cast<bf16*>(dk);
  a.dv = static_cast<bf16*>(dv);
  a.lse = static_cast<const float*>(lse);
  a.scratch = static_cast<float*>(delta);
  a.so = Strides{sob, soh, sos};
  a.sdo = Strides{sgb, sgh, sgs};
  a.sdq = Strides{sdqb, sdqh, sdqs};
  a.sdk = Strides{sdkb, sdkh, sdks};
  a.sdv = Strides{sdvb, sdvh, sdvs};
  a.B = B;
  a.H = H;
  a.KH = KH;
  a.Sq = Sq;
  a.Sk = Sk;
  a.Sp = (Sq + kRows - 1) / kRows * kRows;
  a.D = D;
  a.Dv = Dv;
  a.causal = causal != 0;
  a.hpb = 1;  // launch_bwd chooses
  a.scale = scale;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return instance(D, Dv, [&](auto dp, auto dvp) {
    return launch_bwd<decltype(dp)::value, decltype(dvp)::value>(maps, a, st);
  });
}

// *out: the clusters of C blocks of the backward's dK/dV kernel at head_dim
// D and v's width Dv that the current device holds at once
// (cudaOccupancyMaxActiveClusters at the kernel's shared memory and threads).
extern "C" int fa_backward_max_clusters(int C, int D, int Dv, int* out) {
  if (C < 1 || C > kMaxGroup || D < 8 || D > kBwdMaxD || D % 8 != 0 || Dv < 8 || Dv > D ||
      Dv % 8 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  return instance(D, Dv, [&](auto dp, auto dvp) {
    return max_clusters<decltype(dp)::value, decltype(dvp)::value>(C, out);
  });
}

// *out: the query heads a dK/dV block of `fa_backward` walks at these
// shapes on the current device (its cluster holds G / *out blocks).
extern "C" int fa_backward_heads(int B, int H, int KH, int Sq, int Sk, int causal, int D, int Dv,
                                 int* out) {
  if (D < 8 || D > kBwdMaxD || D % 8 != 0 || Dv < 8 || Dv > D || Dv % 8 != 0 || KH < 1 ||
      H % KH != 0 || Sq < 1 || Sk < 1 || B < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int G = H / KH, c = causal != 0;
  return instance(D, Dv, [&](auto dp, auto dvp) {
    return heads_a_block<decltype(dp)::value, decltype(dvp)::value>(B, H, G, Sq, Sk, c, out);
  });
}

// The f32 route: fa_forward's arguments and Dv, v's width (at most D; its
// own, unpadded), f32 tensors at any stride with a unit head_dim stride.
extern "C" int fa_forward_f32(const void* q, const void* k, const void* v, void* o,
                              int64_t sqb, int64_t sqh, int64_t sqs,
                              int64_t skb, int64_t skh, int64_t sks,
                              int64_t svb, int64_t svh, int64_t svs,
                              int64_t sob, int64_t soh, int64_t sos,
                              int B, int H, int KH, int Sq, int Sk, int D, int Dv, float scale,
                              int causal, void* stream) {
  if (D < 1 || D > kMaxD || Dv < 1 || Dv > D || KH < 1 || H % KH != 0 || B < 1 || Sq < 1 ||
      Sk < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const F32Plan p = f32_plan(Sq, D, Dv);
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
  a.B = B;
  a.Sq = Sq;
  a.Sk = Sk;
  a.D = D;
  a.Dv = Dv;
  a.Dp = (D + 3) / 4 * 4;
  a.DVp = (Dv + 3) / 4 * 4;
  a.qs = p.qs;
  a.vs = p.vs;
  a.scale_log2 = scale * kLog2e;
  a.causal = causal;
  const int rows = kF32Groups * p.tm;
  a.n_qt = (Sq + rows - 1) / rows;
  a.flags = (D % 4 == 0 && rows_aligned(q, a.sq, B, H, Sq) ? 1 : 0) |
            (D % 4 == 0 && rows_aligned(k, a.sk, B, KH, Sk) ? 2 : 0) |
            (Dv % 4 == 0 && rows_aligned(v, a.sv, B, KH, Sk) ? 4 : 0) |
            (Dv % 4 == 0 && rows_aligned(o, a.so, B, H, Sq) ? 8 : 0);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return p.tm == 2 ? dispatch_f32<2>(a, p, st) : dispatch_f32<4>(a, p, st);
}

// out[0..4]: the f32 route's query rows a block, keys a K/V tile, ring
// buffers, dynamic shared-memory bytes and output chunks a thread at
// (Sq, D, Dv), as `fa_forward_f32` launches it.
extern "C" int fa_forward_f32_plan(int Sq, int D, int Dv, int* out) {
  if (D < 1 || D > kMaxD || Dv < 1 || Dv > D || Sq < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const F32Plan p = f32_plan(Sq, D, Dv);
  out[0] = kF32Groups * p.tm;
  out[1] = kF32Lanes * p.tn;
  out[2] = kF32Stages;
  out[3] = p.smem;
  out[4] = p.cv;
  return 0;
}
