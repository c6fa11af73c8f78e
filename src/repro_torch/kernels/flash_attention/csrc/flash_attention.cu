// Causal GQA flash attention (prefill, Sq == Sk) for Hopper (sm_90a), bf16.
//
// Replaces the Pallas TPU kernel `flash_attention` (`_flash_kernel`) of
// src/repro/kernels/flash_attention/kernel.py: online softmax with f32
// running max m, running sum l and accumulator, scale D^-0.5, masked scores
// set to -1e30, query head h reading KV head h / (H / KH).  The causal mask
// keeps k_pos <= q_pos, aligned top-left, which equals the bottom-right mask
// of the reference oracle only when Sq == Sk; the wrapper enforces that.
//
// Bound on the card: at the serving shapes (S = 128, D = 80) the work per
// byte is low (about S/2 multiply-adds per loaded element), so device memory
// bounds it.  The design keeps both products on the tensor cores with
// warp-level `mma.sync.m16n8k16` (bf16 in, f32 accumulate), in the layout of
// FlashAttention-2: one block per (64-query tile, head, batch), four warps of
// 16 query rows each.  Q stays in registers as A fragments for the whole
// block; each 64-key K/V tile is staged in shared memory (V transposed, rows
// padded by 16 bytes so fragment loads hit distinct banks); the scores of a
// tile stay in registers, where the softmax runs, and are repacked to bf16
// as the A fragments of the P.V product, as the reference's chunked
// attention casts p to v's dtype.  KV tiles above the diagonal are skipped,
// not masked.  head_dim is padded with zeros to the next multiple of 16 in
// shared memory only (exact: zero terms add nothing), so 80 runs as 80 in
// five k-steps; sequence tails shorter than a tile are zero-filled and
// masked.  TMA, wgmma and a pipelined K/V ring are later work.
//
// Layout: every tensor is addressed through (batch, head, seq) element
// strides with a unit head_dim stride, so the model's (B, T, H, D) tensors
// are read and written in place, without transposed copies.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;       // query rows per block: 4 warps x 16
constexpr int kBK = 64;       // keys per K/V tile
constexpr int kThreads = 128;
constexpr int kMaxD = 128;
constexpr int kPad = 8;       // bf16 elements of row padding in shared memory
constexpr float kNegInf = -1e30f;

using bf16 = __nv_bfloat16;

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// D (16x8, f32) += A (16x16, bf16, row) * B (16x8, bf16, col)
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

struct Strides {
  int64_t b, h, s;  // element strides; head_dim is contiguous
};

template <int DP>
constexpr size_t smem_bytes() {
  return sizeof(bf16) * (static_cast<size_t>(kBQ) * (DP + kPad) +
                         static_cast<size_t>(kBK) * (DP + kPad) +
                         static_cast<size_t>(DP) * (kBK + kPad));
}

// DP: head_dim rounded up to a multiple of 16 (the mma k-step).
template <int DP>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, bf16* __restrict__ o, Strides sq,
                 Strides sk, Strides sv, Strides so, int H, int KH, int S,
                 int D, float scale, int causal) {
  constexpr int LD = DP + kPad;     // row pitch of Qs and Ks
  constexpr int LDV = kBK + kPad;   // row pitch of Vt
  constexpr int KSTEPS = DP / 16;   // k-steps of Q.K^T
  constexpr int NT_S = kBK / 8;     // score n-tiles per row block
  constexpr int NT_O = DP / 8;      // output n-tiles
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);  // kBQ x LD
  bf16* Ks = Qs + kBQ * LD;                      // kBK x LD
  bf16* Vt = Ks + kBK * LD;                      // DP x LDV (V transposed)

  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kh = h / (H / KH);
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;  // mma fragment coordinates
  const bf16 zero = __float2bfloat16_rn(0.0f);

  const bf16* qb = q + b * sq.b + h * sq.h;
  const bf16* kb = k + b * sk.b + kh * sk.h;
  const bf16* vb = v + b * sv.b + kh * sv.h;

  for (int idx = tid; idx < kBQ * DP; idx += kThreads) {
    const int r = idx / DP, d = idx % DP;
    Qs[r * LD + d] = (q0 + r < S && d < D) ? qb[(q0 + r) * sq.s + d] : zero;
  }
  __syncthreads();

  // this warp's 16 query rows as A fragments, for every k-step
  const int wr = warp * 16;
  uint32_t qa[KSTEPS][4];
#pragma unroll
  for (int ks = 0; ks < KSTEPS; ++ks) {
    const bf16* base = Qs + (wr + g) * LD + ks * 16 + 2 * t;
    qa[ks][0] = ld32(base);
    qa[ks][1] = ld32(base + 8 * LD);
    qa[ks][2] = ld32(base + 8);
    qa[ks][3] = ld32(base + 8 * LD + 8);
  }

  // rows g and g + 8 of the warp's block: running max, partial sum, output
  const int row0 = q0 + wr + g, row1 = row0 + 8;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.0f, l1 = 0.0f;
  float acc[NT_O][4];
#pragma unroll
  for (int i = 0; i < NT_O; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.0f;

  const int n_tiles = (S + kBK - 1) / kBK;
  const int last_q = min(q0 + kBQ, S) - 1;
  const int last_tile = causal ? min(n_tiles - 1, last_q / kBK) : n_tiles - 1;
  for (int kt = 0; kt <= last_tile; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();  // every warp is done with the previous tile
    for (int idx = tid; idx < kBK * DP; idx += kThreads) {
      const int c = idx / DP, d = idx % DP;
      const bool in = k0 + c < S && d < D;
      Ks[c * LD + d] = in ? kb[(k0 + c) * sk.s + d] : zero;
      Vt[d * LDV + c] = in ? vb[(k0 + c) * sv.s + d] : zero;
    }
    __syncthreads();

    float s[NT_S][4];
#pragma unroll
    for (int nt = 0; nt < NT_S; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.0f;
#pragma unroll
      for (int ks = 0; ks < KSTEPS; ++ks) {
        const bf16* kp = Ks + (nt * 8 + g) * LD + ks * 16 + 2 * t;
        mma_bf16(s[nt], qa[ks], ld32(kp), ld32(kp + 8));
      }
    }

    // scale, mask, and the tile's row maxima (over the 4 lanes of a row)
    float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
    for (int nt = 0; nt < NT_S; ++nt) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = k0 + nt * 8 + 2 * t + e;
        const bool ok = col < S;
        s[nt][e] = (ok && (!causal || col <= row0)) ? s[nt][e] * scale : kNegInf;
        s[nt][2 + e] = (ok && (!causal || col <= row1)) ? s[nt][2 + e] * scale : kNegInf;
        mx0 = fmaxf(mx0, s[nt][e]);
        mx1 = fmaxf(mx1, s[nt][2 + e]);
      }
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float c0 = expf(m0 - mn0), c1 = expf(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    float ps0 = 0.0f, ps1 = 0.0f;
#pragma unroll
    for (int nt = 0; nt < NT_S; ++nt) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        s[nt][e] = expf(s[nt][e] - mn0);
        s[nt][2 + e] = expf(s[nt][2 + e] - mn1);
        ps0 += s[nt][e];
        ps1 += s[nt][2 + e];
      }
    }
    l0 = l0 * c0 + ps0;  // this lane's share; the 4 lanes are summed at the end
    l1 = l1 * c1 + ps1;
#pragma unroll
    for (int i = 0; i < NT_O; ++i) {
      acc[i][0] *= c0;
      acc[i][1] *= c0;
      acc[i][2] *= c1;
      acc[i][3] *= c1;
    }

    // O += P . V: score n-tiles (2j, 2j+1) are the A fragment of k-step j
#pragma unroll
    for (int j = 0; j < kBK / 16; ++j) {
      uint32_t pa[4];
      pa[0] = pack_bf16(s[2 * j][0], s[2 * j][1]);
      pa[1] = pack_bf16(s[2 * j][2], s[2 * j][3]);
      pa[2] = pack_bf16(s[2 * j + 1][0], s[2 * j + 1][1]);
      pa[3] = pack_bf16(s[2 * j + 1][2], s[2 * j + 1][3]);
#pragma unroll
      for (int i = 0; i < NT_O; ++i) {
        const bf16* vp = Vt + (i * 8 + g) * LDV + j * 16 + 2 * t;
        mma_bf16(acc[i], pa, ld32(vp), ld32(vp + 8));
      }
    }
  }

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float den0 = fmaxf(l0, 1e-30f), den1 = fmaxf(l1, 1e-30f);
  bf16* ob = o + b * so.b + h * so.h;
#pragma unroll
  for (int i = 0; i < NT_O; ++i) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int d = i * 8 + 2 * t + e;
      if (d >= D) continue;
      if (row0 < S) ob[static_cast<int64_t>(row0) * so.s + d] = __float2bfloat16_rn(acc[i][e] / den0);
      if (row1 < S) ob[static_cast<int64_t>(row1) * so.s + d] = __float2bfloat16_rn(acc[i][2 + e] / den1);
    }
  }
}

template <int DP>
int launch(const void* q, const void* k, const void* v, void* o, Strides sq,
           Strides sk, Strides sv, Strides so, int B, int H, int KH, int S,
           int D, float scale, int causal, cudaStream_t st) {
  constexpr size_t smem = smem_bytes<DP>();
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<DP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((S + kBQ - 1) / kBQ, H, B);
  flash_fwd_kernel<DP><<<grid, kThreads, smem, st>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(o), sq, sk, sv, so, H, KH, S, D, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int fa_forward(const void* q, const void* k, const void* v, void* o,
                          int64_t sqb, int64_t sqh, int64_t sqs,
                          int64_t skb, int64_t skh, int64_t sks,
                          int64_t svb, int64_t svh, int64_t svs,
                          int64_t sob, int64_t soh, int64_t sos,
                          int B, int H, int KH, int S, int D, float scale,
                          int causal, void* stream) {
  if (D < 1 || D > kMaxD || KH < 1 || H % KH != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Strides sq{sqb, sqh, sqs}, sk{skb, skh, sks}, sv{svb, svh, svs}, so{sob, soh, sos};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch ((D + 15) / 16) {
    case 1: return launch<16>(q, k, v, o, sq, sk, sv, so, B, H, KH, S, D, scale, causal, st);
    case 2: return launch<32>(q, k, v, o, sq, sk, sv, so, B, H, KH, S, D, scale, causal, st);
    case 3: return launch<48>(q, k, v, o, sq, sk, sv, so, B, H, KH, S, D, scale, causal, st);
    case 4: return launch<64>(q, k, v, o, sq, sk, sv, so, B, H, KH, S, D, scale, causal, st);
    case 5: return launch<80>(q, k, v, o, sq, sk, sv, so, B, H, KH, S, D, scale, causal, st);
    case 6: return launch<96>(q, k, v, o, sq, sk, sv, so, B, H, KH, S, D, scale, causal, st);
    case 7: return launch<112>(q, k, v, o, sq, sk, sv, so, B, H, KH, S, D, scale, causal, st);
    default: return launch<128>(q, k, v, o, sq, sk, sv, so, B, H, KH, S, D, scale, causal, st);
  }
}
