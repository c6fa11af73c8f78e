"""Write the inline-PTX `wgmma` headers: this directory's wgmma.cuh, the
calls flash_attention.cu uses, and ssd_scan/csrc/wgmma.cuh, those of
ssd_scan.cu's heads route (each kernel library is hashed by its own csrc/
directory, so each keeps its own header).

An `asm` statement lists every accumulator register by number, so each
instruction shape is its own statement.  Run from this directory after
changing the shapes:  python3 gen_wgmma.py
"""

from pathlib import Path

SS_N = (64, 128)  # the Ns of flash's Q.K^T product: keys a tile (128 up to head_dim 64)
# the N of flash's P.V product: each padded head_dim up to 128, then 192,
# which takes every head_dim in (128, 192]
RS_N = tuple(range(16, 129, 16)) + (192,)

FLASH_HEADER = """\
// Generated by gen_wgmma.py; do not edit.  Inline-PTX `wgmma` for sm_90a:
// bf16 operands, f32 accumulator, m64, k16.
//   Wgmma<N>::rs: A from registers (four bf16x2 a thread), B from shared
//                 memory, MN-major (the transpose bit set); N = 16, 32, ... 128
//                 and 192, the P.V product at every padded head_dim.
//   Wgmma<64>::ss, Wgmma<128>::ss: A and B from shared memory through
//                 descriptors, both K-major; the Q.K^T product of a tile
//                 of 64 or 128 keys.
// scale_d == 0 overwrites the accumulator; 1 adds to it.
#pragma once
#include <stdint.h>

template <int N> struct Wgmma;
"""

SSD_HEADER = """\
// Generated by flash_attention/csrc/gen_wgmma.py; do not edit.  Inline-PTX
// `wgmma` for sm_90a: bf16 operands, f32 accumulator, m64, k16; TB is B's
// transpose bit (0: K-major, 1: MN-major).
//   Wgmma<N, TB>::ss: A (K-major) and B from shared memory through
//                     descriptors.
//   Wgmma<64, 1, 1>::ss: the same with A MN-major (its transpose bit set).
//   Wgmma<64, 1>::rs: A from registers (four bf16x2 a thread, the mma.sync
//                     A fragment of the thread's warp), B from shared memory.
// scale_d == 0 overwrites the accumulator; 1 adds to it.
#pragma once
#include <stdint.h>

template <int N, int TB, int TA = 0> struct Wgmma;
"""

# (template arguments, N, B's transpose bit in the SS form or None for no SS
# form, the same for the RS form[, A's transpose bit in the SS form])
FLASH_SHAPES = tuple((str(n), n, 0 if n in SS_N else None, 1) for n in RS_N)
# the 16-column score chunks (K-major B), the 64-wide state terms and shares
# (B K-major or MN-major), P^T dy and the dk share (A from registers, B
# MN-major); the pairs route's dS^T q and P^T dy (A and B MN-major); the
# wide outputs' q.S and P.V over two 64-wide DV tiles (B MN-major)
SSD_SHAPES = (("16, 0", 16, 0, None), ("64, 0", 64, 0, None), ("64, 1", 64, 1, 1),
              ("64, 1, 1", 64, 1, None, 1), ("128, 1", 128, 1, None))


def operands(n_acc: int) -> str:
    return ", ".join(f'"+f"(d[{i}])' for i in range(n_acc))


def regs(first: int, count: int) -> str:
    return "{" + ", ".join(f"%{first + i}" for i in range(count)) + "}"


def shape(args: str, n: int, ss_tb: int | None, rs_tb: int | None, ss_ta: int = 0) -> str:
    acc = n // 2
    ss = (f'    asm volatile(\n'
          f'        "{{\\n.reg .pred p;\\nsetp.ne.b32 p, %{acc + 2}, 0;\\n"\n'
          f'        "wgmma.mma_async.sync.aligned.m64n{n}k16.f32.bf16.bf16 "\n'
          f'        "{regs(0, acc)}, %{acc}, %{acc + 1}, p, 1, 1, {ss_ta}, {ss_tb};\\n}}\\n"\n'
          f'        : {operands(acc)}\n'
          f'        : "l"(desc_a), "l"(desc_b), "r"(scale_d));\n')
    rs = (f'    asm volatile(\n'
          f'        "{{\\n.reg .pred p;\\nsetp.ne.b32 p, %{acc + 5}, 0;\\n"\n'
          f'        "wgmma.mma_async.sync.aligned.m64n{n}k16.f32.bf16.bf16 "\n'
          f'        "{regs(0, acc)}, {regs(acc, 4)}, %{acc + 4}, p, 1, 1, {rs_tb};\\n}}\\n"\n'
          f'        : {operands(acc)}\n'
          f'        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), '
          f'"r"(scale_d));\n')
    ss_fn = (f"  static __device__ __forceinline__ void ss(float (&d)[{acc}], uint64_t desc_a,\n"
             f"                                            uint64_t desc_b, int scale_d) {{\n"
             f"{ss}  }}\n") if ss_tb is not None else ""
    rs_fn = (f"  static __device__ __forceinline__ void rs(float (&d)[{acc}],\n"
             f"                                            const uint32_t (&a)[4],\n"
             f"                                            uint64_t desc_b, int scale_d) {{\n"
             f"{rs}  }}\n") if rs_tb is not None else ""
    return f"template <> struct Wgmma<{args}> {{\n{ss_fn}{rs_fn}}};\n"


def header(head: str, shapes) -> str:
    return head + "\n" + "\n".join(shape(*s) for s in shapes)


if __name__ == "__main__":
    here = Path(__file__).resolve().parent
    (here / "wgmma.cuh").write_text(header(FLASH_HEADER, FLASH_SHAPES))
    (here.parents[1] / "ssd_scan" / "csrc" / "wgmma.cuh").write_text(
        header(SSD_HEADER, SSD_SHAPES))
