"""Write wgmma.cuh: the inline-PTX `wgmma` calls flash_attention.cu uses.

An `asm` statement lists every accumulator register by number, so each
instruction shape is its own statement.  Run from this directory after
changing the shapes:  python3 gen_wgmma.py
"""

from pathlib import Path

SS_N = 64  # the one N the Q.K^T product uses (64 keys a tile)
# the N of the P.V product: each padded head_dim up to 128, then 192, which
# takes every head_dim in (128, 192]
RS_N = tuple(range(16, 129, 16)) + (192,)

HEADER = """\
// Generated by gen_wgmma.py; do not edit.  Inline-PTX `wgmma` for sm_90a:
// bf16 operands, f32 accumulator, m64, k16.
//   Wgmma<N>::rs: A from registers (four bf16x2 a thread), B from shared
//                 memory, MN-major (the transpose bit set); N = 16, 32, ... 128
//                 and 192, the P.V product at every padded head_dim.
//   Wgmma<64>::ss: A and B from shared memory through descriptors, both
//                 K-major; the Q.K^T product of 64 keys.
// scale_d == 0 overwrites the accumulator; 1 adds to it.
#pragma once
#include <stdint.h>

template <int N> struct Wgmma;
"""


def operands(n_acc: int) -> str:
    return ", ".join(f'"+f"(d[{i}])' for i in range(n_acc))


def regs(first: int, count: int) -> str:
    return "{" + ", ".join(f"%{first + i}" for i in range(count)) + "}"


def shape(n: int) -> str:
    acc = n // 2
    ss = (f'    asm volatile(\n'
          f'        "{{\\n.reg .pred p;\\nsetp.ne.b32 p, %{acc + 2}, 0;\\n"\n'
          f'        "wgmma.mma_async.sync.aligned.m64n{n}k16.f32.bf16.bf16 "\n'
          f'        "{regs(0, acc)}, %{acc}, %{acc + 1}, p, 1, 1, 0, 0;\\n}}\\n"\n'
          f'        : {operands(acc)}\n'
          f'        : "l"(desc_a), "l"(desc_b), "r"(scale_d));\n')
    rs = (f'    asm volatile(\n'
          f'        "{{\\n.reg .pred p;\\nsetp.ne.b32 p, %{acc + 5}, 0;\\n"\n'
          f'        "wgmma.mma_async.sync.aligned.m64n{n}k16.f32.bf16.bf16 "\n'
          f'        "{regs(0, acc)}, {regs(acc, 4)}, %{acc + 4}, p, 1, 1, 1;\\n}}\\n"\n'
          f'        : {operands(acc)}\n'
          f'        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), '
          f'"r"(scale_d));\n')
    ss_fn = (f"  static __device__ __forceinline__ void ss(float (&d)[{acc}], uint64_t desc_a,\n"
             f"                                            uint64_t desc_b, int scale_d) {{\n"
             f"{ss}  }}\n") if n == SS_N else ""
    return (f"template <> struct Wgmma<{n}> {{\n"
            f"{ss_fn}"
            f"  static __device__ __forceinline__ void rs(float (&d)[{acc}],\n"
            f"                                            const uint32_t (&a)[4],\n"
            f"                                            uint64_t desc_b, int scale_d) {{\n"
            f"{rs}  }}\n"
            f"}};\n")


if __name__ == "__main__":
    body = HEADER + "\n" + "\n".join(shape(n) for n in RS_N)
    Path(__file__).with_name("wgmma.cuh").write_text(body)
