"""The backward kernels' occupancy on an NVIDIA H100, as the card reports it.

Two launches size themselves from occupancy reads through the built
library: `rmsnorm_backward`'s persistent grid (`backward_blocks_per_sm`,
`cudaOccupancyMaxActiveBlocksPerMultiprocessor`), whose grid is also the
rows of its f32 dw partial, and `flash_attention_backward`'s dK/dV
clusters (`backward_max_clusters`, `cudaOccupancyMaxActiveClusters`).  The
meta device (the dry run) loads no library, so it reads them here: the
values an H100 80GB HBM3 at 700 W returned (torch 2.11, CUDA 12.8), for
every dK/dV instance at C = 1..8 and for the row widths the ten configs'
paths and the tests take.  `python -m repro_torch.kernels.occupancy` reads
every entry on the current card and prints those that differ;
`chip_smoke.py` holds the tables equal to the card's.
"""

from __future__ import annotations

# rmsnorm_backward's blocks an SM holds at once, by D, with 16-byte accesses
# (the launch shape follows from D and the access width,
# `ops.backward_shape`), in bf16 (dtype code 1) and f32 (0)
_BLOCKS_BF16 = {
    16: 4, 32: 4, 48: 4, 64: 4, 96: 4, 128: 4, 192: 4, 256: 4, 384: 2, 512: 2, 768: 2,
    1024: 1, 1536: 1, 2048: 1, 2560: 1, 3072: 1, 4096: 1, 5120: 1, 6144: 1, 7168: 1,
    8192: 1}
_BLOCKS_F32 = {
    16: 4, 32: 4, 48: 4, 64: 4, 96: 4, 128: 4, 192: 3, 256: 3, 384: 2, 512: 2, 768: 1,
    1024: 1, 1536: 1, 2048: 1, 2560: 1, 3072: 1, 4096: 1, 5120: 1, 6144: 1, 7168: 1,
    8192: 1}
# (D, dtype code, 16-byte accesses) -> blocks an SM
RMSNORM_BLOCKS_PER_SM: dict[tuple[int, int, bool], int] = {
    **{(D, 1, True): n for D, n in _BLOCKS_BF16.items()},
    **{(D, 0, True): n for D, n in _BLOCKS_F32.items()}}

# flash attention's dK/dV instances, (head_dim, v's width) as padded
# (`ops._padded_dim`), and the clusters of C blocks the card holds at once,
# which it read alike at every instance
_INSTANCES = [(d, d) for d in (16, 32, 48, 64, 80, 96, 112, 128, 192)] + [(192, 128)]
_CLUSTERS_OF = {1: 132, 2: 66, 3: 39, 4: 30, 5: 22, 6: 17, 7: 15, 8: 15}
# (C, D, Dv) -> clusters at once
FLASH_CLUSTERS: dict[tuple[int, int, int], int] = {
    (c, d, dv): n for d, dv in _INSTANCES for c, n in _CLUSTERS_OF.items()}


def rmsnorm_blocks_per_sm(D: int, code: int, vec: bool) -> int:
    try:
        return RMSNORM_BLOCKS_PER_SM[(D, code, bool(vec))]
    except KeyError:
        raise ValueError(f"rmsnorm_backward at D {D}, dtype code {code}, 16-byte accesses "
                         f"{bool(vec)}: no H100 reading in the table; read it on the card "
                         f"(python -m repro_torch.kernels.occupancy) and add it") from None


def flash_clusters(C: int, D: int, Dv: int) -> int:
    try:
        return FLASH_CLUSTERS[(C, D, Dv)]
    except KeyError:
        raise ValueError(f"flash_attention_backward: clusters of {C} at the ({D}, {Dv}) "
                         f"instance: no H100 reading in the table; read it on the card "
                         f"(python -m repro_torch.kernels.occupancy) and add it") from None


def read_on_card() -> tuple[dict, dict]:
    """Both tables' entries read on the current CUDA device through the
    built libraries."""
    import torch

    from .flash_attention import ops as fa
    from .rmsnorm import ops as rn

    dev = torch.cuda.current_device()
    rms = {}
    for D, code, vec in sorted(RMSNORM_BLOCKS_PER_SM):
        lanes, vpt, threads = rn.backward_shape(D, 2 if code == 1 else 4, vec)
        rms[(D, code, vec)] = rn.backward_blocks_per_sm(D, code, lanes, vpt, int(vec), threads,
                                                        dev)
    flash = {key: fa.backward_max_clusters(*key) for key in sorted(FLASH_CLUSTERS)}
    return rms, flash


def main() -> None:
    """Print both tables' entries as read on the current card, and those
    that differ from the table."""
    rms, flash = read_on_card()
    print("RMSNORM_BLOCKS_PER_SM =", rms)
    print("FLASH_CLUSTERS =", flash)
    print("differ:", {k: (RMSNORM_BLOCKS_PER_SM[k], v) for k, v in rms.items()
                      if v != RMSNORM_BLOCKS_PER_SM[k]}
          | {k: (FLASH_CLUSTERS[k], v) for k, v in flash.items() if v != FLASH_CLUSTERS[k]})


if __name__ == "__main__":
    main()
