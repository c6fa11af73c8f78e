"""Phase 2's flash-attention backward rows of `chip_smoke.py`, alone.

Builds the kernel libraries (phase 1, with `ptxas`'s registers and spills
of every instance; nvcc's log of flash_attention.cu, C75xx notes
included, is written beside `--out`), then runs
`chip_smoke.check_flash_backward`: each row of `grad_shapes_flash`
checked against the f32 plain backward, bit-equal run to run and in a
graph's replay, and timed hot and cold L2 beside its bound and SDPA's
backward, split by launch; with `--parent ROOT`, in turns with that
tree's backward (and its gradients compared).  `--sweep` also splits the
backward by launch at Sq 128-1024 over 1024 keys.  Writes the rows as
JSON to `--out`.

    python3 scripts/flash_backward_rows.py --parent _trees/parent [--only encoder] [--sweep]

Needs an NVIDIA GPU and nvcc, as `chip_smoke.py` does.
"""

from __future__ import annotations

import argparse
import functools
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def sweep(cs, dev, g) -> list[dict]:
    """Delta, dK/dV and dQ device times (profiler) of one backward call at
    (4, Sq, 1024, 16/16, 64), non-causal, for Sq 128 to 1024."""
    import torch

    from repro_torch.kernels.flash_attention import ops as fa

    rows = []
    for Sq in (128, 256, 512, 1024):
        B, H, Sk, D = 4, 16, 1024, 64
        q, dout = (torch.randn(B, H, Sq, D, generator=g, device=dev).bfloat16() for _ in "qd")
        k, v = (torch.randn(B, H, Sk, D, generator=g, device=dev).bfloat16() for _ in "kv")
        o = torch.empty_like(q)
        lse = fa.flash_attention_forward_lse(q, k, v, o, D ** -0.5, False)
        grads = [torch.empty_like(t) for t in (q, k, v)]
        us = cs.backward_launches_us(cs.kernel_us(functools.partial(
            fa.flash_attention_backward, q, k, v, o, dout, lse, *grads, D ** -0.5, False)))
        plan = fa.backward_plan(B, H, H, Sq, Sk, D, torch.cuda.get_device_properties(
            dev).multi_processor_count, None, False)
        rows.append(dict(Sq=Sq, items=plan.dkdv_items, steps=plan.tile_steps(0), **us))
        cs.log(f"[sweep] Sq {Sq}: {plan.dkdv_items} dK/dV items of {plan.tile_steps(0)} steps "
               f"on {plan.dkdv_grid[0]} blocks: {cs.launch_words(us)}")
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", metavar="ROOT", help="another tree of the repository")
    ap.add_argument("--only", help="the rows whose name holds this text")
    ap.add_argument("--out", default="chiprun_out/flash_backward_rows.json")
    ap.add_argument("--sweep", action="store_true",
                    help="also split the backward by launch at seamless's widths (4 x 16 "
                         "heads of 64) over 1024 keys, non-causal, at Sq 128 to 1024: how a "
                         "launch's time grows with the steps a dK/dV item walks")
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    import torch

    import chip_smoke as cs

    if not torch.cuda.is_available():
        print("flash_backward_rows.py: no CUDA device", file=sys.stderr)
        return 3
    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    parent = cs.load_parent(Path(args.parent).resolve()) if args.parent else None
    cs.phase_build(parent)
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    trees = {"": sys.modules["repro_torch.kernels._lib"]}
    if parent is not None:
        trees["parent_"] = sys.modules["parent_kernels._lib"]
    for tag, lib in trees.items():  # nvcc's whole log, C75xx notes included
        log = lib.lib_path("flash_attention").with_suffix(".log")
        (out.parent / f"{out.stem}_{tag}ptxas.log").write_text(log.read_text())
        notes = [line for line in log.read_text().splitlines() if "C75" in line]
        cs.log(f"[build] {tag or 'this '}tree's flash_attention: {len(notes)} C75xx notes"
               + "".join(f"\n  {line.strip()}" for line in notes[:8]))
    cs.log(f"[env] nvidia-smi: {cs.gpu_line()}; torch {torch.__version__}, "
           f"CUDA {torch.version.cuda}")
    g = torch.Generator(device=dev).manual_seed(cs.SEED)
    fwd, bwd = cs.check_flash_backward(dev, g, parent, args.only)
    result = {"gpu": cs.gpu_line(), "forward_lse": fwd["shapes"], "backward": bwd["shapes"]}
    if args.sweep:
        result["sweep"] = sweep(cs, dev, g)
    out.write_text(json.dumps(result, indent=1))
    cs.log(f"[done] {len(bwd['shapes'])} rows in {time.perf_counter() - t0:.1f} s, "
           f"written to {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
