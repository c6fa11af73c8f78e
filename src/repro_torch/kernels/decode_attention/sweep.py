"""Time decode attention's kernel under every split plan at decode shapes of
the port's models, beside the plan `split_plan` picks.  The measurement
behind `split_plan`'s thresholds; it needs an NVIDIA GPU:

    PYTHONPATH=src python -m repro_torch.kernels.decode_attention.sweep

Each shape is q (B, 1, KH * G, D) against a bf16 cache (B, S, KH, D) at
kv_len = S; each plan (splits, keys per split, block shape) is timed as the
mean device time of back-to-back calls (CUDA events, queued behind a
device-side sleep).  Prints one line a shape and, last, a JSON list of
every timing.
"""

from __future__ import annotations

import json
import subprocess
import time

import torch

from . import ops as da

# (model, B, KH, G, D, S): qwen3-14b (40 query heads over 8 KV heads, head_dim
# 128) and stablelm-3b / zamba2-2.7b (32 over 32, head_dim 80), from one
# sequence up to the (batch, KV head) counts of the smoke decode shapes
SHAPES = (
    [("qwen3-14b", B, 8, 5, 128, S) for B in (1, 2, 4, 8) for S in (1024, 4096)]
    + [("qwen3-14b", 16, 8, 5, 128, 4096)]
    + [("stablelm-3b", B, 32, 1, 80, S) for B in (1, 2) for S in (528, 2048)]
    + [("zamba2-2.7b", 4, 32, 1, 80, 528), ("stablelm-3b", 8, 32, 1, 80, 160)])
SPLITS = (1, 2, 3, 4, 6, 8)


def time_ms(fn, iters: int = 30) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    for attempt in range(4):
        ev[0].record()
        torch.cuda._sleep(int(2e7 * 4 ** attempt))
        ev[1].record()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        host = (time.perf_counter() - t0) * 1e3
        ev[2].record()
        ev[2].synchronize()
        if ev[0].elapsed_time(ev[1]) > 1.1 * host:  # the queue never ran dry
            return ev[1].elapsed_time(ev[2]) / iters
    raise RuntimeError("the host could not queue the timed calls ahead of the card")


def plans(S: int):
    """Every plan the kernel takes with splits from SPLITS: each split at
    least MIN_SPLIT_KEYS keys (one split: any S), both block shapes."""
    for n in SPLITS:
        per = -(-S // n)
        if n > 1 and (per < da.MIN_SPLIT_KEYS or S - (n - 1) * per < da.MIN_SPLIT_KEYS):
            continue
        for ring in range(len(da.RINGS)):
            yield n, per, ring


def main() -> int:
    dev = torch.device("cuda")
    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    print(f"[sweep] {gpu}; {n_sm} SMs", flush=True)
    g = torch.Generator(device=dev).manual_seed(0)
    rows = []
    for model, B, KH, G, D, S in SHAPES:
        q = torch.randn(B, 1, KH * G, D, generator=g, device=dev).to(torch.bfloat16)
        kc, vc = (torch.randn(B, S, KH, D, generator=g, device=dev).to(torch.bfloat16)
                  for _ in range(2))
        lens = torch.tensor(S, dtype=torch.int32, device=dev)
        chosen = da.split_plan(B, KH, S, n_sm)
        times = {p: time_ms(lambda p=p: da.decode_attention_bthd(q, kc, vc, lens, plan=p))
                 for p in dict.fromkeys([*plans(S), chosen])}
        best = min(times, key=times.get)
        print(f"[sweep] {model} B={B} KH={KH} G={G} D={D} S={S} ({B * KH} (batch, KV head) "
              f"pairs): split_plan {chosen} {times[chosen] * 1e3:.3f} us; best {best} "
              f"{times[best] * 1e3:.3f} us; one split "
              + ", ".join(f"{da.RINGS[r]} {times[(1, S, r)] * 1e3:.3f} us"
                          for r in range(len(da.RINGS))), flush=True)
        rows += [dict(model=model, B=B, KH=KH, G=G, D=D, S=S, plan=list(p), us=t * 1e3,
                      chosen=p == chosen) for p, t in times.items()]
    print(json.dumps(rows))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
