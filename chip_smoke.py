#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (src/repro_torch) on one NVIDIA GPU.

Run from a checkout of the repository:

    python3 chip_smoke.py

Phases, each of which must pass (any failure raises and exits non-zero):

1. build the five CUDA libraries from `src/repro_torch/kernels/*/csrc` with
   nvcc for sm_90a, one nvcc per source, in parallel;
2. hold every kernel against its plain PyTorch version on the card at the
   main paths' shapes (quantize bit-equal at every launch instance, and
   timed at the serve boundary, decode, narrow and long shapes;
   rmsnorm, flash and decode attention at every shape the smoke paths
   run, flash attention's f32 route also at tests/test_kernels.py's f32
   shapes and non-causal, rmsnorm also at qwen3-14b's qk_norm and decode
   attention at one that splits the sequence; ssd_scan in f32 with q and k
   broadcast or per head, with and without log_i, and in bf16), and time
   it beside its bound, its plain version and one PyTorch library call (a
   yardstick only; the port never calls it), with the host time of one
   call;
3. serve stablelm-3b at full width (32 layers, random weights from a seed)
   through the port's public entry point, `repro_torch.api.Session`, on
   one h100 and eight l4 stand-ins (every pool co-resident on the card),
   in three acts, the counterpart of examples/serve_pipeline.py: the MILP
   plan deployed for real on a Poisson and a bursty trace; a hand-pinned
   2-stage pooled plan through `use_plan`, calibrated on the card, with
   measured feedback; a live `swap` to another partitioning warmed on a
   background thread.  Every stage runs as a CUDA graph captured at
   deploy (or in the swap's warm) and replayed; a stage call that finds
   no graph fails the phase.  Every request must be served with no
   executor failure (the data plane would drop the batch of a kernel that
   failed), and serving must launch the RMSNorm and attention kernels
   (counted through the replays).  The pinned plan's stages are then run
   as served and eagerly, in turns, for the device busy share and stage
   times of either;
4. check the full-width stage split through the kernels against the plain
   PyTorch math on the same parameters: layer by layer from the same input,
   and the whole forward by the decisive-margin top-1 rule;
5. decode through the model API (`build_model(cfg).prefill` then greedy
   `decode_step`): stablelm-3b on the serve phase's parameters (8 prompts
   of 128 tokens, 32 steps) and zamba2-2.7b at full width (54 layers,
   random weights from a seed; 4 prompts of 512 tokens, 16 steps).  Each
   step's logits are held to the teacher-forced forward (the serving
   invariant) in bf16, beside witnesses from the same tokens: the plain
   math in bf16, and the kernels in f32, where the dense model must hold
   the invariant at decisive positions.  A fresh prefill and one step are
   held, cache slot by cache slot, to the layers walked one at a time;
   every layer of every group is held to the plain math, and its decode
   form to its full form, from the same input; the launch counts show the
   path ran rmsnorm, flash_attention, decode_attention and ssd_scan; a
   profiler window over one prefill of each model reads its device busy
   share and top kernels.

With `--parent ROOT` (another tree of the repository, such as the parent
commit unpacked), every kernel that tree has is built too, timed in turns
with this tree's at the same inputs, and run in a second profiled prefill.

The line before the last is a JSON object with one entry per kernel; the
last line is `{"ok": true, "device": {...}}`.  Without a CUDA device, or
outside a checkout, the script exits non-zero and prints no result.
"""

from __future__ import annotations

import contextlib
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SEED = 0
MODEL = "stablelm-3b"
SEQ = 128          # tokens per request
BATCH = 8          # unified batch of the pinned plan
N_BLOCKS = 6
CUT = 3            # blocks [0, CUT) on the 3-member l4 pool, the rest on the h100
L4_COUNT = 8       # l4 stand-ins beside the one h100
N_REQUESTS = 48    # requests a trace
SWAP_REQUESTS = 10 * N_REQUESTS  # the live swap's trace (act_swap says why)
# SLO scales (x the h100's analytic batch-1 latency): the ModelSpec default
# for the MILP act, where the planner pools l4s in front of the h100 (at 3x
# no l4 stage fits and the h100 serves alone); 8x for the swap act, whose
# MILP plan and the plan it swaps to both fit; 20x for the pinned plan,
# whose batch of 8 must pass use_plan's analytic check (its trace's SLO
# comes from the calibrated latency)
MILP_SLO_SCALE, SWAP_SLO_SCALE, PINNED_SLO_SCALE = 5.0, 8.0, 20.0
# phase 5: (arch, batch, prompt tokens, greedy decode steps)
DECODE_RUNS = (("stablelm-3b", 8, 128, 32), ("zamba2-2.7b", 4, 512, 16))
PROFILED_STEPS = 4

# NVIDIA H100 SXM data sheet (dense): HBM rate, bf16 tensor-core peak, f32
# peak outside the tensor cores.  The ssd_scan kernel's products with an f32
# operand split it into two bf16 parts (16 significant bits), two bf16
# products each: its bound counts them at half the bf16 peak.
HBM_BYTES_S = 3.35e12
BF16_FLOP_S = 989e12
BF16X2_FLOP_S = BF16_FLOP_S / 2
F32_FLOP_S = 67e12

KERNEL_SOURCES = {
    "quantize": ("src/repro_torch/kernels/boundary_quant/csrc/boundary_quant.cu",
                 "src/repro/kernels/boundary_quant/kernel.py:32"),
    "dequantize": ("src/repro_torch/kernels/boundary_quant/csrc/boundary_quant.cu",
                   "src/repro/kernels/boundary_quant/kernel.py:56"),
    "rmsnorm": ("src/repro_torch/kernels/rmsnorm/csrc/rmsnorm.cu",
                "src/repro/kernels/rmsnorm/kernel.py:26"),
    "flash_attention": ("src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention/kernel.py:70"),
    "decode_attention": ("src/repro_torch/kernels/decode_attention/csrc/decode_attention.cu",
                         "src/repro/kernels/decode_attention/kernel.py:61"),
    "ssd_scan": ("src/repro_torch/kernels/ssd_scan/csrc/ssd_scan.cu",
                 "src/repro/kernels/ssd_scan/kernel.py:75"),
}
KERNEL_NAMES = tuple(KERNEL_SOURCES)


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, iters: int = 50, warmup: int = 5) -> float:
    """Mean device time of one call: `iters` calls timed by CUDA events,
    queued behind a device-side sleep so the card runs them back to back
    (the host issues a call more slowly than the card runs these kernels;
    inputs stay hot in L2, as they are on the serving path)."""
    import torch

    for _ in range(warmup):
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
        host_ms = (time.perf_counter() - t0) * 1e3
        ev[2].record()
        ev[2].synchronize()
        if ev[0].elapsed_time(ev[1]) > 1.1 * host_ms:  # the queue never ran dry
            return ev[1].elapsed_time(ev[2]) / iters
    raise RuntimeError("the host could not queue the timed calls ahead of the card")


def host_ms(fn, calls: int = 1000) -> float:
    """Host time of one call: `calls` calls on the host clock, the card
    drained before (the wrapper's Python, its checks and launches; these
    kernels run faster than the host issues them, so the launch queue never
    fills and the host never waits on the card)."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    elapsed = time.perf_counter() - t0
    torch.cuda.synchronize()
    return elapsed / calls * 1e3


def bound_ms(nbytes: float, *work: tuple[float, float]) -> tuple[float, str]:
    """The larger of bytes over the HBM rate and the operations, each
    (count, peak rate) pair at its own rate, in ms."""
    t_bytes, t_ops = nbytes / HBM_BYTES_S, sum(ops / peak for ops, peak in work)
    return (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations")


def gpu_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


# ----------------------------------------------------------------- phase 1


def load_parent(root: Path) -> dict:
    """The kernel wrapper modules of another tree of this repository
    (`--parent ROOT`), by kernel name, one for every kernel its `_lib`
    builds; imported under the package name `parent_kernels` so they sit
    beside this tree's.  Their libraries build into that tree."""
    import importlib
    import importlib.util

    pkg = root / "src" / "repro_torch" / "kernels"
    spec = importlib.util.spec_from_file_location(
        "parent_kernels", pkg / "__init__.py", submodule_search_locations=[str(pkg)])
    module = importlib.util.module_from_spec(spec)
    sys.modules["parent_kernels"] = module
    spec.loader.exec_module(module)
    lib = importlib.import_module("parent_kernels._lib")
    return {name: importlib.import_module(f"parent_kernels.{name}.ops") for name in lib.SOURCES}


def phase_build(parent) -> None:
    from repro_torch.kernels import _lib

    t0 = time.perf_counter()
    seconds = _lib.build_all()
    if parent is not None:
        sys.modules["parent_kernels._lib"].build_all()
    log(f"[build] {len(seconds)} libraries in {time.perf_counter() - t0:.1f} s "
        f"(nvcc {_lib.nvcc_path()}, flags {' '.join(_lib.NVCC_FLAGS)})")
    for name in seconds:
        log_path = _lib.lib_path(name).with_suffix(".log")
        for line in log_path.read_text().splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build] {name}: {line.strip()}")


# ----------------------------------------------------------------- phase 2


def phase_kernels(dev, parent) -> dict:
    """Each kernel against its plain version at the serving shapes; returns
    the per-kernel measurements for the kernels line.  `parent`: the other
    tree's kernel modules (`--parent`), timed in turns with this tree's, or
    None."""
    import torch

    from repro_torch.kernels.boundary_quant import ops as bq

    g = torch.Generator(device=dev).manual_seed(SEED)
    bf16 = torch.bfloat16
    N, D = BATCH * SEQ, 2560
    res = {}

    def err(a, b) -> float:
        return float((a.float() - b.float()).abs().max())

    res["rmsnorm"] = check_rmsnorm(dev, g, err, parent)
    res["flash_attention"] = check_flash_attention(dev, g, err, parent)

    # boundary quantization: (B*S, 2560) bf16, the boundary activations
    res["quantize"], qv, s = check_quantize(dev, g, parent)
    got, want = bq.dequantize(qv, s, bf16), bq.dequantize_plain(qv, s, bf16)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        raise AssertionError(f"dequantize differs from its plain version by {err(got, want)}")
    b_ms, b_by = bound_ms(N * D + N * 4 + N * D * 2, (1.0 * N * D, F32_FLOP_S))
    ms, parent_ms = paired_ms(lambda m: m.dequantize(qv, s, bf16), bq, parent)
    res["dequantize"] = dict(
        max_abs_err=err(got, want), tol="bit-equal", ms=ms, parent_ms=parent_ms,
        plain_ms=time_ms(lambda: bq.dequantize_plain(qv, s, bf16)),
        bound_ms=b_ms, bound_by=b_by, library_ms=None,
        host_ms=host_ms(lambda: bq.dequantize(qv, s, bf16)))

    res["decode_attention"] = check_decode_attention(dev, g, err, parent)
    res["ssd_scan"] = check_ssd_scan(dev, g, err, parent)
    for name, r in res.items():
        lib_us = "none" if r["library_ms"] is None else f"{r['library_ms'] * 1e3:.1f} us"
        log(f"[kernels] {name}: max|err| {r['max_abs_err']:.3g} (tol {r['tol']}), "
            f"{r['ms'] * 1e3:.1f} us{vs_parent(r['parent_ms'])} vs bound "
            f"{r['bound_ms'] * 1e3:.2f} us ({r['bound_by']}), "
            f"plain {r['plain_ms'] * 1e3:.1f} us, library {lib_us}, "
            f"host {r['host_ms'] * 1e3:.1f} us a call")
    return res


# (N, D) of quantize's checks: every launch instance (narrow rows of 1-4
# chunks a lane, D = 1 and 7 element-wise; few narrow rows as blocks of 64,
# 96 and 128 threads of one chunk; block rows of 2, 3, 4 and 8 chunks; the
# two-pass kernel past the widest plan), ragged row counts
QUANT_ROWS = ((1023, 1), (333, 7), (1000, 96), (600, 264), (700, 520), (2000, 1024),
              (77, 264), (129, 520), (64, 1024), (1001, 2560), (9, 8200), (3, 16384),
              (3, 20000), (2, 40000))


# (what, N, D) of quantize's timed bf16 shapes: the serve's boundary
# activations first (the kernels line's time), then a decode step's
# boundary rows, a narrow and a long row count
QUANT_TIMED = (("serve boundary", BATCH * SEQ, 2560),
               ("stablelm-3b decode", DECODE_RUNS[0][1], 2560),
               ("zamba2-2.7b decode", DECODE_RUNS[1][1], 2560),
               ("narrow", 64, 1024), ("few columns", 333, 7), ("long", 4096, 2560))


def check_quantize(dev, g, parent):
    """quantize bit-equal to its plain version in bf16 and f32 at every
    launch instance, on an unaligned view and on zero and tiny rows, then
    timed (and checked again) at each bf16 shape of QUANT_TIMED.  Returns
    the kernels-line entry, whose times are the serve boundary's and whose
    `shapes` holds all, and the serve boundary's (q, scale)."""
    import torch

    from repro_torch.kernels.boundary_quant import ops as bq

    worst = 0

    def same(x, what):
        nonlocal worst
        (q, s), (qp, sp) = bq.quantize(x), bq.quantize_plain(x)
        torch.cuda.synchronize()
        n = int((q != qp).sum())
        if n or not torch.equal(s, sp):
            raise AssertionError(f"quantize ({what}) differs from its plain version: {n} values, "
                                 f"scales equal {torch.equal(s, sp)}")
        worst = max(worst, int((q.int() - qp.int()).abs().max()))
        return q, s

    checked = 0
    for dtype in (torch.float32, torch.bfloat16):
        for N, D in QUANT_ROWS:
            same((torch.randn(N, D, generator=g, device=dev) * 20).to(dtype), f"{N}x{D} {dtype}")
            checked += 1
        base = (torch.randn(300 * 2560 + 3, generator=g, device=dev) * 20).to(dtype)
        same(base[3:].view(300, 2560), f"unaligned view, {dtype}")
        x = (torch.randn(4, 2560, generator=g, device=dev) * 20).to(dtype)
        x[0], x[1], x[2] = 0, x[2] * 1e-10, x[3] * 1e-12
        same(x, f"zero and tiny rows, {dtype}")
        checked += 2
    shapes, qv, s = [], None, None
    for what, N, D in QUANT_TIMED:
        h = (torch.randn(N, D, generator=g, device=dev) * 20).to(torch.bfloat16)
        q, sc = same(h, f"{what} shape")
        if qv is None:
            qv, s = q, sc
        b_ms, b_by = bound_ms(N * D * 2 + N * D + N * 4, (3.0 * N * D, F32_FLOP_S))
        ms, parent_ms = paired_ms(lambda m: m.quantize(h), bq, parent)
        plan = list(bq.launch_plan(D, 2, N, torch.cuda.get_device_properties(dev)
                                   .multi_processor_count))
        r = dict(shape=[N, D], what=what, plan=plan, max_abs_err=float(worst), tol="bit-equal",
                 ms=ms, parent_ms=parent_ms, plain_ms=time_ms(lambda: bq.quantize_plain(h)),
                 bound_ms=b_ms, bound_by=b_by, library_ms=None,
                 host_ms=host_ms(lambda: bq.quantize(h)))
        log(f"[kernels] quantize at the {what} shape ({N}, {D}) bf16, {plan[0]} lanes x "
            f"{plan[1]} chunks a row: {ms * 1e3:.3f} us{vs_parent(parent_ms)} vs bound "
            f"{b_ms * 1e3:.3f} us ({b_by}), plain {r['plain_ms'] * 1e3:.3f} us; host "
            f"{r['host_ms'] * 1e3:.3f} us a call")
        shapes.append(r)
    log(f"[kernels] quantize bit-equal to its plain version at {checked + len(shapes)} (N, D, "
        f"dtype) cases (every launch instance, ragged N, an unaligned view, zero and tiny rows, "
        f"the timed shapes)")
    return dict(shapes[0], max_abs_err=float(worst), shapes=shapes), qv, s


def paired_ms(call, ops, parent, **kw) -> tuple[float, float | None]:
    """Device time of `call(ops)`, `ops` this tree's wrapper module of a
    kernel, and, under `--parent`, of `call` on the other tree's module of
    the same kernel, timed in turns (parent, this, this, parent) and
    averaged; None for the parent where there is none or it lacks the
    kernel."""
    other = (parent or {}).get(ops.__name__.split(".")[-2])
    if other is None:
        return time_ms(lambda: call(ops), **kw), None
    p0, t0, t1, p1 = (time_ms(lambda m=m: call(m), **kw) for m in (other, ops, ops, other))
    return (t0 + t1) / 2, (p0 + p1) / 2


def vs_parent(parent_ms: float | None) -> str:
    return "" if parent_ms is None else f", parent {parent_ms * 1e3:.3f} us"


def kernel_us(fn, calls: int = 20) -> dict[str, float]:
    """Device time a call of each kernel `fn` launches, by kernel name, from
    torch.profiler over `calls` calls (after one warm-up call)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return {e.key.replace("(anonymous namespace)::", "").removeprefix("void ").split("(")[0]:
            e.device_time_total / calls
            for e in prof.key_averages()
            if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA}


def rmsnorm_shapes() -> list[tuple[str, int, int]]:
    """(what, rows, D) at every shape the smoke paths launch rmsnorm at, and
    qwen3-14b's qk_norm over 8 x 128 tokens of 40 heads, which no smoke path
    runs."""
    _, B, S, _ = DECODE_RUNS[1]
    return [("serve", BATCH * SEQ, 2560), ("stablelm-3b decode", DECODE_RUNS[0][1], 2560),
            ("zamba2-2.7b prefill", B * S, 2560),
            ("zamba2-2.7b prefill, Mamba2 gated norm", B * S, 5120),
            ("zamba2-2.7b decode", B, 2560), ("zamba2-2.7b decode, Mamba2 gated norm", B, 5120),
            ("qwen3-14b qk_norm (no smoke path)", 8 * 128 * 40, 128)]


def check_rmsnorm(dev, g, err, parent) -> dict:
    """bf16 rows at every shape of `rmsnorm_shapes`, held to the plain
    version at `tol(bf16)` and bit-equal run to run, timed beside F.rms_norm.
    The line's times are the serve shape's; `shapes` holds all."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.rmsnorm import ops as rn
    from repro_torch.testing.parity import tol

    bf16 = torch.bfloat16
    shapes = []
    for what, N, D in rmsnorm_shapes():
        x = (torch.randn(N, D, generator=g, device=dev) * 3).to(bf16)
        w = torch.randn(D, generator=g, device=dev).to(bf16)
        got, again, want = rn.rmsnorm(x, w), rn.rmsnorm(x, w), rn.rmsnorm_plain(x, w)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, **tol(bf16))
        if not torch.equal(got, again):
            raise AssertionError(f"rmsnorm ({what}): two calls differ")
        b_ms, b_by = bound_ms(2 * N * D * 2 + D * 2, (4.0 * N * D, F32_FLOP_S))
        ms, parent_ms = paired_ms(lambda m: m.rmsnorm(x, w), rn, parent)
        r = dict(
            shape=[N, D], what=what, plan=list(rn.launch_plan(D, 2)), max_abs_err=err(got, want),
            tol=tol(bf16), ms=ms, parent_ms=parent_ms,
            plain_ms=time_ms(lambda: rn.rmsnorm_plain(x, w)), bound_ms=b_ms, bound_by=b_by,
            library_ms=time_ms(lambda: F.rms_norm(x, (D,), w, 1e-5)),
            host_ms=host_ms(lambda: rn.rmsnorm(x, w)))
        log(f"[kernels] rmsnorm at the {what} shape ({N}, {D}) bf16, {r['plan'][0]} lanes x "
            f"{r['plan'][1]} vectors a row: {ms * 1e3:.3f} us{vs_parent(parent_ms)} vs bound "
            f"{b_ms * 1e3:.3f} us ({b_by}), F.rms_norm {r['library_ms'] * 1e3:.3f} us, plain "
            f"{r['plain_ms'] * 1e3:.3f} us; host {r['host_ms'] * 1e3:.3f} us a call; max|err| "
            f"{r['max_abs_err']:.3g}; bit-equal run to run")
        shapes.append(r)
    return dict(shapes[0], max_abs_err=max(r["max_abs_err"] for r in shapes), shapes=shapes)


def check_flash_attention(dev, g, err, parent) -> dict:
    """In the model layout (B, T, H, D), as served, at both prefill shapes
    the smoke paths run: the serve's (8, 128, 32, 80) and zamba2-2.7b's
    (4, 512, 32, 80).  Each against its plain version and, bit for bit, the
    same inputs as contiguous (B, H, S, D) copies.  The line's times are the
    serve shape's; `shapes` holds both."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.testing.parity import attn_tol

    bf16, H, HD = torch.bfloat16, 32, 80
    shapes = []
    for what, B, S in (("serve", BATCH, SEQ), ("zamba2-2.7b prefill", *DECODE_RUNS[1][1:3])):
        q, k, v = (torch.randn(B, S, H, HD, generator=g, device=dev).to(bf16) for _ in range(3))
        qh, kh, vh = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
        got = fa.attention_bthd(q, k, v)
        want = fa.flash_attention_plain(qh, kh, vh).transpose(1, 2)
        bhsd = fa.flash_attention(qh.contiguous(), kh.contiguous(), vh.contiguous())
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, **attn_tol(bf16))
        torch.testing.assert_close(bhsd.transpose(1, 2), got, atol=0, rtol=0)
        pairs = B * H * S * (S + 1) / 2  # causal (query, key) pairs
        b_ms, b_by = bound_ms(4 * B * S * H * HD * 2, (4.0 * pairs * HD, BF16_FLOP_S))
        ms, parent_ms = paired_ms(lambda m: m.attention_bthd(q, k, v), fa, parent)
        r = dict(
            shape=[B, S, H, HD], what=what, max_abs_err=err(got, want), tol=attn_tol(bf16),
            ms=ms, parent_ms=parent_ms,
            plain_ms=time_ms(lambda: fa.flash_attention_plain(qh, kh, vh)),
            bound_ms=b_ms, bound_by=b_by,
            library_ms=time_ms(lambda: F.scaled_dot_product_attention(qh, kh, vh,
                                                                      is_causal=True)),
            host_ms=host_ms(lambda: fa.attention_bthd(q, k, v)))
        log(f"[kernels] flash_attention at the {what} shape (B, T, H, D) = ({B}, {S}, {H}, "
            f"{HD}): {ms * 1e3:.3f} us{vs_parent(parent_ms)} vs bound {b_ms * 1e3:.3f} us "
            f"({r['bound_by']}), plain {r['plain_ms'] * 1e3:.3f} us, SDPA "
            f"{r['library_ms'] * 1e3:.3f} us; host {r['host_ms'] * 1e3:.3f} us a call; "
            f"max|err| {r['max_abs_err']:.3g}; bit-equal to the (B, H, S, D) copies")
        shapes.append(r)
    shapes.append(check_flash_f32(dev, g, err))
    return dict(shapes[0], max_abs_err=max(r["max_abs_err"] for r in shapes), shapes=shapes)


# (B, H, KH, S, D) of tests/test_kernels.py's flash attention sweep
FLASH_F32_SHAPES = ((2, 4, 2, 256, 64), (1, 8, 8, 128, 128), (2, 6, 2, 384, 128),
                    (1, 2, 1, 512, 64))


def check_flash_f32(dev, g, err) -> dict:
    """The f32 route (CUDA-core FMAs): held to the plain version in f32
    (TF32 off) at 3e-5, tests/test_kernels.py's f32 bound, at that file's
    four shapes and non-causal at (1, 4, 256, 64), with bf16 non-causal at
    `attn_tol`; then timed in the model layout at the serve shape (8, 128,
    32, 80), the shape phase 5's f32 witness prefills stablelm-3b at.
    Returns the shapes entry of that time."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.testing.parity import attn_tol, tol

    f32 = torch.float32
    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("TF32 is on: the plain f32 version would not be an f32 oracle")
    worst = 0.0
    cases = [(shape, True, f32) for shape in FLASH_F32_SHAPES]
    cases += [((1, 4, 4, 256, 64), False, f32), ((1, 4, 4, 256, 64), False, torch.bfloat16)]
    for (B, H, KH, S, D), causal, dtype in cases:
        q = torch.randn(B, H, S, D, generator=g, device=dev).to(dtype)
        k, v = (torch.randn(B, KH, S, D, generator=g, device=dev).to(dtype) for _ in range(2))
        got = fa.flash_attention(q, k, v, causal=causal)
        want = fa.flash_attention_plain(q, k, v, causal=causal)
        torch.cuda.synchronize()
        bound = tol(dtype) if dtype == f32 else attn_tol(dtype)
        torch.testing.assert_close(got, want, **bound)
        if dtype == f32:
            worst = max(worst, err(got, want))
        log(f"[kernels] flash_attention {'f32' if dtype == f32 else 'bf16'} "
            f"{'causal' if causal else 'non-causal'} (B, H, KH, S, D) = ({B}, {H}, {KH}, {S}, "
            f"{D}): max|err| {err(got, want):.3g} (tol {bound})")
    B, S, H, HD = BATCH, SEQ, 32, 80
    q, k, v = (torch.randn(B, S, H, HD, generator=g, device=dev) for _ in range(3))
    qh, kh, vh = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    got = fa.attention_bthd(q, k, v)
    want = fa.flash_attention_plain(qh, kh, vh).transpose(1, 2)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, **tol(f32))
    worst = max(worst, err(got, want))
    pairs = B * H * S * (S + 1) / 2
    b_ms, b_by = bound_ms(4 * B * S * H * HD * 4, (4.0 * pairs * HD, F32_FLOP_S))
    r = dict(
        shape=[B, S, H, HD], what="serve shape in f32 (phase 5's f32 witness)", dtype="f32",
        max_abs_err=worst, tol=tol(f32), ms=time_ms(lambda: fa.attention_bthd(q, k, v)),
        parent_ms=None, plain_ms=time_ms(lambda: fa.flash_attention_plain(qh, kh, vh)),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=time_ms(lambda: F.scaled_dot_product_attention(qh, kh, vh, is_causal=True)),
        host_ms=host_ms(lambda: fa.attention_bthd(q, k, v)))
    log(f"[kernels] flash_attention f32 at the serve shape (B, T, H, D) = ({B}, {S}, {H}, "
        f"{HD}): {r['ms'] * 1e3:.3f} us vs bound {b_ms * 1e3:.3f} us ({b_by}), plain "
        f"{r['plain_ms'] * 1e3:.3f} us, SDPA f32 {r['library_ms'] * 1e3:.3f} us; host "
        f"{r['host_ms'] * 1e3:.3f} us a call; worst f32 max|err| {worst:.3g} (tol {tol(f32)})")
    return r


def check_decode_attention(dev, g, err, parent) -> dict:
    """At both decode shapes of phase 5, and at one that takes the split path
    (qwen3-14b, one sequence, 8 KV heads, a 4096-key cache), with kv_len =
    the full cache read from a device int32; garbage at and past kv_len must
    not change the output, and two calls must agree bit for bit.  The
    line's times are those at the stablelm-3b shape (1024 of the decode
    phase's 1168 launches); `shapes` holds all three, each with the time of
    one split beside `split_plan`'s choice where that splits."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.decode_attention import ops as da
    from repro_torch.testing.parity import attn_tol

    bf16 = torch.bfloat16
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    # (what, B, cache length, query heads, KV heads, head_dim)
    cases = [(arch, B, S + n, 32, 32, 80) for arch, B, S, n in DECODE_RUNS]
    cases.append(("qwen3-14b, one sequence (split path)", 1, 4096, 40, 8, 128))
    shapes = []
    for what, B, L, H, KH, HD in cases:
        q = torch.randn(B, 1, H, HD, generator=g, device=dev).to(bf16)
        kc, vc = (torch.randn(B, L, KH, HD, generator=g, device=dev).to(bf16) for _ in range(2))
        lens = torch.tensor(L, dtype=torch.int32, device=dev)
        got, want = da.decode_attention_bthd(q, kc, vc, lens), da.decode_attention_plain(
            q, kc, vc, lens)
        again = da.decode_attention_bthd(q, kc, vc, lens)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, **attn_tol(bf16))
        if not torch.equal(got, again):
            raise AssertionError(f"decode_attention ({what} shape): two calls differ")
        short = torch.tensor(L - 37, dtype=torch.int32, device=dev)
        before = da.decode_attention_bthd(q, kc, vc, short)
        kg, vg = kc.clone(), vc.clone()
        kg[:, L - 37:], vg[:, L - 37:] = 1e4, -1e4
        after = da.decode_attention_bthd(q, kg, vg, short)
        torch.cuda.synchronize()
        if not torch.equal(before, after):
            raise AssertionError(f"decode_attention ({what} shape): values past kv_len leak "
                                 f"into the output ({err(before, after):.3g})")
        qh, kh, vh = q.transpose(1, 2), kc.transpose(1, 2), vc.transpose(1, 2)
        gqa = {"enable_gqa": True} if H != KH else {}
        nbytes = 2 * B * L * KH * HD * 2 + 2 * B * H * HD * 2 + 4
        # q.k and p.v: bf16 operands (p enters P.V as two bf16 parts)
        b_ms, b_by = bound_ms(nbytes, (4.0 * B * H * L * HD, BF16_FLOP_S))
        plan = da.split_plan(B, KH, L, n_sm)
        ms, parent_ms = paired_ms(lambda m: m.decode_attention_bthd(q, kc, vc, lens), da, parent)
        r = dict(
            shape=[B, L, H, KH, HD], what=what, splits=list(plan), max_abs_err=err(got, want),
            tol=attn_tol(bf16), ms=ms, parent_ms=parent_ms,
            plain_ms=time_ms(lambda: da.decode_attention_plain(q, kc, vc, lens)),
            bound_ms=b_ms, bound_by=b_by,
            library_ms=time_ms(lambda: F.scaled_dot_product_attention(qh, kh, vh, **gqa)),
            host_ms=host_ms(lambda: da.decode_attention_bthd(q, kc, vc, lens)))
        note = ""
        if plan[0] > 1:  # the split path against one split of the same block shape
            one = (1, L, plan[2])
            r["one_split_ms"] = time_ms(
                lambda: da.decode_attention_bthd(q, kc, vc, lens, plan=one))
            note = f"; one split {r['one_split_ms'] * 1e3:.3f} us"
        log(f"[kernels] decode_attention at the {what} shape q ({B}, 1, {H}, {HD}), cache "
            f"({B}, {L}, {KH}, {HD}), {plan[0]} split(s) of {plan[1]} keys, "
            f"{da.RINGS[plan[2]]}: "
            f"{ms * 1e3:.3f} us{vs_parent(parent_ms)} vs bound {b_ms * 1e3:.3f} us, plain "
            f"{r['plain_ms'] * 1e3:.3f} us, SDPA {r['library_ms'] * 1e3:.3f} us{note}; host "
            f"{r['host_ms'] * 1e3:.3f} us a call; max|err| {r['max_abs_err']:.3g}; "
            f"bit-equal run to run; tail past kv_len masked")
        shapes.append(r)
    return dict(shapes[0], max_abs_err=max(r["max_abs_err"] for r in shapes), shapes=shapes)


def check_ssd_scan(dev, g, err, parent) -> dict:
    """zamba2-2.7b's Mamba2 scan: q and k one (B, T, 64) tensor broadcast over
    80 heads (head stride 0), v (B, T, 80, 64), chunk 256.  Held to the plain
    version in f32 (atol 5e-4, rtol 2e-3, tests/test_kernels.py's SSD bound)
    on y and the final state at T = 512 and at a ragged T = 300, with q and
    k broadcast or per head, with and without log_i, with gates log_g =
    -0.05 softplus(N(0, 1)) so that a 256-step chunk decays by about e^-9
    and the carried state matters; then in bf16, the model's dtype (y at
    `tol(bf16)`, the state at the f32 bound, two calls bit-equal), and
    timed there."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.ssd_scan import ops as ssd
    from repro_torch.testing.parity import tol

    _, B, S, _ = DECODE_RUNS[1]
    NH, DS, HD, chunk = 80, 64, 64, 256
    tol_f32 = dict(atol=5e-4, rtol=2e-3)

    def inputs(T, dtype, broadcast=True, with_i=False):
        shape = (B, T, DS) if broadcast else (B, T, NH, DS)
        c, bm = ((torch.randn(*shape, generator=g, device=dev) * 0.5).to(dtype)
                 for _ in range(2))
        if broadcast:
            c, bm = c[:, :, None].expand(B, T, NH, DS), bm[:, :, None].expand(B, T, NH, DS)
        v = (torch.randn(B, T, NH, HD, generator=g, device=dev) * 0.5).to(dtype)
        log_g = -0.05 * F.softplus(torch.randn(B, T, NH, generator=g, device=dev))
        log_i = (-F.softplus(torch.randn(B, T, NH, generator=g, device=dev)) if with_i
                 else None)
        return c, bm, v, log_g, log_i

    worst = 0.0
    for T in (S, 300):
        for broadcast in (True, False):
            for with_i in (False, True):
                args = inputs(T, torch.float32, broadcast, with_i)
                (y, st), (y0, st0) = (ssd.ssd_scan_bthd(*args, chunk=chunk),
                                      ssd.chunked_linear_attention_plain(*args, chunk=chunk))
                torch.cuda.synchronize()
                torch.testing.assert_close(y, y0, **tol_f32)
                torch.testing.assert_close(st, st0, **tol_f32)
                worst = max(worst, err(y, y0), err(st, st0))
                log(f"[kernels] ssd_scan f32 T={T}, q/k "
                    f"{'broadcast' if broadcast else 'per head'}, "
                    f"{'with' if with_i else 'no'} log_i: y max|err| {err(y, y0):.3g} at scale "
                    f"{float(y0.abs().max()):.3g}, state max|err| {err(st, st0):.3g} at scale "
                    f"{float(st0.abs().max()):.3g} (tol atol 5e-4, rtol 2e-3)")
    args = inputs(S, torch.bfloat16)[:4]
    y, st = ssd.ssd_scan_bthd(*args, chunk=chunk)
    y1, st1 = ssd.ssd_scan_bthd(*args, chunk=chunk)
    y0, st0 = ssd.chunked_linear_attention_plain(*args, chunk=chunk)
    torch.cuda.synchronize()
    torch.testing.assert_close(y, y0, **tol(torch.bfloat16))
    torch.testing.assert_close(st, st0, **tol_f32)
    if not (torch.equal(y, y1) and torch.equal(st, st1)):
        raise AssertionError("ssd_scan: two bf16 calls differ")
    log(f"[kernels] ssd_scan bf16 T={S}: y max|err| {err(y, y0):.3g}, state max|err| "
        f"{err(st, st0):.3g} at scale {float(st0.abs().max()):.3g}; bit-equal run to run")
    # bytes: C and B once (the broadcast is a view), v, the f32 gates, y and
    # the f32 state.  Operations: q.k over the causal (t, s) pairs of each
    # chunk has two bf16 operands (bf16 tensor cores, f32 accumulation); the
    # decayed scores times v, q times the state and the weighted k times v
    # each have an f32 operand, which the kernel splits into two bf16 parts
    nbytes = 2 * B * S * DS * 2 + B * S * NH * HD * 2 * 2 + B * S * NH * 4 + B * NH * DS * HD * 4
    ops_bf16 = ops_split = 0.0
    for c0 in range(0, S, chunk):
        lc = min(chunk, S - c0)
        pairs = lc * (lc + 1) / 2
        ops_bf16 += pairs * 2 * DS
        ops_split += pairs * 2 * HD + 2 * 2 * lc * DS * HD
    b_ms, b_by = bound_ms(nbytes, (B * NH * ops_bf16, BF16_FLOP_S),
                          (B * NH * ops_split, BF16X2_FLOP_S))
    ms, parent_ms = paired_ms(lambda m: m.ssd_scan_bthd(*args, chunk=chunk), ssd, parent)
    r = dict(
        max_abs_err=worst, tol=tol_f32, ms=ms, parent_ms=parent_ms,
        # ~80 launches a call: few calls, or the launch queue fills and the
        # host waits on the card
        plain_ms=time_ms(lambda: ssd.chunked_linear_attention_plain(*args, chunk=chunk),
                         iters=5, warmup=2),
        bound_ms=b_ms, bound_by=b_by, library_ms=None,
        host_ms=host_ms(lambda: ssd.ssd_scan_bthd(*args, chunk=chunk), calls=100))
    r["per_kernel_us"] = kernel_us(lambda: ssd.ssd_scan_bthd(*args, chunk=chunk))
    log(f"[kernels] ssd_scan's launches a call, device time each (profiler, 20 calls): "
        + ", ".join(f"{name} {us:.3f} us" for name, us in r["per_kernel_us"].items()))
    log(f"[kernels] ssd_scan at zamba2-2.7b's prefill (B, T, NH, D) = ({B}, {S}, {NH}, {HD}), "
        f"chunk {chunk}, bf16: {ms * 1e3:.3f} us{vs_parent(parent_ms)} vs bound "
        f"{b_ms * 1e3:.3f} us ({b_by}), plain {r['plain_ms'] * 1e3:.3f} us; host {r['host_ms'] * 1e3:.3f} us a call")
    return r


# ----------------------------------------------------------------- phase 3


def serve_config(slo_scale: float, feedback: str = "planned"):
    """The deployment of every serve act: full-width stablelm-3b (random
    weights from SEED) on one h100 and L4_COUNT l4 stand-ins, the shape of
    examples/serve_pipeline.py's {"tpu-hi": 1, "tpu-lo": 8}.  Every pool is
    co-resident on the one card."""
    from repro_torch.api import ClusterSpec, ModelSpec, ServeConfig

    return ServeConfig(cluster=ClusterSpec(counts={"h100": 1, "l4": L4_COUNT}),
                       models=(ModelSpec(arch=MODEL, n_blocks=N_BLOCKS, seq_len=SEQ,
                                         slo_scale=slo_scale),),
                       feedback=feedback, serve_seq_len=SEQ, seed=SEED)


def staged_plan(session, bs: int, cut: int, n_lo: int = 3):
    """A hand-pinned 2-stage pooled plan: blocks [0, cut) on an n_lo-member
    l4 pool, [cut, n) on the h100 (examples/serve_pipeline.py's act 3)."""
    from repro_torch.core import costmodel as cm
    from repro_torch.core.plan import ClusterPlan, PipelinePlan, StagePlan

    prof = session.store.profiles[MODEL]
    tbl = session.store.analytic_table(MODEL)
    cluster = session.config.cluster
    n = prof.n_blocks
    return ClusterPlan(cluster=cluster, pipelines=[PipelinePlan(
        model_name=MODEL, batch_size=bs,
        stages=(StagePlan(0, cut, "l4", 1, n_lo, tbl.partition(0, cut, "l4", 1, bs)),
                StagePlan(cut, n, "h100", 1, 1, tbl.partition(cut, n, "h100", 1, bs))),
        xfer_latency_s=(cm.transfer_latency(prof, cluster, "l4", "h100", cut, bs),),
    )])


def plan_line(plan) -> str:
    return "; ".join(
        f"bs {p.batch_size}: " + " -> ".join(
            f"blocks [{s.block_start}, {s.block_end}) on {s.accel_class} x{s.n_vdev}"
            for s in p.stages) for p in plan.pipelines)


def trace_of(gen, rate: float, slo_s: float, seed: int, start_id: int = 0,
             n: int = N_REQUESTS) -> list:
    """The first `n` arrivals of `gen(rate, ...)`, drawn over a span long
    enough for them: a trace sized by count, so its p99 ranks n latencies
    however bursty the arrivals."""
    span = n / rate
    while True:
        trace = gen(rate, span, slo_s, MODEL, seed=seed, start_id=start_id)
        if len(trace) >= n:
            return trace[:n]
        span *= 2


def offset_trace(trace, dt: float) -> list:
    """`trace` with every arrival and deadline moved `dt` later."""
    from repro_torch.core.types import replace

    return [replace(r, arrival_s=r.arrival_s + dt, deadline_s=r.deadline_s + dt) for r in trace]


def serve_workload(session, name: str, trace) -> dict:
    """Submit a trace, drain it, and log its attainment and latency from
    the request handles (on the session's virtual clock, which calibration
    makes the wall clock).  Fails unless every request was served and the
    session's executors never failed: the data plane drops the batch of an
    executor that raised (a kernel that refused its shape or failed to
    launch), so a failed launch shows only here."""
    import numpy as np
    import torch

    from repro_torch.data.requests import describe

    handles = [session.submit(r) for r in trace]
    t0 = time.perf_counter()
    session.drain()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    tel = session.telemetry
    lats = np.array([h.latency_s for h in handles if h.latency_s is not None])
    if len(lats) != len(trace) or tel.exec_failures or tel.retries:
        raise AssertionError(
            f"[{name}] served {len(lats)}/{len(trace)} (unresolved "
            f"{sum(not h.done for h in handles)}); executor failures {tel.exec_failures}, "
            f"retries {tel.retries}, drops {tel.snapshot()['drops']}")
    st = describe(trace)
    r = dict(n=len(trace), served=len(lats), wall_s=wall,
             attainment=sum(h.ok for h in handles) / len(trace),
             p50_ms=float(np.percentile(lats, 50)) * 1e3,
             p99_ms=float(np.percentile(lats, 99)) * 1e3)
    log(f"[serve] {name}: {st.n} requests at {st.mean_rps:.1f} rps (peak {st.peak_rps:.1f}), "
        f"SLO {st.slo_s * 1e3:.3f} ms; served {r['served']}/{r['n']} in {wall:.2f} s wall, "
        f"attainment {r['attainment']:.4f}, latency p50 {r['p50_ms']:.3f} ms "
        f"p99 {r['p99_ms']:.3f} ms; executor failures 0")
    return r


def release(session) -> None:
    """Close a session and give its parameters' memory back to the card."""
    import gc

    import torch

    session.shutdown()
    del session
    gc.collect()
    torch.cuda.empty_cache()


def act_milp(dev) -> int:
    """Act 1: profile -> MILP plan -> deploy("real"), then a Poisson and a
    bursty trace on the one deployment, planned feedback: the analytic
    clock schedules, the card executes underneath.  A session serves one
    monotonic virtual clock, so the bursty trace starts where the Poisson
    one's served horizon ends.  Returns the batches dispatched."""
    from repro_torch.api import Session
    from repro_torch.data.requests import bursty_trace, poisson_trace

    session = Session.from_config(serve_config(MILP_SLO_SCALE), device=dev)
    t0 = time.perf_counter()
    session.profile()
    t1 = time.perf_counter()
    plan = session.plan()
    t2 = time.perf_counter()
    log(f"[serve] MILP plan: {plan_line(plan)}; planned throughput {plan.throughput:.1f} rps, "
        f"chips {plan.chips_used()}; profile {(t1 - t0) * 1e3:.3f} ms, solve "
        f"{(t2 - t1) * 1e3:.3f} ms")
    t0 = time.perf_counter()
    before = graph_snapshot()
    session.deploy(mode="real")
    log(f"[serve] deploy(mode=\"real\") in {time.perf_counter() - t0:.2f} s")
    log_captures("MILP plan's deploy", before)
    slo_s = session.store.profiles[MODEL].slo_s
    rate = plan.throughput * 0.6
    poisson = trace_of(poisson_trace, rate, slo_s, seed=7)
    serve_workload(session, "MILP plan, poisson", poisson)
    bursty = trace_of(bursty_trace, rate, slo_s, seed=7, start_id=len(poisson))
    serve_workload(session, "MILP plan, bursty",
                   offset_trace(bursty, session.telemetry.horizon_s))
    batches = len(session.telemetry.dispatches)
    release(session)
    return batches


def act_pinned(dev):
    """Act 2: the hand-pinned 2-stage plan through use_plan, measured
    feedback: deploy calibrates every stage on the card, so the virtual
    clock is the wall clock and the feedback keeps the reservations in
    step.  Returns the live session (its executors serve phases 4 and 5)."""
    import numpy as np

    from repro_torch.api import Session
    from repro_torch.configs import get_config
    from repro_torch.data.requests import poisson_trace
    from repro_torch.serving.engine import layer_block_map_from_profile

    session = Session.from_config(serve_config(PINNED_SLO_SCALE, feedback="measured"),
                                  device=dev)
    session.profile()
    plan = staged_plan(session, BATCH, CUT)
    session.use_plan(plan)
    t0 = time.perf_counter()
    before = graph_snapshot()
    session.deploy(mode="real")
    log_captures("pinned plan's deploy (before calibration)", before)
    cfg = get_config(MODEL)
    executors = session.dataplane.dispatcher.executors
    params = executors[0][0].params
    n_params = sum(p.numel() for p in params.parameters())
    lbm = layer_block_map_from_profile(session.store.profiles[MODEL], cfg.n_layers)
    stages = plan.pipelines[0].stages
    layers = [(lbm[s.block_start][0], lbm[s.block_end - 1][1]) for s in stages]
    log(f"[serve] {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, {cfg.n_heads} heads "
        f"x {cfg.hd}, {n_params / 1e9:.3f} B params bf16 on {dev}; pinned plan "
        f"{plan_line(plan)} -> layers {layers}; deploy with calibration in "
        f"{time.perf_counter() - t0:.1f} s")
    p0 = session.runtime.pipelines[0]
    for si, stage in enumerate(p0.stages):
        for bs, sec in sorted(stage.latency_by_batch.items()):
            log(f"[serve] calibrated stage {si} batch {bs}: {sec * 1e3:.3f} ms")
    e2e = sum(s.latency(1) for s in p0.stages)
    thr = min(len(s.vdevs) * p0.unified_batch / s.latency(p0.unified_batch) for s in p0.stages)
    rate = thr * 0.5
    trace = trace_of(poisson_trace, rate, e2e * 6, seed=11)
    log(f"[serve] calibrated batch-1 e2e {e2e * 1e3:.3f} ms, pipeline throughput {thr:.1f} rps")
    r = serve_workload(session, "pinned 2-stage plan, measured feedback", trace)
    tel = session.telemetry
    disp, fb = session.dataplane.dispatcher, session.dataplane.fb
    if fb.observations <= 0:
        raise AssertionError("measured feedback made no observation")
    if disp.submitted <= 0:
        raise AssertionError("no batch was dispatched")
    log(f"[serve] served {tel.served}/{len(trace)}, attainment {tel.attainment:.4f}, latency "
        f"p50 {r['p50_ms']:.3f} ms p99 {r['p99_ms']:.3f} ms, batches {disp.submitted} (mean "
        f"size {tel.mean_batch_size:.2f}), inflight_hwm {tel.inflight_hwm}, feedback "
        f"observations {fb.observations}, lat_scale {[round(s.lat_scale, 4) for s in p0.stages]}")
    for (e, pid, si), ws in sorted(tel.stage_wall_s.items()):
        log(f"[serve] measured stage {si} wall: median {np.median(ws) * 1e3:.3f} ms over "
            f"{len(ws)} batches")
    return session


def act_swap(dev) -> int:
    """Act 3: a live swap to another partitioning on a fresh deployment of
    the MILP plan: prepare_swap builds and warms the new ranges' executors,
    capturing their graphs, on a background thread (its own CUDA stream)
    from the trace's second arrival while the old plan serves; the swap
    installs them mid-trace, at the first arrival that finds the warm done
    (at the last arrival whatever it finds), in-flight batches drain on
    the retired epoch, which is garbage-collected.  The trace is
    SWAP_REQUESTS long: served from graphs, the device sets the pace (a
    batch of 2 through 32 layers takes ~7.5 ms, so 480 requests take ~2 s),
    and the warm, sharing the host with the serving thread, took 0.3-0.9 s
    on the card's host.  Returns the batches dispatched."""
    from repro_torch.api import Session
    from repro_torch.data.requests import poisson_trace

    session = Session.from_config(serve_config(SWAP_SLO_SCALE), device=dev)
    plan_a = session.plan()
    plan_b = staged_plan(session, 2, 1)
    before = graph_snapshot()
    session.deploy(mode="real")
    log_captures("swap act's deploy", before)
    old = [ex for execs in session.dataplane.dispatcher.executors.values() for ex in execs]
    log(f"[serve] live swap: from the MILP plan {plan_line(plan_a)} to {plan_line(plan_b)}")
    prof = session.store.profiles[MODEL]
    rate = plan_a.throughput * 0.5
    trace = trace_of(poisson_trace, rate, prof.slo_s, seed=13, n=SWAP_REQUESTS)
    first, last = trace[0].arrival_s, trace[-1].arrival_s
    state = {}

    def hook(req, t):
        if "prep" not in state and t > first:
            state["prep_at"] = req.req_id  # the trace starts at id 0
            state["prep"] = session.prepare_swap(plan_b)
        elif "rec" not in state and "prep" in state and (state["prep"].ready() or t >= last):
            state["inflight"] = len(session.dataplane.jobs)
            state["at"] = req.req_id
            state["rec"] = session.swap(plan_b, now=t, reason="live repartition")

    session.on_arrival(hook)
    before = graph_snapshot()
    serve_workload(session, "live swap", trace)
    log_captures("live swap's background warm (prepare_swap's thread)", before, memory=False)
    tel, rec, prep = session.telemetry, state["rec"], state["prep"]
    log(f"[serve] live swap at arrival {state['at']} of {len(trace)} (prepared from arrival "
        f"{state['prep_at']}), with {state['inflight']} batch(es) in flight: swap wall "
        f"{rec.swap_wall_s * 1e3:.3f} ms, background warm {prep.warm_wall_s * 1e3:.3f} ms, "
        f"waited for it in the swap {rec.compile_wall_s * 1e3:.3f} ms, prepared {rec.prepared}, "
        f"{rec.reused_executors} executor(s) reused, new_ranges {list(rec.new_ranges)}, "
        f"virtual transient {tel.swap_transient_s[-1] * 1e3:.3f} ms; retired epoch GC'd "
        f"({tel.epochs_gcd}/{tel.plan_swaps})")
    if not (rec.prepared and tel.plan_swaps == 1 and tel.epochs_gcd == 1 and rec.new_ranges):
        raise AssertionError(f"live swap: {rec}, swaps {tel.plan_swaps}, GC'd {tel.epochs_gcd}")
    live = {id(ex) for execs in session.dataplane.dispatcher.executors.values() for ex in execs}
    held = [len(ex.graphs) for ex in old if id(ex) not in live]
    if any(held):
        raise AssertionError(f"the GC'd epoch's executors still hold graphs: {held}")
    log(f"[serve] the GC'd epoch released the graphs of its {len(held)} executor(s) that the "
        f"new plan does not serve with")
    batches = len(tel.dispatches)
    release(session)
    return batches


def busy_share(run, tag: str, top: int = 8) -> float | None:
    """Share of the wall time of `run()` (work that ends on the card) during
    which the card ran kernels, from torch.profiler; logs the `top` kernels
    and host ops.  None if the profiler recorded no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.key_averages()
               if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.device_time_total for e in kernels)
    if busy_us <= 0:
        return None
    for e in sorted(kernels, key=lambda e: -e.device_time_total)[:top]:
        log(f"[{tag}] profile: {e.device_time_total / busy_us:7.2%} of device time, "
            f"{e.count:5d} calls: {e.key[:90]}")
    host = [e for e in prof.key_averages()
            if getattr(e, "device_type", None) == torch.autograd.DeviceType.CPU]
    host_us = sum(e.self_cpu_time_total for e in host)
    for e in sorted(host, key=lambda e: -e.self_cpu_time_total)[:top]:
        log(f"[{tag}] profile: {e.self_cpu_time_total / host_us:7.2%} of host op time, "
            f"{e.count:5d} calls: {e.key[:90]}")
    log(f"[{tag}] profile: {len(kernels)} kernel names, {busy_us / 1e3:.3f} ms device time, "
        f"{host_us / 1e3:.3f} ms host op time, in {wall_us / 1e3:.3f} ms wall")
    return busy_us / wall_us


def graph_snapshot() -> tuple:
    from repro_torch.serving.engine import GRAPH_STATS as G

    return G.captures, G.capture_s, G.allocated_bytes, G.reserved_bytes


def log_captures(what: str, before: tuple, memory: bool = True) -> None:
    """The stage graphs captured since `before` (a `graph_snapshot`), with
    the device memory they hold where nothing else allocated meanwhile."""
    n, sec, alloc, res = (a - b for a, b in zip(graph_snapshot(), before))
    held = (f"they hold {res / 2**20:.1f} MiB of device memory reserved, "
            f"{alloc / 2**20:.1f} MiB allocated" if memory else
            "their memory is not told apart from the serving thread's, which allocated "
            "meanwhile")
    log(f"[serve] {what}: captured {n} stage graphs in {sec * 1e3:.3f} ms (host time inside "
        f"capture_begin .. capture_end); {held}")


class EagerStage:
    """A StageExecutor's stage run eagerly (`stage_fn`, no graph), for the
    comparison with the replays of its captured graphs."""

    def __init__(self, ex):
        self.ex = ex

    def transfer(self, x):
        return self.ex.transfer(x)

    def __call__(self, x):
        import torch

        with torch.inference_mode():
            return self.ex.stage_fn(self.ex.params, x)


def graphs_vs_eager(executors, dev, n_batches: int = 4) -> dict:
    """The pinned plan's stages as served (graph replays) and run eagerly,
    in turns (graphs, eager, eager, graphs), each over a window of
    `n_batches` back-to-back pipelined batches of BATCH: the device busy
    share of the window (profiler) and the median device time of each stage
    (the dispatcher's events around it).  Also the device time of the copy
    each replay hands out (its static output cloned)."""
    import numpy as np
    import torch

    from repro_torch.dataplane import PoolDispatcher

    tokens = torch.ones((BATCH, SEQ), dtype=torch.int64, device=dev)
    variants = {"graphs": executors[0], "eager": [EagerStage(ex) for ex in executors[0]]}
    res = {k: dict(share=[], walls=[[] for _ in executors[0]]) for k in variants}
    for i, name in enumerate(("graphs", "eager", "eager", "graphs")):
        disp = PoolDispatcher({0: variants[name]}, max_inflight=n_batches)

        def run():
            for _ in range(n_batches):
                disp.submit_chain(0, tokens)
            disp.drain_all()

        run()  # outside the window: allocator pools warm for this variant
        disp.take_completed()
        res[name]["share"].append(busy_share(run, f"serve, {name}", top=8 if i < 2 else 0))
        for done in disp.take_completed():
            for si, w in enumerate(done.stage_wall_s):
                res[name]["walls"][si].append(w)
    for name, r in res.items():
        r["median_stage_ms"] = [float(np.median(w)) * 1e3 for w in r["walls"]]
        shares = ", ".join("not measured" if x is None else f"{x:.4f}" for x in r["share"])
        log(f"[serve] {name}: device busy share over {n_batches} back-to-back batches of "
            f"{BATCH}: {shares}; median stage device time "
            + ", ".join(f"stage {si} {ms:.3f} ms" for si, ms in enumerate(r["median_stage_ms"]))
            + f" (over {len(r['walls'][0])} batches)")
    r = res["graphs"]
    r["clone_us"] = []
    for si, ex in enumerate(executors[0]):
        g = max(ex.graphs.values(), key=lambda g: g.static_in.shape[0])
        r["clone_us"].append(time_ms(lambda g=g: g.static_out.clone()) * 1e3)
        log(f"[serve] stage {si}: the copy a replay hands out, "
            f"{tuple(g.static_out.shape)} {g.static_out.dtype}, takes "
            f"{r['clone_us'][-1]:.3f} us of device time")
    return res


def phase_serve(dev):
    """The three serve acts through `repro_torch.api.Session`, counted
    together: every kernel launch from the first deploy to the last drain
    (stage programs, calibration, the swap's warm).  The stages replay
    captured graphs: the kernel wrappers count a graph's launches once,
    when it is captured, so the launches served are the counters' advance,
    less what was recorded into graphs, plus each graph's launches times its
    replays.  Every stage call on the serving path must replay a graph.
    Returns the model's config, the pinned act's live session and the
    launch counts."""
    from repro_torch.configs import get_config
    from repro_torch.serving.engine import GRAPH_STATS as G

    reset_counts()
    G.reset()
    batches = act_milp(dev)
    session = act_pinned(dev)
    batches += len(session.telemetry.dispatches)
    batches += act_swap(dev)
    counted = read_counts()
    launches = {k: n - G.captured.get(k, 0) + G.replayed.get(k, 0) for k, n in counted.items()}
    log(f"[serve] stage graphs over the three acts: {G.captures} captured in "
        f"{G.capture_s * 1e3:.3f} ms, {G.replays} replays, {G.misses} calls without a graph; "
        f"the kernel counters advanced by {counted}, of which {G.captured} at capture; the "
        f"replays launched {G.replayed}")
    if G.misses:
        raise AssertionError(f"{G.misses} stage calls found no graph and ran eagerly")
    cfg = get_config(MODEL)
    for name in ("rmsnorm", "flash_attention"):
        if launches[name] < cfg.n_layers * batches:
            raise AssertionError(f"{name} launched {launches[name]} times for {batches} "
                                 f"batches of {cfg.n_layers} layers")
    log(f"[serve] launches while serving: {launches} ({batches} batches over the three acts; "
        f"on one card every stage shares the device, so transfer() skips the boundary "
        f"kernels)")
    graphs_vs_eager(session.dataplane.dispatcher.executors, dev)
    return cfg, session, launches


# ----------------------------------------------------------------- phase 4


def phase_parity(cfg, executors, dev) -> None:
    """The full-width stage split through the kernels against the same
    program through the plain PyTorch math (`common.PLAIN`: the reference's
    rms_norm and chunked attention, op for op), on the same parameters and
    device.

    With the reference's init the activations are large and attention is
    nearly one-hot, so one-ulp bf16 differences grow chaotically over 32
    layers and two correct forwards disagree elementwise at the logits.
    The check is therefore made where it is meaningful: every layer (and
    the head) from the same input, with max |err| <= 5e-2 x max |ref| (the
    bf16 tolerance of tests/test_kernels.py, relative to the tensor's
    scale); the whole forward must be finite and agree on top-1 wherever
    the reference's top-2 margin exceeds twice the observed error."""
    import numpy as np
    import torch

    from repro_torch.models import transformer as tfm
    from repro_torch.models.common import KERNELS, PLAIN as plain

    s0, s1 = executors[0]
    params = s0.params
    tokens = torch.from_numpy(np.random.default_rng(SEED).integers(0, cfg.vocab, (2, SEQ)))
    tokens = tokens.to(dev)

    worst = 0.0
    with torch.inference_mode():
        x = tfm.embed_tokens(cfg, params, tokens)
        positions = tfm.positions_for(x)
        for i, lp in enumerate(params["layers"]):
            got, _ = tfm.layer_full(cfg, KERNELS, lp, x, positions)
            want, _ = tfm.layer_full(cfg, plain, lp, x, positions)
            rel = float((got - want).abs().max()) / float(want.abs().max())
            worst = max(worst, rel)
            if not rel <= 5e-2:
                raise AssertionError(f"layer {i}: max|err| / max|ref| = {rel:.4g}")
            x = got
        got = tfm.unembed(cfg, params, KERNELS.rms_norm(x, params["final_norm"], cfg.norm_eps))
        want = tfm.unembed(cfg, params, plain.rms_norm(x, params["final_norm"], cfg.norm_eps))
        head_rel = float((got - want).abs().max()) / float(want.abs().max())
        if not head_rel <= 5e-2:
            raise AssertionError(f"head: max|err| / max|ref| = {head_rel:.4g}")

        got = s1(s1.transfer(s0(tokens))).float()
        want = tfm.forward(cfg, plain, params, tokens).float()
    torch.cuda.synchronize()
    if not torch.equal(s1(s1.transfer(s0(tokens))).float(), got):
        raise AssertionError("the stage split is not deterministic")
    err = float((got - want).abs().max())
    within = float(((got - want).abs() <= 5e-2 + 5e-2 * want.abs()).float().mean())
    top2 = want.topk(2, dim=-1).values
    decisive = (top2[..., 0] - top2[..., 1]) > 2 * err
    agree = got.argmax(-1) == want.argmax(-1)
    log(f"[parity] per layer (same input): worst max|err|/max|ref| {worst:.4g} over "
        f"{cfg.n_layers} layers, head {head_rel:.4g} (limit 5e-2)")
    log(f"[parity] whole forward, stage split (kernels) vs plain math: logits max|err| "
        f"{err:.4f} at scale {float(want.abs().max()):.2f}, share within 5e-2 abs+rel "
        f"{within:.6f}; top-1 agrees at {int(agree.sum())}/{agree.numel()} positions, "
        f"{int(decisive.sum())} decisive")
    if got.shape != (2, SEQ, cfg.padded_vocab) or not torch.isfinite(got).all():
        raise AssertionError(f"logits of shape {tuple(got.shape)}, finite "
                             f"{bool(torch.isfinite(got).all())}")
    if not bool(agree[decisive].all()):
        raise AssertionError("top-1 disagrees at a decisive position")


# ----------------------------------------------------------------- phase 5


def reset_counts() -> None:
    from repro_torch.kernels import counters

    for fn in counters().values():
        fn.launches = 0


def read_counts() -> dict:
    from repro_torch.kernels import launch_counts

    return launch_counts()


def rel_err(got, want) -> float:
    return float((got.float() - want.float()).abs().max()) / float(want.float().abs().max())


def check_layer(what: str, got, want, worst: dict) -> None:
    """Two forms of one layer from the same input: max |err| <= 5e-2 x
    max |ref| (as phase 4)."""
    rel = rel_err(got, want)
    worst[what] = max(worst.get(what, 0.0), rel)
    if not rel <= 5e-2:
        raise AssertionError(f"{what}: max|err| / max|ref| = {rel:.4g}")


def layer_parity(cfg, params, prompts, cache, tok, cur_len) -> dict:
    """Single layers through `KERNELS` against `PLAIN`, each from the same
    input (and a copy of the same cache): the prefill and the decode form of
    every attention layer (stablelm-3b), or of every group's Mamba2 blocks
    and shared attention block, each on its own group's slice of the cache
    (zamba2-2.7b)."""
    import torch

    from repro_torch.models import hybrid, transformer as tfm
    from repro_torch.models.common import KERNELS, PLAIN

    worst: dict = {}
    x = tfm.embed_tokens(cfg, params, prompts)
    xd = tfm.embed_tokens(cfg, params, tok)
    positions = tfm.positions_for(x)

    def attn_pair(lp, k_cache, v_cache, x, xd, tag):
        got, _ = tfm.layer_full(cfg, KERNELS, lp, x, positions)
        check_layer(f"{tag} (prefill)", got, tfm.layer_full(cfg, PLAIN, lp, x, positions)[0],
                    worst)
        outs = [tfm.layer_decode(cfg, ops, lp, xd, k_cache.clone(), v_cache.clone(), cur_len)[0]
                for ops in (KERNELS, PLAIN)]
        check_layer(f"{tag} (decode)", *outs, worst)
        return got, outs[0]

    if cfg.family == "dense":
        for i, lp in enumerate(params["layers"]):
            x, xd = attn_pair(lp, cache["k"][i], cache["v"][i], x, xd, "attention layer")
        return worst
    for g, group in enumerate(params["inner"]):
        for j, lp in enumerate(group):
            got, _ = hybrid._apply_inner_full(cfg, KERNELS, lp, x)
            check_layer("Mamba2 block (prefill)", got,
                        hybrid._apply_inner_full(cfg, PLAIN, lp, x)[0], worst)
            state = {name: a[g, j] for name, a in cache["inner"].items()}
            outs = [hybrid._apply_inner_step(cfg, ops, lp, xd, state)[0]
                    for ops in (KERNELS, PLAIN)]
            check_layer("Mamba2 block (decode)", *outs, worst)
            x, xd = got, outs[0]
        x, xd = attn_pair(params["shared_attn"], cache["attn_k"][g], cache["attn_v"][g], x, xd,
                          "shared attention block")
    torch.cuda.synchronize()
    return worst


def layer_invariant(cfg, params, prompts, tok) -> dict:
    """The serving invariant one layer at a time, through the kernels: a
    layer's decode form at position S, from the state its prefill form left
    after S tokens, against its full form over the S + 1 tokens at that
    position, from the same input (limit 5e-2 of the output's scale).  The
    input runs through the full forms from the embeddings, over every
    layer of either model."""
    import torch

    from repro_torch.models import hybrid, transformer as tfm
    from repro_torch.models.common import KERNELS

    worst: dict = {}
    x = tfm.embed_tokens(cfg, params, torch.cat([prompts, tok], dim=1))
    B, S = prompts.shape
    positions = tfm.positions_for(x)

    def split(x):  # the prefix and the last token, as the model paths see them
        return x[:, :S].contiguous(), x[:, S:].contiguous()

    def attn(lp, x):
        full, _ = tfm.layer_full(cfg, KERNELS, lp, x, positions)
        prefix, last = split(x)
        _, (k, v) = tfm.layer_full(cfg, KERNELS, lp, prefix, positions[:, :S])
        kc, vc = (torch.zeros((B, S + 1) + a.shape[2:], dtype=a.dtype, device=a.device)
                  for a in (k, v))
        kc[:, :S], vc[:, :S] = k, v
        step, _ = tfm.layer_decode(cfg, KERNELS, lp, last, kc, vc, S)
        check_layer("attention (decode vs full)", step[:, 0], full[:, S], worst)
        return full

    if cfg.family == "dense":
        for lp in params["layers"]:
            x = attn(lp, x)
        return worst
    hidden = []
    for group in params["inner"]:
        for lp in group:
            full, _ = hybrid._apply_inner_full(cfg, KERNELS, lp, x)
            prefix, last = split(x)
            _, st = hybrid._apply_inner_full(cfg, KERNELS, lp, prefix, return_state=True)
            step, _ = hybrid._apply_inner_step(cfg, KERNELS, lp, last, st)
            check_layer("Mamba2 block (decode vs full)", step[:, 0], full[:, S], worst)
            x = full
        hidden.append(float(x.float().abs().max()))
        x = attn(params["shared_attn"], x)
    log(f"[decode] {cfg.name}: max |hidden| into each group's shared attention block "
        + ", ".join(f"{h:.4g}" for h in hidden))
    torch.cuda.synchronize()
    return worst


def invariant(got, full) -> tuple[float, float, object, object]:
    """The serving invariant's reading: max |err| of the decode logits
    against the teacher-forced forward's, the logits' scale, and per
    position whether the forward's top-2 margin exceeds twice that error
    (decisive) and whether top-1 agrees."""
    err = float((got - full).abs().max())
    top2 = full.topk(2, dim=-1).values
    decisive = (top2[..., 0] - top2[..., 1]) > 2 * err
    return err, float(full.abs().max()), decisive, got.argmax(-1) == full.argmax(-1)


def teacher_forced(model, params, prompts, fed, ops):
    """Prefill `prompts`, then decode the tokens `fed` one at a time through
    `ops`.  Returns the logits of the prefill's last position and of every
    step (B, n + 1, V) and the forward's at the same positions, both f32."""
    import torch

    S = prompts.shape[1]
    logits, cache = model.prefill(params, {"tokens": prompts}, max_len=S + len(fed), ops=ops)
    steps = [logits[:, -1]]
    for i, tok in enumerate(fed):
        lg, cache = model.decode_step(params, tok, cache, S + i, ops=ops)
        steps.append(lg[:, 0])
    seq = torch.cat([prompts, *fed], dim=1)
    full = model.forward(params, {"tokens": seq}, ops=ops)[:, S - 1:]
    return torch.stack(steps, dim=1).float(), full.float()


def witnesses(cfg, params, prompts, fed, got) -> None:
    """Readings of the serving invariant at full width beside the kernels'
    bf16 one, from the same tokens.  The plain math in bf16: does it miss
    its own forward as the kernels do, and how far are the kernels' decode
    logits from its?  The kernels in f32 (every kernel's f32 route, flash
    attention's CUDA-core one included): for the dense model
    the invariant must hold there with decisive positions, so the check can
    fail; zamba2-2.7b's f32 forward is itself too sensitive for that, which
    the last reading shows: the f32 forward's move when the embeddings are
    scaled by 1 + 2^-22 (two ulps).  zamba2-2.7b's whole-model check is
    `cache_walk`'s."""
    import copy
    import dataclasses

    import torch

    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.models.common import KERNELS, PLAIN
    from repro_torch.models.model_zoo import build_model

    arch, S = cfg.name, prompts.shape[1]
    plain, full = teacher_forced(build_model(cfg), params, prompts, fed, PLAIN)
    err, scale, decisive, agree = invariant(plain, full)
    log(f"[decode] {arch} plain math, bf16: vs its own forward max|err| {err:.4f} at logit "
        f"scale {scale:.3f} ({err / scale:.4g} of scale); top-1 agrees at "
        f"{int(agree.sum())}/{agree.numel()}, {int(decisive.sum())} decisive; the kernels' "
        f"decode logits vs the plain math's: max|err| {float((got - plain).abs().max()):.4f}")
    del plain, full
    model32 = build_model(dataclasses.replace(cfg, dtype=torch.float32))
    params32 = copy.deepcopy(params).float()
    launches = fa.flash_attention.launches
    got32, full32 = teacher_forced(model32, params32, prompts, fed, KERNELS)
    params32["embed"].mul_(1 + 2.0 ** -22)
    seq = torch.cat([prompts, *fed], dim=1)
    nudged = model32.forward(params32, {"tokens": seq}, ops=KERNELS)[:, S - 1:].float()
    torch.cuda.synchronize()
    launches = fa.flash_attention.launches - launches
    if launches <= 0:
        raise AssertionError(f"{arch} f32: flash_attention's f32 route was not launched")
    log(f"[decode] {arch} kernels, f32: flash_attention's f32 route launched {launches} times")
    err, scale, decisive, agree = invariant(got32, full32)
    log(f"[decode] {arch} kernels, f32: vs the teacher-forced forward max|err| {err:.4g} at "
        f"logit scale {scale:.3f} ({err / scale:.4g} of scale); top-1 agrees at "
        f"{int(agree.sum())}/{agree.numel()}, {int(decisive.sum())} decisive; the f32 "
        f"forward moves by {rel_err(nudged, full32):.4g} of scale when the embeddings are "
        f"scaled by 1 + 2^-22")
    if not torch.isfinite(got32).all():
        raise AssertionError(f"{arch} f32: non-finite decode logits")
    if cfg.family == "dense" and not bool(decisive.any()):
        raise AssertionError(f"{arch} f32: no decisive position")
    if not bool(agree[decisive].all()):
        raise AssertionError(f"{arch} f32: top-1 disagrees with the forward at a decisive "
                             f"position")
    del params32


def cache_walk(cfg, model, params, prompts, tok) -> dict:
    """The model's bookkeeping at full width, a whole-model check that can
    fail where the invariant cannot: a fresh `prefill` of the prompts and
    one `decode_step` of `tok`, through the kernels, against the same layer
    functions walked in order with each layer's state kept apart (the dense
    layer l; group g's Mamba2 block j and its use of the shared block).
    Both take the same trajectory, so they agree to rounding: every cache
    slot after the prefill and after the step, and both logits, within 1e-3
    of their scale."""
    import torch

    from repro_torch.models import hybrid, transformer as tfm
    from repro_torch.models.common import KERNELS

    B, S = prompts.shape
    logits, cache = model.prefill(params, {"tokens": prompts}, max_len=S + 1)
    pre = {k: ({n: a.clone() for n, a in v.items()} if isinstance(v, dict) else v.clone())
           for k, v in cache.items()}
    step, cache = model.decode_step(params, tok, cache, S)
    worst: dict = {}

    def same(what, got, want):
        rel = rel_err(got, want)
        worst[what] = max(worst.get(what, 0.0), rel)
        if not rel <= 1e-3:
            raise AssertionError(f"{cfg.name} {what}: the model's is {rel:.4g} of scale from "
                                 f"the layer walk's")

    x = tfm.embed_tokens(cfg, params, prompts)
    xd = tfm.embed_tokens(cfg, params, tok)
    positions = tfm.positions_for(x)

    def attn(lp, x, xd, k_pre, v_pre, k_post, v_post):
        x, (k, v) = tfm.layer_full(cfg, KERNELS, lp, x, positions)
        same("KV cache after prefill", k_pre[:, :S], k)
        same("KV cache after prefill", v_pre[:, :S], v)
        kc, vc = torch.zeros_like(k_post), torch.zeros_like(v_post)
        kc[:, :S], vc[:, :S] = k, v
        xd, _ = tfm.layer_decode(cfg, KERNELS, lp, xd, kc, vc, S)
        same("KV cache after the step", k_post, kc)
        same("KV cache after the step", v_post, vc)
        return x, xd

    if cfg.family == "dense":
        for i, lp in enumerate(params["layers"]):
            x, xd = attn(lp, x, xd, pre["k"][i], pre["v"][i], cache["k"][i], cache["v"][i])
    else:
        for g, group in enumerate(params["inner"]):
            for j, lp in enumerate(group):
                x, st = hybrid._apply_inner_full(cfg, KERNELS, lp, x, return_state=True)
                for name, a in st.items():
                    same("Mamba2 state after prefill", pre["inner"][name][g, j], a)
                xd, st = hybrid._apply_inner_step(cfg, KERNELS, lp, xd, st)
                for name, a in st.items():
                    same("Mamba2 state after the step", cache["inner"][name][g, j], a)
            x, xd = attn(params["shared_attn"], x, xd, pre["attn_k"][g], pre["attn_v"][g],
                         cache["attn_k"][g], cache["attn_v"][g])

    def head(h):
        return tfm.unembed(cfg, params, KERNELS.rms_norm(h, params["final_norm"], cfg.norm_eps))

    same("prefill logits", logits, head(x[:, -1:].contiguous()))
    same("step logits", step, head(xd))
    torch.cuda.synchronize()
    return worst


def decode_run(arch: str, B: int, S: int, n: int, params, dev, parent) -> tuple[dict, object]:
    """Prefill B prompts of S tokens, then n greedy decode steps, through the
    kernels; hold each step to the teacher-forced forward.  Returns the
    path's launch counts and the parameters."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models.model_zoo import build_model

    cfg = get_config(arch)
    model = build_model(cfg)
    t0 = time.perf_counter()
    if params is None:
        params = model.init(torch.Generator(device=dev).manual_seed(SEED))
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in params.parameters())
    log(f"[decode] {arch}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"{n_params / 1e9:.3f} B params on {dev} ({time.perf_counter() - t0:.1f} s); "
        f"{B} prompts x {S} tokens, {n} greedy steps")
    prompts = torch.from_numpy(np.random.default_rng(SEED + 1).integers(0, cfg.vocab, (B, S)))
    prompts = prompts.to(dev)
    n_attn = cfg.ssm_pattern.count("a") if cfg.ssm_pattern else cfg.n_layers
    n_mamba = cfg.ssm_pattern.count("m")

    with torch.inference_mode():
        # warm-up: one short prefill and one decode step
        lg, wc = model.prefill(params, {"tokens": prompts[:, :16]}, max_len=17)
        model.decode_step(params, lg[:, -1].argmax(-1, keepdim=True), wc, 16)
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        logits, cache = model.prefill(params, {"tokens": prompts}, max_len=S + n)
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        pre = read_counts()
        reset_counts()
        tok = logits[:, -1].argmax(-1, keepdim=True)
        cur = torch.tensor(S, dtype=torch.int32, device=dev)
        fed, steps = [], [logits[:, -1]]
        t0 = time.perf_counter()
        for _ in range(n):
            fed.append(tok)
            lg, cache = model.decode_step(params, tok, cache, cur)
            steps.append(lg[:, 0])
            tok = lg[:, 0].argmax(-1, keepdim=True)
            cur = cur + 1
        torch.cuda.synchronize()
        decode_s = time.perf_counter() - t0
        dec = read_counts()

        if dec["decode_attention"] != n_attn * n:
            raise AssertionError(f"{dec['decode_attention']} decode_attention launches for {n} "
                                 f"steps of {n_attn} attention layers")
        if pre["ssd_scan"] != n_mamba:
            raise AssertionError(f"{pre['ssd_scan']} ssd_scan launches for {n_mamba} blocks")
        for name in ("rmsnorm", "flash_attention"):
            if pre[name] + dec[name] <= 0:
                raise AssertionError(f"{name} was not launched on the decode path")
        profile_prefill(model, params, prompts, S + n, arch, parent)

        # the serving invariant: prefill + step-by-step decode equals the
        # teacher-forced forward over the same tokens
        seq = torch.cat([prompts, *fed], dim=1)
        full = model.forward(params, {"tokens": seq}).float()[:, S - 1:]
        got = torch.stack(steps, dim=1).float()
        torch.cuda.synchronize()
        if got.shape != full.shape or not torch.isfinite(got).all():
            raise AssertionError(f"decode logits {tuple(got.shape)} (forward "
                                 f"{tuple(full.shape)}), finite {bool(torch.isfinite(got).all())}")
        err, scale, decisive, agree = invariant(got, full)
        log(f"[decode] {arch}: prefill {prefill_s * 1e3:.3f} ms, decode {decode_s * 1e3:.3f} ms "
            f"= {decode_s / n * 1e3:.3f} ms a step ({B / (decode_s / n):.1f} tokens/s)")
        log(f"[decode] {arch}: launches in prefill {pre}, in the decode loop {dec}")
        log(f"[decode] {arch}: vs the teacher-forced forward, max|err| {err:.4f} at logit "
            f"scale {scale:.3f} ({err / scale:.4g} of scale); top-1 agrees at "
            f"{int(agree.sum())}/{agree.numel()} positions, {int(decisive.sum())} decisive; "
            f"greedy tokens {seq[0, S:S + 8].tolist()}...")
        if not bool(agree[decisive].all()):
            raise AssertionError(f"{arch}: top-1 disagrees with the forward at a decisive "
                                 f"position")
        witnesses(cfg, params, prompts, fed, got)

        worst = layer_invariant(cfg, params, prompts, fed[0])
        log(f"[decode] {arch}: serving invariant per layer through the kernels, worst "
            f"max|err|/max|ref|: " + ", ".join(f"{k} {v:.4g}" for k, v in worst.items())
            + " (limit 5e-2)")
        last = torch.tensor(S + n - 1, dtype=torch.int32, device=dev)
        worst = layer_parity(cfg, params, prompts, cache, fed[-1], last)
        log(f"[decode] {arch}: per layer through the kernels vs plain math, same input, "
            f"worst max|err|/max|ref|: "
            + ", ".join(f"{k} {v:.4g}" for k, v in worst.items()) + " (limit 5e-2)")
        worst = cache_walk(cfg, model, params, prompts, fed[0])
        log(f"[decode] {arch}: prefill + one step vs the layer walk, every cache slot and "
            f"both logits, worst max|err|/max|ref|: "
            + ", ".join(f"{k} {v:.4g}" for k, v in worst.items()) + " (limit 1e-3)")

        # device busy share of the decode loop: replay the last steps
        first = S + n - PROFILED_STEPS

        def replay():
            for i in range(PROFILED_STEPS):
                model.decode_step(params, fed[first - S + i], cache,
                                  torch.tensor(first + i, dtype=torch.int32, device=dev))

        share = busy_share(replay, "decode")
        log(f"[decode] {arch}: device busy share over {PROFILED_STEPS} decode steps: "
            + ("not measured (profiler recorded no device time)" if share is None
               else f"{share:.4f}"))
    return {k: pre[k] + dec[k] for k in pre}, params


def profile_prefill(model, params, prompts, max_len: int, arch: str, parent) -> None:
    """The device busy share and top kernels of one prefill (after the timed
    one, so nothing is built or warmed inside the window); with `--parent`,
    the same prefill through the other tree's kernels, in turns (this
    tree's, the parent's, twice)."""
    from repro_torch.models.common import KERNELS

    variants = [("this tree's kernels", lambda: contextlib.nullcontext(KERNELS))]
    if parent is not None:
        variants.append(("the parent's kernels", lambda: parent_kernels(parent)))
    for what, swap in variants * (2 if parent is not None else 1):
        with swap() as ops:
            model.prefill(params, {"tokens": prompts}, max_len=max_len, ops=ops)  # warm
            share = busy_share(lambda: model.prefill(params, {"tokens": prompts},
                                                     max_len=max_len, ops=ops), "prefill")
        log(f"[prefill] {arch}, {what}: device busy share over one prefill of "
            f"{tuple(prompts.shape)}: "
            + ("not measured (profiler recorded no device time)" if share is None
               else f"{share:.4f}"))


@contextlib.contextmanager
def parent_kernels(parent: dict):
    """Within: every function of this tree's kernel wrapper modules that
    the other tree's module of the same kernel also defines is the other's.
    Yields `KERNELS` with each field that is such a function swapped the
    same way (a field that calls a wrapper through its module, as the
    attention does, follows by itself)."""
    import dataclasses
    import inspect

    from repro_torch.models.common import KERNELS

    saved = []
    try:
        for name, other in parent.items():
            mine = sys.modules.get(f"repro_torch.kernels.{name}.ops")
            for attr, fn in list(vars(mine).items()) if mine else []:
                if (inspect.isfunction(fn) and fn.__module__ == mine.__name__
                        and inspect.isfunction(getattr(other, attr, None))):
                    saved.append((mine, attr, fn))
                    setattr(mine, attr, getattr(other, attr))
        fields = {f.name: getattr(KERNELS, f.name) for f in dataclasses.fields(KERNELS)}
        yield dataclasses.replace(KERNELS, **{
            k: getattr(sys.modules[fn.__module__], fn.__name__) for k, fn in fields.items()
            if fn.__module__.startswith("repro_torch.kernels.")})
    finally:
        for mod, attr, fn in reversed(saved):
            setattr(mod, attr, fn)


def phase_decode(serve_params, dev, parent) -> dict:
    """Both decode runs; returns the decode path's launch counts (each run
    counted from 0 before its prefill to after its decode loop)."""
    import torch

    total: dict = {}
    for arch, B, S, n in DECODE_RUNS:
        counts, params = decode_run(arch, B, S, n, serve_params if arch == "stablelm-3b"
                                    else None, dev, parent)
        total = {k: total.get(k, 0) + v for k, v in counts.items()}
        del params
        torch.cuda.empty_cache()
    return total


def main() -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", metavar="ROOT",
                    help="another tree of the repository (e.g. the parent commit unpacked): "
                         "time its kernels in turns with this tree's, and profile a prefill "
                         "through them")
    args = ap.parse_args()
    if not (ROOT / "src" / "repro_torch" / "kernels").is_dir():
        print("chip_smoke.py: run it from a checkout of the repository "
              "(src/repro_torch not found)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device; the port's kernels run only on the card",
              file=sys.stderr)
        return 3
    dev = torch.device("cuda", 0)
    t_start = time.perf_counter()
    log(f"[env] python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}")
    parent = load_parent(Path(args.parent).resolve()) if args.parent else None
    phase_build(parent)
    smi = gpu_line()
    log(f"[env] nvidia-smi: {smi}")
    kern = phase_kernels(dev, parent)
    cfg, session, launches = phase_serve(dev)
    executors = session.dataplane.dispatcher.executors
    phase_parity(cfg, executors, dev)
    decode = phase_decode(executors[0][0].params, dev, parent)
    launches = {name: {"serve": launches[name], "decode": decode[name]} for name in KERNEL_NAMES}
    log(f"[done] all phases passed in {time.perf_counter() - t_start:.1f} s")
    print(smi)
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": KERNEL_SOURCES[name][0],
         "replaces": KERNEL_SOURCES[name][1], "launches": sum(launches[name].values()),
         "launches_by_path": launches[name],
         "max_abs_err": kern[name]["max_abs_err"], "ms": kern[name]["ms"],
         "parent_ms": kern[name]["parent_ms"],
         "plain_ms": kern[name]["plain_ms"], "bound_ms": kern[name]["bound_ms"],
         "bound_by": kern[name]["bound_by"], "library_ms": kern[name]["library_ms"],
         "host_ms": kern[name]["host_ms"],
         **({"shapes": kern[name]["shapes"]} if "shapes" in kern[name] else {})}
        for name in KERNEL_NAMES]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
