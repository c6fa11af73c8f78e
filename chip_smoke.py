#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (src/repro_torch) on one NVIDIA GPU.

Run from a checkout of the repository:

    python3 chip_smoke.py

Phases, each of which must pass (any failure raises and exits non-zero):

1. build the five CUDA libraries from `src/repro_torch/kernels/*/csrc` with
   nvcc for sm_90a, one nvcc per source, in parallel;
2. hold every kernel against its plain PyTorch version on the card at the
   main paths' shapes, and time it beside its bound, its plain version and
   one PyTorch library call (a yardstick only; the port never calls it);
3. serve stablelm-3b at full width (32 layers, random weights from a seed)
   through calibrate_runtime -> PoolDispatcher -> DataPlane with measured
   feedback, on the hand-pinned 2-stage pooled plan, and show that serving
   launched the RMSNorm and attention kernels;
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
   path ran rmsnorm, flash_attention, decode_attention and ssd_scan.

The line before the last is a JSON object with one entry per kernel; the
last line is `{"ok": true, "device": {...}}`.  Without a CUDA device, or
outside a checkout, the script exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SEED = 0
SEQ = 128          # tokens per request
BATCH = 8          # unified batch of the pinned plan
N_BLOCKS = 6
CUT = 3            # blocks [0, CUT) on the 3-member low pool, the rest on the high chip
N_REQUESTS = 48
# phase 5: (arch, batch, prompt tokens, greedy decode steps)
DECODE_RUNS = (("stablelm-3b", 8, 128, 32), ("zamba2-2.7b", 4, 512, 16))
PROFILED_STEPS = 4

# NVIDIA H100 SXM data sheet (dense): HBM rate, bf16 and TF32 tensor-core
# peaks, f32 peak outside the tensor cores.  A product with an f32 operand
# keeps f32 precision on the tensor cores as 3xTF32 (three TF32 products).
HBM_BYTES_S = 3.35e12
BF16_FLOP_S = 989e12
TF32X3_FLOP_S = 495e12 / 3
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


def phase_build() -> None:
    from repro_torch.kernels import _lib

    t0 = time.perf_counter()
    seconds = _lib.build_all()
    log(f"[build] {len(seconds)} libraries in {time.perf_counter() - t0:.1f} s "
        f"(nvcc {_lib.nvcc_path()}, flags {' '.join(_lib.NVCC_FLAGS)})")
    for name in seconds:
        log_path = _lib.lib_path(name).with_suffix(".log")
        for line in log_path.read_text().splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build] {name}: {line.strip()}")


# ----------------------------------------------------------------- phase 2


def phase_kernels(dev) -> dict:
    """Each kernel against its plain version at the serving shapes; returns
    the per-kernel measurements for the kernels line."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.boundary_quant import ops as bq
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.rmsnorm import ops as rn
    from repro_torch.testing.parity import tol

    g = torch.Generator(device=dev).manual_seed(SEED)
    bf16 = torch.bfloat16
    N, D = BATCH * SEQ, 2560
    H, HD = 32, 80
    res = {}

    def err(a, b) -> float:
        return float((a.float() - b.float()).abs().max())

    # rmsnorm: (B*S, 2560) bf16
    x = (torch.randn(N, D, generator=g, device=dev) * 3).to(bf16)
    w = torch.randn(D, generator=g, device=dev).to(bf16)
    got, want = rn.rmsnorm(x, w), rn.rmsnorm_plain(x, w)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, **tol(bf16))
    nbytes = 2 * N * D * 2 + D * 2
    b_ms, b_by = bound_ms(nbytes, (4.0 * N * D, F32_FLOP_S))
    res["rmsnorm"] = dict(
        max_abs_err=err(got, want), tol=tol(bf16),
        ms=time_ms(lambda: rn.rmsnorm(x, w)), plain_ms=time_ms(lambda: rn.rmsnorm_plain(x, w)),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=time_ms(lambda: F.rms_norm(x, (D,), w, 1e-5)))

    # flash_attention: (B, 32, 128, 80) bf16, model layout (B, T, H, D) as served
    q, k, v = (torch.randn(BATCH, SEQ, H, HD, generator=g, device=dev).to(bf16)
               for _ in range(3))
    got = fa.attention_bthd(q, k, v)
    want = fa.flash_attention_plain(q.transpose(1, 2), k.transpose(1, 2),
                                    v.transpose(1, 2)).transpose(1, 2)
    bhsd = fa.flash_attention(q.transpose(1, 2).contiguous(), k.transpose(1, 2).contiguous(),
                              v.transpose(1, 2).contiguous())
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, **tol(bf16))
    torch.testing.assert_close(bhsd.transpose(1, 2), got, atol=0, rtol=0)
    pairs = BATCH * H * SEQ * (SEQ + 1) / 2  # causal (query, key) pairs
    b_ms, b_by = bound_ms(4 * BATCH * SEQ * H * HD * 2, (4.0 * pairs * HD, BF16_FLOP_S))
    qh, kh, vh = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    res["flash_attention"] = dict(
        max_abs_err=err(got, want), tol=tol(bf16),
        ms=time_ms(lambda: fa.attention_bthd(q, k, v)),
        plain_ms=time_ms(lambda: fa.flash_attention_plain(qh, kh, vh)),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=time_ms(lambda: F.scaled_dot_product_attention(qh, kh, vh, is_causal=True)))

    # boundary quantization: (B*S, 2560) bf16, the boundary activations
    h = (torch.randn(N, D, generator=g, device=dev) * 20).to(bf16)
    qv, s = bq.quantize(h)
    qp, sp = bq.quantize_plain(h)
    torch.cuda.synchronize()
    n_q_diff = int((qv != qp).sum())
    if n_q_diff or not torch.equal(s, sp):
        raise AssertionError(f"quantize differs from its plain version: {n_q_diff} values, "
                             f"scales equal {torch.equal(s, sp)}")
    b_ms, b_by = bound_ms(N * D * 2 + N * D + N * 4, (3.0 * N * D, F32_FLOP_S))
    res["quantize"] = dict(
        max_abs_err=float((qv.int() - qp.int()).abs().max()), tol="bit-equal",
        ms=time_ms(lambda: bq.quantize(h)), plain_ms=time_ms(lambda: bq.quantize_plain(h)),
        bound_ms=b_ms, bound_by=b_by, library_ms=None)
    got, want = bq.dequantize(qv, s, bf16), bq.dequantize_plain(qv, s, bf16)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        raise AssertionError(f"dequantize differs from its plain version by {err(got, want)}")
    b_ms, b_by = bound_ms(N * D + N * 4 + N * D * 2, (1.0 * N * D, F32_FLOP_S))
    res["dequantize"] = dict(
        max_abs_err=err(got, want), tol="bit-equal",
        ms=time_ms(lambda: bq.dequantize(qv, s, bf16)),
        plain_ms=time_ms(lambda: bq.dequantize_plain(qv, s, bf16)),
        bound_ms=b_ms, bound_by=b_by, library_ms=None)

    res["decode_attention"] = check_decode_attention(dev, g, err)
    res["ssd_scan"] = check_ssd_scan(dev, g, err)
    for name, r in res.items():
        lib_us = "none" if r["library_ms"] is None else f"{r['library_ms'] * 1e3:.1f} us"
        log(f"[kernels] {name}: max|err| {r['max_abs_err']:.3g} (tol {r['tol']}), "
            f"{r['ms'] * 1e3:.1f} us vs bound {r['bound_ms'] * 1e3:.2f} us ({r['bound_by']}), "
            f"plain {r['plain_ms'] * 1e3:.1f} us, library {lib_us}")
    return res


def check_decode_attention(dev, g, err) -> dict:
    """At both decode shapes of phase 5, with kv_len = the full cache (the
    last step) read from a device int32; garbage at and past kv_len must not
    change the output.  The line's times are those at the stablelm-3b shape
    (1024 of the decode phase's 1168 launches)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.decode_attention import ops as da
    from repro_torch.testing.parity import tol

    bf16, H, HD = torch.bfloat16, 32, 80
    out = None
    worst = 0.0
    for arch, B, S, n in DECODE_RUNS:
        L = S + n
        q = torch.randn(B, 1, H, HD, generator=g, device=dev).to(bf16)
        kc, vc = (torch.randn(B, L, H, HD, generator=g, device=dev).to(bf16) for _ in range(2))
        lens = torch.tensor(L, dtype=torch.int32, device=dev)
        got, want = da.decode_attention_bthd(q, kc, vc, lens), da.decode_attention_plain(
            q, kc, vc, lens)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, **tol(bf16))
        worst = max(worst, err(got, want))
        short = torch.tensor(L - 37, dtype=torch.int32, device=dev)
        before = da.decode_attention_bthd(q, kc, vc, short)
        kg, vg = kc.clone(), vc.clone()
        kg[:, L - 37:], vg[:, L - 37:] = 1e4, -1e4
        after = da.decode_attention_bthd(q, kg, vg, short)
        torch.cuda.synchronize()
        if not torch.equal(before, after):
            raise AssertionError(f"decode_attention ({arch} shape): values past kv_len leak "
                                 f"into the output ({err(before, after):.3g})")
        qh, kh, vh = q.transpose(1, 2), kc.transpose(1, 2), vc.transpose(1, 2)
        nbytes = 2 * B * L * H * HD * 2 + 2 * B * H * HD * 2 + 4
        # q.k and p.v: bf16 operands (p is cast to the cache's dtype)
        b_ms, b_by = bound_ms(nbytes, (4.0 * B * H * L * HD, BF16_FLOP_S))
        r = dict(
            max_abs_err=worst, tol=tol(bf16),
            ms=time_ms(lambda: da.decode_attention_bthd(q, kc, vc, lens)),
            plain_ms=time_ms(lambda: da.decode_attention_plain(q, kc, vc, lens)),
            bound_ms=b_ms, bound_by=b_by,
            library_ms=time_ms(lambda: F.scaled_dot_product_attention(qh, kh, vh)))
        log(f"[kernels] decode_attention at the {arch} shape q ({B}, 1, {H}, {HD}), cache "
            f"({B}, {L}, {H}, {HD}): {r['ms'] * 1e3:.3f} us vs bound {r['bound_ms'] * 1e3:.3f} "
            f"us, plain {r['plain_ms'] * 1e3:.3f} us, SDPA {r['library_ms'] * 1e3:.3f} us; "
            f"tail past kv_len masked")
        out = out or r
    out["max_abs_err"] = worst
    return out


def check_ssd_scan(dev, g, err) -> dict:
    """zamba2-2.7b's Mamba2 scan: q and k one (B, T, 64) tensor broadcast over
    80 heads (head stride 0), v (B, T, 80, 64), chunk 256.  Held to the plain
    version in f32 (atol 5e-4, rtol 2e-3, tests/test_kernels.py's SSD bound)
    on y and the final state at T = 512 and at a ragged T = 300, with gates
    log_g = -0.05 softplus(N(0, 1)) so that a 256-step chunk decays by about
    e^-9 and the carried state matters; then timed in bf16, the model's
    dtype."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.ssd_scan import ops as ssd
    from repro_torch.testing.parity import tol

    _, B, S, _ = DECODE_RUNS[1]
    NH, DS, HD, chunk = 80, 64, 64, 256
    tol_f32 = dict(atol=5e-4, rtol=2e-3)

    def inputs(T, dtype):
        c, bm = ((torch.randn(B, T, DS, generator=g, device=dev) * 0.5).to(dtype)
                 for _ in range(2))
        v = (torch.randn(B, T, NH, HD, generator=g, device=dev) * 0.5).to(dtype)
        log_g = -0.05 * F.softplus(torch.randn(B, T, NH, generator=g, device=dev))
        return (c[:, :, None].expand(B, T, NH, DS), bm[:, :, None].expand(B, T, NH, DS), v,
                log_g)

    worst = 0.0
    for T in (S, 300):
        args = inputs(T, torch.float32)
        (y, st), (y0, st0) = (ssd.ssd_scan_bthd(*args, chunk=chunk),
                              ssd.chunked_linear_attention_plain(*args, chunk=chunk))
        torch.cuda.synchronize()
        torch.testing.assert_close(y, y0, **tol_f32)
        torch.testing.assert_close(st, st0, **tol_f32)
        worst = max(worst, err(y, y0), err(st, st0))
        carried = float(st0.abs().max())
        log(f"[kernels] ssd_scan f32 T={T}: y max|err| {err(y, y0):.3g} at scale "
            f"{float(y0.abs().max()):.3g}, state max|err| {err(st, st0):.3g} at scale "
            f"{carried:.3g} (tol atol 5e-4, rtol 2e-3)")
    args = inputs(S, torch.bfloat16)
    y, st = ssd.ssd_scan_bthd(*args, chunk=chunk)
    y0, st0 = ssd.chunked_linear_attention_plain(*args, chunk=chunk)
    torch.cuda.synchronize()
    torch.testing.assert_close(y, y0, **tol(torch.bfloat16))
    torch.testing.assert_close(st, st0, **tol_f32)
    # bytes: C and B once (the broadcast is a view), v, the f32 gates, y and
    # the f32 state.  Operations, at the fastest rate that keeps each
    # product's precision: q.k over the causal (t, s) pairs of each chunk has
    # two bf16 operands (bf16 tensor cores, f32 accumulation); the decayed
    # scores times v, q times the state and the weighted k times v each have
    # an f32 operand (3xTF32)
    nbytes = 2 * B * S * DS * 2 + B * S * NH * HD * 2 * 2 + B * S * NH * 4 + B * NH * DS * HD * 4
    ops_bf16 = ops_f32 = 0.0
    for c0 in range(0, S, chunk):
        lc = min(chunk, S - c0)
        pairs = lc * (lc + 1) / 2
        ops_bf16 += pairs * 2 * DS
        ops_f32 += pairs * 2 * HD + 2 * 2 * lc * DS * HD
    b_ms, b_by = bound_ms(nbytes, (B * NH * ops_bf16, BF16_FLOP_S),
                          (B * NH * ops_f32, TF32X3_FLOP_S))
    return dict(
        max_abs_err=worst, tol=tol_f32,
        ms=time_ms(lambda: ssd.ssd_scan_bthd(*args, chunk=chunk)),
        # ~80 launches a call: few calls, or the launch queue fills and the
        # host waits on the card
        plain_ms=time_ms(lambda: ssd.chunked_linear_attention_plain(*args, chunk=chunk),
                         iters=5, warmup=2),
        bound_ms=b_ms, bound_by=b_by, library_ms=None)


# ----------------------------------------------------------------- phase 3


def pinned_plan(cfg):
    """stablelm-3b profile and the 2-stage pooled plan of
    examples/serve_pipeline.py's act 3: blocks [0, CUT) on a 3-member
    low-class pool, [CUT, n) on the one high-class chip."""
    from repro_torch.core import blocks, costmodel as cm
    from repro_torch.core.plan import ClusterPlan, PipelinePlan, StagePlan
    from repro_torch.core.types import ClusterSpec, replace
    from repro_torch.models.model_zoo import layer_costs

    cluster = ClusterSpec(counts={"tpu-hi": 1, "tpu-lo": 8})
    fastest = max((cluster.accel(c) for c in cluster.classes), key=lambda a: a.peak_flops)
    prof = blocks.build_profile(cfg.name, layer_costs(cfg, SEQ), slo_s=1.0,
                                n_blocks=N_BLOCKS, accel=fastest)
    prof = replace(prof, slo_s=8.0 * sum(cm.block_latency(b, fastest, 1, 1)
                                         for b in prof.blocks))
    tbl = cm.build_latency_table(prof, cluster)
    n = prof.n_blocks
    pipeline = PipelinePlan(
        model_name=cfg.name, batch_size=BATCH,
        stages=(StagePlan(0, CUT, "tpu-lo", 1, 3, tbl.partition(0, CUT, "tpu-lo", 1, BATCH)),
                StagePlan(CUT, n, "tpu-hi", 1, 1, tbl.partition(CUT, n, "tpu-hi", 1, BATCH))),
        xfer_latency_s=(cm.transfer_latency(prof, cluster, "tpu-lo", "tpu-hi", CUT, BATCH),),
    )
    return prof, ClusterPlan(cluster=cluster, pipelines=[pipeline])


def busy_share(run, tag: str) -> float | None:
    """Share of the wall time of `run()` (work that ends on the card) during
    which the card ran kernels, from torch.profiler; logs the top kernels
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
    for e in sorted(kernels, key=lambda e: -e.device_time_total)[:8]:
        log(f"[{tag}] profile: {e.device_time_total / busy_us:7.2%} of device time, "
            f"{e.count:5d} calls: {e.key[:90]}")
    host = [e for e in prof.key_averages()
            if getattr(e, "device_type", None) == torch.autograd.DeviceType.CPU]
    host_us = sum(e.self_cpu_time_total for e in host)
    for e in sorted(host, key=lambda e: -e.self_cpu_time_total)[:8]:
        log(f"[{tag}] profile: {e.self_cpu_time_total / host_us:7.2%} of host op time, "
            f"{e.count:5d} calls: {e.key[:90]}")
    log(f"[{tag}] profile: {len(kernels)} kernel names, {busy_us / 1e3:.3f} ms device time, "
        f"{host_us / 1e3:.3f} ms host op time, in {wall_us / 1e3:.3f} ms wall")
    return busy_us / wall_us


def device_busy_share(executors, dev, n_batches: int = 4) -> float | None:
    """Busy share over a window of back-to-back pipelined batches."""
    import torch

    from repro_torch.dataplane import PoolDispatcher

    disp = PoolDispatcher(executors, max_inflight=4)
    tokens = torch.ones((BATCH, SEQ), dtype=torch.int64, device=dev)

    def run():
        for _ in range(n_batches):
            disp.submit_chain(0, tokens)
        disp.drain_all()

    return busy_share(run, "serve")


def phase_serve(dev):
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core.runtime import build_runtime
    from repro_torch.data.requests import describe, poisson_trace
    from repro_torch.dataplane import DataPlane, PoolDispatcher, build_executors, calibrate_runtime
    from repro_torch.serving.engine import layer_block_map_from_profile

    cfg = get_config("stablelm-3b")
    prof, plan = pinned_plan(cfg)
    lbm = layer_block_map_from_profile(prof, cfg.n_layers)
    t0 = time.perf_counter()
    executors = build_executors(cfg, plan, lbm, torch.Generator(device=dev).manual_seed(SEED))
    torch.cuda.synchronize()
    params = executors[0][0].params
    n_params = sum(p.numel() for p in params.parameters())
    stages = plan.pipelines[0].stages
    blocks = [(s.block_start, s.block_end) for s in stages]
    layers = [(lbm[s.block_start][0], lbm[s.block_end - 1][1]) for s in stages]
    log(f"[serve] {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, {cfg.n_heads} heads "
        f"x {cfg.hd}, {n_params / 1e9:.3f} B params bf16 initialised on {dev} in "
        f"{time.perf_counter() - t0:.1f} s; stage blocks {blocks} -> layers {layers}")

    rt = build_runtime(plan, {cfg.name: prof})
    t0 = time.perf_counter()
    measured = calibrate_runtime(rt, executors, SEQ)
    log(f"[serve] calibrate_runtime in {time.perf_counter() - t0:.1f} s")
    for (pid, si, bs), sec in sorted(measured.items()):
        log(f"[serve] calibrated stage {si} batch {bs}: {sec * 1e3:.3f} ms")
    p0 = rt.pipelines[0]
    e2e = sum(s.latency(1) for s in p0.stages)
    thr = min(len(s.vdevs) * p0.unified_batch / s.latency(p0.unified_batch) for s in p0.stages)
    rate = thr * 0.5
    trace = poisson_trace(rate, 4 * N_REQUESTS / rate, e2e * 6, cfg.name, seed=11)[:N_REQUESTS]
    st = describe(trace)
    log(f"[serve] calibrated batch-1 e2e {e2e * 1e3:.3f} ms, pipeline throughput "
        f"{thr:.1f} rps; trace {st.n} requests at {rate:.1f} rps, SLO {st.slo_s * 1e3:.3f} ms")

    disp = PoolDispatcher.from_runtime(rt, executors, max_inflight=4)
    dp = DataPlane(rt, dispatcher=disp, feedback="measured", seq_len=SEQ)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    tel = dp.serve(trace)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts()

    batches = disp.submitted
    if len(tel.outcomes) != len(trace) or {o.req_id for o in tel.outcomes} != \
            {r.req_id for r in trace}:
        raise AssertionError(f"{len(tel.outcomes)} outcomes for {len(trace)} requests")
    if dp.fb.observations <= 0:
        raise AssertionError("measured feedback made no observation")
    if batches <= 0:
        raise AssertionError("no batch was dispatched")
    for name in ("rmsnorm", "flash_attention"):
        if launches[name] < cfg.n_layers * batches:
            raise AssertionError(f"{name} launched {launches[name]} times for {batches} "
                                 f"batches of {cfg.n_layers} layers")
    lats = np.array([o.completion_s - o.arrival_s for o in tel.outcomes
                     if o.completion_s is not None])
    log(f"[serve] served {tel.served}/{len(trace)} in {wall:.2f} s wall, attainment "
        f"{tel.attainment:.4f}, latency p50 {np.percentile(lats, 50) * 1e3:.3f} ms p99 "
        f"{np.percentile(lats, 99) * 1e3:.3f} ms, batches {batches} (mean size "
        f"{tel.mean_batch_size:.2f}), inflight_hwm {tel.inflight_hwm}, feedback "
        f"observations {dp.fb.observations}, lat_scale "
        f"{[round(s.lat_scale, 4) for s in p0.stages]}")
    for (e, pid, si), ws in sorted(tel.stage_wall_s.items()):
        log(f"[serve] measured stage {si} wall: median {np.median(ws) * 1e3:.3f} ms over "
            f"{len(ws)} batches")
    log(f"[serve] launches while serving: {launches} ({batches} batches; on one card every "
        f"stage shares the device, so transfer() skips the boundary kernels)")
    share = device_busy_share(executors, dev)
    log("[serve] device busy share over 4 back-to-back batches: "
        + ("not measured (profiler recorded no device time)" if share is None
           else f"{share:.4f}"))
    return cfg, executors, launches


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


def kernel_counters() -> dict:
    from repro_torch.kernels.boundary_quant import ops as bq
    from repro_torch.kernels.decode_attention import ops as da
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.rmsnorm import ops as rn
    from repro_torch.kernels.ssd_scan import ops as ssd

    return {"rmsnorm": rn.rmsnorm, "flash_attention": fa.flash_attention,
            "quantize": bq.quantize, "dequantize": bq.dequantize,
            "decode_attention": da.decode_attention, "ssd_scan": ssd.ssd_scan}


def reset_counts() -> None:
    for fn in kernel_counters().values():
        fn.launches = 0


def read_counts() -> dict:
    return {name: fn.launches for name, fn in kernel_counters().items()}


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
    logits from its?  The kernels in f32 (the prefill's attention through
    the plain math: flash_attention takes bf16 only): for the dense model
    the invariant must hold there with decisive positions, so the check can
    fail; zamba2-2.7b's f32 forward is itself too sensitive for that, which
    the last reading shows: the f32 forward's move when the embeddings are
    scaled by 1 + 2^-22 (two ulps).  zamba2-2.7b's whole-model check is
    `cache_walk`'s."""
    import copy
    import dataclasses

    import torch

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
    ops32 = dataclasses.replace(KERNELS, attention=PLAIN.attention)
    got32, full32 = teacher_forced(model32, params32, prompts, fed, ops32)
    params32["embed"].mul_(1 + 2.0 ** -22)
    seq = torch.cat([prompts, *fed], dim=1)
    nudged = model32.forward(params32, {"tokens": seq}, ops=ops32)[:, S - 1:].float()
    torch.cuda.synchronize()
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


def decode_run(arch: str, B: int, S: int, n: int, params, dev) -> tuple[dict, object]:
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


def phase_decode(serve_params, dev) -> dict:
    """Both decode runs; returns the decode path's launch counts (each run
    counted from 0 before its prefill to after its decode loop)."""
    import torch

    total: dict = {}
    for arch, B, S, n in DECODE_RUNS:
        counts, params = decode_run(arch, B, S, n, serve_params if arch == "stablelm-3b"
                                    else None, dev)
        total = {k: total.get(k, 0) + v for k, v in counts.items()}
        del params
        torch.cuda.empty_cache()
    return total


def main() -> int:
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
    phase_build()
    smi = gpu_line()
    log(f"[env] nvidia-smi: {smi}")
    kern = phase_kernels(dev)
    cfg, executors, launches = phase_serve(dev)
    phase_parity(cfg, executors, dev)
    decode = phase_decode(executors[0][0].params, dev)
    launches = {name: {"serve": launches[name], "decode": decode[name]} for name in KERNEL_NAMES}
    log(f"[done] all phases passed in {time.perf_counter() - t_start:.1f} s")
    print(smi)
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": KERNEL_SOURCES[name][0],
         "replaces": KERNEL_SOURCES[name][1], "launches": sum(launches[name].values()),
         "launches_by_path": launches[name],
         "max_abs_err": kern[name]["max_abs_err"], "ms": kern[name]["ms"],
         "plain_ms": kern[name]["plain_ms"], "bound_ms": kern[name]["bound_ms"],
         "bound_by": kern[name]["bound_by"], "library_ms": kern[name]["library_ms"]}
        for name in KERNEL_NAMES]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
