#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (src/repro_torch) on one NVIDIA GPU.

Run from a checkout of the repository:

    python3 chip_smoke.py

Phases, each of which must pass (any failure raises and exits non-zero):

1. build the three CUDA kernels from `src/repro_torch/kernels/*/csrc` with
   nvcc for sm_90a, one nvcc per source, in parallel;
2. hold every kernel against its plain PyTorch version on the card at the
   serving path's shapes, and time it beside its bound, its plain version
   and one PyTorch library call (a yardstick only; the port never calls it);
3. serve stablelm-3b at full width (32 layers, random weights from a seed)
   through calibrate_runtime -> PoolDispatcher -> DataPlane with measured
   feedback, on the hand-pinned 2-stage pooled plan, and show that serving
   launched the RMSNorm and attention kernels;
4. check the full-width stage split through the kernels against the plain
   PyTorch math on the same parameters: layer by layer from the same input,
   and the whole forward by the decisive-margin top-1 rule.

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

# NVIDIA H100 SXM data sheet (dense): HBM rate, bf16 tensor-core peak, f32 peak
HBM_BYTES_S = 3.35e12
BF16_FLOP_S = 989e12
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
}


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


def bound_ms(nbytes: float, ops: float, peak_ops: float) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / HBM_BYTES_S, ops / peak_ops
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
    b_ms, b_by = bound_ms(nbytes, 4.0 * N * D, F32_FLOP_S)
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
    b_ms, b_by = bound_ms(4 * BATCH * SEQ * H * HD * 2, 4.0 * pairs * HD, BF16_FLOP_S)
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
    b_ms, b_by = bound_ms(N * D * 2 + N * D + N * 4, 3.0 * N * D, F32_FLOP_S)
    res["quantize"] = dict(
        max_abs_err=float((qv.int() - qp.int()).abs().max()), tol="bit-equal",
        ms=time_ms(lambda: bq.quantize(h)), plain_ms=time_ms(lambda: bq.quantize_plain(h)),
        bound_ms=b_ms, bound_by=b_by, library_ms=None)
    got, want = bq.dequantize(qv, s, bf16), bq.dequantize_plain(qv, s, bf16)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        raise AssertionError(f"dequantize differs from its plain version by {err(got, want)}")
    b_ms, b_by = bound_ms(N * D + N * 4 + N * D * 2, 1.0 * N * D, F32_FLOP_S)
    res["dequantize"] = dict(
        max_abs_err=err(got, want), tol="bit-equal",
        ms=time_ms(lambda: bq.dequantize(qv, s, bf16)),
        plain_ms=time_ms(lambda: bq.dequantize_plain(qv, s, bf16)),
        bound_ms=b_ms, bound_by=b_by, library_ms=None)
    for name, r in res.items():
        lib_us = "none" if r["library_ms"] is None else f"{r['library_ms'] * 1e3:.1f} us"
        log(f"[kernels] {name}: max|err| {r['max_abs_err']:.3g} (tol {r['tol']}), "
            f"{r['ms'] * 1e3:.1f} us vs bound {r['bound_ms'] * 1e3:.2f} us ({r['bound_by']}), "
            f"plain {r['plain_ms'] * 1e3:.1f} us, library {lib_us}")
    return res


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


def device_busy_share(executors, dev, n_batches: int = 4) -> float | None:
    """Share of a window of back-to-back pipelined batches during which the
    card ran kernels, from torch.profiler; None if it recorded no device
    time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.dataplane import PoolDispatcher

    disp = PoolDispatcher(executors, max_inflight=4)
    tokens = torch.ones((BATCH, SEQ), dtype=torch.int64, device=dev)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n_batches):
            disp.submit_chain(0, tokens)
        disp.drain_all()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.key_averages()
               if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.device_time_total for e in kernels)
    if busy_us <= 0:
        return None
    for e in sorted(kernels, key=lambda e: -e.device_time_total)[:8]:
        log(f"[serve] profile: {e.device_time_total / busy_us:7.2%} of device time, "
            f"{e.count:5d} calls: {e.key[:90]}")
    host = [e for e in prof.key_averages()
            if getattr(e, "device_type", None) == torch.autograd.DeviceType.CPU]
    host_us = sum(e.self_cpu_time_total for e in host)
    for e in sorted(host, key=lambda e: -e.self_cpu_time_total)[:8]:
        log(f"[serve] profile: {e.self_cpu_time_total / host_us:7.2%} of host op time, "
            f"{e.count:5d} calls: {e.key[:90]}")
    log(f"[serve] profile: {len(kernels)} kernel names, {busy_us / 1e3:.3f} ms device time, "
        f"{host_us / 1e3:.3f} ms host op time, in {wall_us / 1e3:.3f} ms wall")
    return busy_us / wall_us


def phase_serve(dev):
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core.runtime import build_runtime
    from repro_torch.data.requests import describe, poisson_trace
    from repro_torch.dataplane import DataPlane, PoolDispatcher, build_executors, calibrate_runtime
    from repro_torch.kernels.boundary_quant import ops as bq
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.rmsnorm import ops as rn
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
    for fn in (rn.rmsnorm, fa.flash_attention, bq.quantize, bq.dequantize):
        fn.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tel = dp.serve(trace)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"rmsnorm": rn.rmsnorm.launches, "flash_attention": fa.flash_attention.launches,
                "quantize": bq.quantize.launches, "dequantize": bq.dequantize.launches}

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
    log(f"[done] all phases passed in {time.perf_counter() - t_start:.1f} s")
    print(smi)
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": KERNEL_SOURCES[name][0],
         "replaces": KERNEL_SOURCES[name][1], "launches": launches[name],
         "max_abs_err": kern[name]["max_abs_err"], "ms": kern[name]["ms"],
         "plain_ms": kern[name]["plain_ms"], "bound_ms": kern[name]["bound_ms"],
         "bound_by": kern[name]["bound_by"], "library_ms": kern[name]["library_ms"]}
        for name in ("rmsnorm", "flash_attention", "quantize", "dequantize")]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
