"""End-to-end pooled-pipeline serving through the public `repro_torch.api`
facade: the port's counterpart of the reference's
`examples/serve_pipeline.py`.

    PYTHONPATH=src python -m repro_torch.examples.serve_pipeline [--quick] [--device cpu]

The full PPipe flow on one host — one declarative `ServeConfig`, one
`Session` lifecycle per deployment (profile -> plan -> deploy -> submit/run
-> swap -> report), no hand-wired executors/dispatchers anywhere — in four
acts:

1/2. cost-model profile -> MILP control plane -> `deploy(mode="real")`
   (stage executors + overlapped pool dispatch, built by the session)
   serving a Poisson and a bursty trace with SLO-aware admission and
   reservation-driven adaptive batching (Algorithm 1).  Per-workload SLO
   attainment and latency come straight off the `RequestHandle`s.

3. a 2-stage pooled pipeline (low-class pool feeding a high-class pool,
   boundary activations quantized between partitions on different
   devices; on one card the pools are co-resident and the boundary passes
   as it is) pinned via `session.use_plan` and served in *measured* mode:
   the session calibrates stage latencies from real execution at deploy,
   so the scheduler's virtual clock is the wall clock, and the
   feedback-correction loop keeps the reservation tables in sync.

4. a live plan hot-swap on the real execution path: mid-trace,
   `session.swap(plan)` installs a fresh runtime — the session auto-builds
   the dispatcher from its executor cache (identical block ranges, so
   nothing is built again and `SwapRecord.new_ranges` is empty), in-flight
   batches drain on the retired epoch, and the epoch is garbage-collected
   the moment its last batch completes.

Real mode runs on the card unless `--device` names another device: there
every stage replays a CUDA graph captured at deploy, through the port's
RMSNorm and flash-attention kernels at the example's widths (d_model 256,
4 heads of 64, 32 tokens a request); `--device cpu` runs the same stages
through the kernels' plain PyTorch versions.  The cluster is the
reference's shape in the port's GPU classes: one h100 beside eight l4
stand-ins (`CLUSTER`), every pool co-resident on the one card.  The
widths, SLO scales and traces are the reference's: on these classes every
act plans, pins and serves as its docstring says, so nothing else changed.

Every workload must be served whole: `serve_workload` raises unless every
request was served with no executor failure and no retry, because the data
plane drops the batch of an executor that raised (a kernel that refused
its shape or failed to launch), which would otherwise pass unseen.

At reduced-model scale the MILP prefers single-partition pooled pipelines —
µs-scale stages cannot amortize the fixed connection overhead of a feature-
map transfer (the paper's CNNs run at ms scale, where partitioning wins) —
which is why act 3 pins the partitioning explicitly.
"""

import argparse
import time

import torch

from repro_torch.api import ClusterSpec, ModelSpec, ServeConfig, Session
from repro_torch.core import costmodel as cm
from repro_torch.core.plan import ClusterPlan, PipelinePlan, StagePlan
from repro_torch.data.requests import bursty_trace, describe, poisson_trace

SEQ = 32
REDUCED = dict(n_layers=8, d_model=256, d_ff=512, n_heads=4, kv_heads=4,
               vocab=2048)
# the high class first, then the low class whose pool feeds it in act 3
CLUSTER = {"h100": 1, "l4": 8}


def base_config(feedback: str = "planned", slo_scale: float = 3.0
                ) -> ServeConfig:
    return ServeConfig(
        cluster=ClusterSpec(counts=dict(CLUSTER)),
        models=(ModelSpec(arch="stablelm-3b", reduced=REDUCED, n_blocks=6,
                          seq_len=SEQ, slo_scale=slo_scale),),
        feedback=feedback,
        serve_seq_len=SEQ,
    )


def staged_plan(session: Session, bs: int = 4, cut: int = 3) -> ClusterPlan:
    """Hand-pinned 2-stage pooled pipeline: 3-member low-class pool for the
    early blocks, the high-class chip for the rest (act 3)."""
    prof = session.store.profiles["stablelm-3b"]
    tbl = session.store.analytic_table("stablelm-3b")
    cluster = session.config.cluster
    hi, lo = cluster.counts
    n = prof.n_blocks
    pipeline = PipelinePlan(
        model_name="stablelm-3b", batch_size=bs,
        stages=(
            StagePlan(0, cut, lo, 1, 3, tbl.partition(0, cut, lo, 1, bs)),
            StagePlan(cut, n, hi, 1, 1, tbl.partition(cut, n, hi, 1, bs)),
        ),
        xfer_latency_s=(cm.transfer_latency(prof, cluster, lo, hi, cut, bs),),
    )
    return ClusterPlan(cluster=cluster, pipelines=[pipeline])


def serve_workload(session: Session, name: str, trace) -> dict:
    """Submit a trace, drain it, and report per-workload stats from the
    request handles.  One workload per session: a session serves one
    monotonic virtual clock, so independent traces (each starting at t=0)
    replay on fresh deployments — exactly what drain() enforces.  Raises
    unless every request was served with no executor failure or retry;
    returns the workload's stats."""
    handles = [session.submit(r) for r in trace]
    t0 = time.perf_counter()
    session.drain()
    wall = time.perf_counter() - t0
    ok = sum(h.ok for h in handles)
    served = sum(h.latency_s is not None for h in handles)
    lats = sorted(h.latency_s for h in handles if h.latency_s is not None)
    st = describe(trace)
    p50 = lats[len(lats) // 2] * 1e3 if lats else 0.0
    print(f"\n[{name}] {st.n} reqs, mean {st.mean_rps:.0f} rps "
          f"(peak {st.peak_rps:.0f}), interarrival CV {st.cv_interarrival:.2f}, "
          f"SLO {st.slo_s*1e3:.3f} ms  ({wall:.2f}s wall)")
    print(f"  served {served}/{len(trace)} "
          f"(attainment {ok/len(trace):.1%}), latency p50 {p50:.3f} ms")
    assert all(h.done for h in handles)  # every handle resolved by drain()
    tel = session.telemetry
    if served != len(trace) or tel.exec_failures or tel.retries:
        raise RuntimeError(
            f"[{name}] served {served}/{len(trace)}; executor failures "
            f"{tel.exec_failures}, retries {tel.retries}, drops "
            f"{tel.snapshot()['drops']}")
    return dict(name=name, n=len(trace), served=served, wall_s=wall,
                attainment=ok / len(trace), p50_ms=p50)


def live_swap_demo(n_req: int, device) -> dict:
    """Act 4: zero-downtime plan refresh on real execution, on a fresh
    deployment.  `session.swap` rebuilds runtime + dispatcher mid-trace from
    the session's executor cache (identical block ranges -> nothing built
    again), old batches drain on the retired epoch, GC reclaims it."""
    with Session.from_config(base_config(), device=device) as session:
        plan = session.plan()
        session.deploy(mode="real")
        prof = session.store.profiles["stablelm-3b"]
        rate = plan.throughput * 0.5
        trace = poisson_trace(rate, n_req / rate, prof.slo_s, "stablelm-3b",
                              seed=13)
        mid = trace[len(trace) // 2].arrival_s
        state = {}

        def hook(req, t):
            if not state and t > mid:
                state["inflight"] = len(session.dataplane.jobs)
                state["rec"] = session.swap(plan, now=t, reason="live refresh")

        session.on_arrival(hook)
        stats = serve_workload(session, "live swap", trace)
        tel = session.telemetry
        rec = state["rec"]
        assert tel.plan_swaps == 1 and tel.epochs_gcd == 1
        assert rec.new_ranges == ()  # same partitioning: everything reused
        print(f"  swap with {state['inflight']} batch(es) in flight took "
              f"{rec.swap_wall_s*1e3:.1f} ms wall "
              f"(compile {rec.compile_wall_s*1e3:.2f} ms, "
              f"{rec.reused_executors} executor(s) reused), virtual transient "
              f"{tel.swap_transient_s[-1]*1e3:.3f} ms; retired epoch GC'd "
              f"({tel.epochs_gcd}/{tel.plan_swaps})")
        return stats


def main(argv=None) -> list[dict]:
    """Run the four acts; returns each workload's stats."""
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--quick", action="store_true",
                    help="smaller traces (CI smoke run)")
    ap.add_argument("--device", default="cuda",
                    help="where real mode runs (default: the card)")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    n_req = 32 if args.quick else 96
    results = []

    # ---- acts 1/2: MILP plan, planned feedback, Poisson + bursty ----------
    # one session per workload: both traces start at t=0, and a session
    # serves one monotonic virtual clock (drain() enforces it)
    for i, (name, gen) in enumerate((("poisson", poisson_trace),
                                     ("bursty", bursty_trace))):
        with Session.from_config(base_config(), device=device) as session:
            plan = session.plan()
            if i == 0:
                print(plan.summary())
            session.deploy(mode="real")
            prof = session.store.profiles["stablelm-3b"]
            rate = plan.throughput * 0.6
            trace = gen(rate, n_req / rate, prof.slo_s, "stablelm-3b", seed=7)
            results.append(serve_workload(session, name, trace))

    # ---- act 3: pinned 2-stage pipeline, measured (calibrated) feedback ---
    # generous analytic SLO: the hand-pinned 2-stage plan must pass
    # use_plan's validate (the MILP would not partition at this scale); the
    # act's trace SLO comes from the *calibrated* latency, not the profile
    with Session.from_config(base_config(feedback="measured", slo_scale=8.0),
                             device=device) as session:
        session.profile()
        plan2 = staged_plan(session)
        print("\n" + plan2.summary())
        session.use_plan(plan2)
        session.deploy(mode="real")  # calibrates: virtual clock == wall clock
        p0 = session.runtime.pipelines[0]
        e2e = sum(s.latency(1) for s in p0.stages)
        thr = min(len(s.vdevs) * p0.unified_batch / s.latency(p0.unified_batch)
                  for s in p0.stages)
        print(f"calibrated: e2e batch-1 latency {e2e*1e3:.1f} ms, "
              f"measured pipeline throughput ~{thr:.0f} rps")
        rate = thr * 0.5
        n_meas = max(24, n_req // 3)
        trace = bursty_trace(rate, n_meas / rate, e2e * 6, "stablelm-3b",
                             seed=11)
        results.append(serve_workload(session, "bursty/measured 2-stage", trace))
        print("  " + session.report().summary())

    # ---- act 4: live plan hot-swap through the facade ---------------------
    results.append(live_swap_demo(n_req, device))
    return results


if __name__ == "__main__":
    main()
