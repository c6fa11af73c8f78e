"""Open-loop streaming through the public `repro_torch.api` facade (the
port's counterpart of the reference's `examples/stream_serve.py`).

    PYTHONPATH=src python -m repro_torch.examples.stream_serve [--quick]

Where `serve_pipeline.py` replays finite traces, this example drives the
continuous front-end: a declarative `SourceConfig` arrival process pulled
incrementally through `Session.serve`, in three acts:

1. a two-camera workload (flash-crowd detector feed + out-of-phase diurnal
   classifier feed) declared entirely in `ServeConfig.stream` — nothing is
   materialized, `serve(horizon_s=...)` pulls arrivals one lookahead at a
   time, so an hour of virtual time costs O(1) memory.  Rolling windows
   from `repro_torch.obs` give per-window attainment and the cumulative-so-far
   series that open-ended serving reports.

2. a 4x overload against watermark backpressure: generous SLOs keep the
   backlog feasible-but-waiting, the queue climbs to `high_watermark`,
   admission sheds only provably-doomed requests (position-aware completion
   bound) then door-rejects, and re-opens at `low_watermark` — every
   shed/resume edge journaled as `admit.*` events.  The SLO scale is 30x
   the fastest batch-1 latency (`BACKPRESSURE_SLO_SCALE`; the reference's
   TPU classes take 20x): on the port's GPU classes a 20x SLO makes the
   MILP partition the model into one l4 x4 -> h100 x2 pipeline at batch
   4, planned at 18.61 ms end to end against a 40.96 ms SLO (the cost
   model's latencies), and a request sixth in
   line would wait 1.5 batch cycles before its own, (6 / 4 + 1) x 18.61 =
   46.5 ms: it is doomed before the queue reaches the high watermark, so
   the scheduler drops the backlog at scheduling time, no watermark edge
   fires, and the act has nothing to show.  At 30x the MILP plans one
   unpartitioned pool a class, as it does on the TPU classes at 20x, and
   the backlog waits feasibly up to the watermark.

Simulated: no card is needed.  The cluster is the reference's 2 high-class
+ 4 low-class shape in the port's GPU classes (`CLUSTER`).

3. the parity anchor: `serve(TraceSource(trace))` is bit-for-bit identical
   to `run(trace)` — streaming admission is a pure refactoring of batch
   replay, checked on outcomes AND the full telemetry snapshot.
"""

import argparse

from repro_torch.api import (
    AdmissionPolicy,
    ClusterSpec,
    ModelSpec,
    ObsConfig,
    ServeConfig,
    Session,
    SourceConfig,
)
from repro_torch.data.requests import poisson_trace
from repro_torch.stream import PoissonSource, TraceSource

CLUSTER = {"h100": 2, "l4": 4}
MODEL = "stablelm-3b"
# act 2's SLO, in multiples of the fastest batch-1 latency (docstring)
BACKPRESSURE_SLO_SCALE = 30.0


def base_config(**over) -> ServeConfig:
    base = dict(
        cluster=ClusterSpec(counts=dict(CLUSTER)),
        models=(ModelSpec(arch=MODEL, seq_len=256, n_blocks=5),),
    )
    base.update(over)
    return ServeConfig(**base)


def multi_camera_serve(horizon: float) -> None:
    """Act 1: declarative two-camera stream, windowed + cumulative report."""
    period = 2.0 * horizon  # one half-swing of drift inside the horizon
    stream = SourceConfig(kind="multi_camera", cameras=(
        SourceConfig(kind="flash", model=MODEL, rate_rps=60.0,
                     period_s=period, amplitude=0.6, phase_s=period / 4,
                     flash_mult=3.0, flash_s=1.0,
                     mean_flash_interval_s=5.0, seed=1),
        SourceConfig(kind="diurnal", model=MODEL, rate_rps=40.0,
                     period_s=period, amplitude=0.6,
                     phase_s=3 * period / 4, seed=2),
    ))
    cfg = base_config(stream=stream,
                      obs=ObsConfig(level="aggregate",
                                    window_s=horizon / 8))
    with Session.from_config(cfg) as session:
        session.plan()
        session.deploy(mode="sim")
        # no source argument: serve() builds one from config.stream, with
        # per-camera SLOs resolved from the profiled models
        report = session.serve(horizon_s=horizon)
        tel = report.telemetry
        ts = report.timeseries()
        print(f"[multi-camera] {len(tel.outcomes)} arrivals over "
              f"{horizon:.0f}s virtual (goodput {tel.goodput_rps:.0f} rps, "
              f"attainment {tel.attainment:.1%})")
        attn = ts["attainment"]
        print("  per-window attainment: "
              + " ".join(f"{a:.2f}" for a in attn))
        cum = ts["cumulative"]
        print(f"  cumulative-so-far: ok {cum['ok'][-1]}, "
              f"goodput {cum['goodput_rps'][-1]:.0f} rps "
              f"(requested horizon {tel.requested_horizon_s:.0f}s)")


def backpressure_demo(horizon: float) -> None:
    """Act 2: 4x overload against watermarks; shed/resume edges journaled."""
    cfg = base_config(
        # generous SLO: overload work stays feasible-but-waiting, so the
        # backlog actually builds (tight SLOs drop it at scheduling time
        # before the watermark can trip)
        models=(ModelSpec(arch=MODEL, seq_len=256, n_blocks=5,
                          slo_scale=BACKPRESSURE_SLO_SCALE),),
        admission=AdmissionPolicy(high_watermark=6, low_watermark=2),
        obs=ObsConfig(level="aggregate", window_s=horizon / 8),
    )
    with Session.from_config(cfg) as session:
        plan = session.plan()
        session.deploy(mode="sim")
        slo = session.store.profiles[MODEL].slo_s
        source = PoissonSource(plan.throughput * 4.0, slo_s=slo,
                               model_name=MODEL, seed=7)
        report = session.serve(source, horizon_s=horizon)
        tel = report.telemetry
        drops = tel.snapshot()["drops"]
        edges = tel.backpressure_events
        sheds = sum(1 for e in edges if e[2] == "shed")
        journal = [e["kind"] for e in report.obs.journal.events
                   if e["kind"].startswith("admit.")]
        edge_depth = max(e[3] for e in edges)
        print(f"\n[backpressure] 4x overload, watermarks high=6/low=2: "
              f"{len(tel.outcomes)} arrivals, attainment {tel.attainment:.1%}")
        print(f"  door-rejected {drops.get('backpressure_reject', 0)}, "
              f"shed-doomed {drops.get('backpressure_shed', 0)}, "
              f"settled edge depth max {edge_depth} (never > high)")
        print(f"  {sheds} shed / {len(edges) - sheds} resume edges, "
              f"{len(journal)} admit.* journal events (alternating)")
        assert edge_depth <= 6
        kinds = [e[2] for e in edges]
        assert all(a != b for a, b in zip(kinds, kinds[1:]))  # alternating


def parity_check() -> None:
    """Act 3: run(trace) == serve(TraceSource(trace)), bit for bit."""
    def deployed():
        session = Session.from_config(base_config())
        plan = session.plan()
        session.deploy(mode="sim")
        return session, plan

    sa, plan = deployed()
    sb, _ = deployed()
    slo = sa.store.profiles[MODEL].slo_s
    trace = poisson_trace(plan.throughput * 1.2, 1.0, slo, MODEL, seed=3)
    ra = sa.run(trace)
    rb = sb.serve(TraceSource(trace))
    assert ra.telemetry.outcomes == rb.telemetry.outcomes
    assert ra.telemetry.snapshot() == rb.telemetry.snapshot()
    print(f"\n[parity] run(trace) == serve(TraceSource(trace)) on "
          f"{len(trace)} requests: outcomes and telemetry snapshot "
          "bit-identical")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--quick", action="store_true",
                    help="shorter horizons (CI smoke run)")
    args = ap.parse_args(argv)
    horizon = 4.0 if args.quick else 20.0
    multi_camera_serve(horizon)
    backpressure_demo(horizon / 2)
    parity_check()


if __name__ == "__main__":
    main()
