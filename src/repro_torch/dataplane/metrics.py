"""Data-plane telemetry: the paper's Fig. 8/9 metrics, live.

Collected per serve() run: SLO attainment and goodput (Fig. 6/7/9), per-class
temporal GPU utilization (Fig. 8), queue delay distribution, drop attribution
(admission reject vs overflow shed vs expiry vs Algorithm-1 drop), adaptive
batch-size history, measured stage wall times, and the dispatcher's in-flight
high-water mark (proof that pool dispatch actually overlaps).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from repro_torch.core.runtime import ClusterRuntime, busy_by_class
from repro_torch.core.types import RequestOutcome, attainment

# snapshot() schema version for BENCH_e2e.json / report consumers: bump on
# any breaking change to the snapshot layout (renamed/removed keys or
# changed value meanings; additive keys do not bump it)
SCHEMA_VERSION = 2


@dataclass
class DispatchRecord:
    """One Algorithm-1 dispatch decision (for batching-behaviour assertions)."""

    t_s: float
    pipeline_id: int
    batch_size: int
    planned_finish_s: float
    oldest_deadline_s: float
    queue_len_after: int
    # plan epoch the dispatch ran under (bumped by DataPlane.swap_plan);
    # pipeline_id is only unique within an epoch
    epoch: int = 0


@dataclass
class Telemetry:
    outcomes: list[RequestOutcome] = field(default_factory=list)
    queue_delay_s: list[float] = field(default_factory=list)
    dispatches: list[DispatchRecord] = field(default_factory=list)
    admission_rejects: int = 0
    backpressure_rejects: int = 0
    overflow_sheds: int = 0
    expiry_drops: int = 0
    sched_drops: int = 0
    exec_failures: int = 0
    # elastic-cluster fault accounting (repro.faults / DESIGN.md §13):
    # requests dropped because their node was preempted and the certified
    # re-admission bound said the deadline was unreachable; injected fault
    # events; node-loss episodes; bounded-retry attempts and exhaustions;
    # and completed Session.resize transitions
    node_loss_drops: int = 0
    faults_injected: int = 0
    node_losses: int = 0
    retries: int = 0
    retry_exhausted: int = 0
    resizes: int = 0
    inflight_hwm: int = 0
    probes_per_dispatch: float = 0.0
    # Algorithm-1 hot-path counters accumulated across plan epochs (probe
    # memo hits, batch-size bisection searches — see core.scheduler
    # .SchedulerStats); filled by DataPlane.serve
    scheduler: dict = field(default_factory=dict)
    horizon_s: float = 0.0
    # horizon the caller *requested* for an open-ended serve (serve_stream's
    # horizon_s argument); None for finite-trace replays, where the horizon
    # is simply the last event time.  When set, horizon_s = max(last event,
    # requested) so goodput denominates over the full requested window.
    requested_horizon_s: float | None = None
    # (t_s, model, "shed"|"resume", queue_depth) per watermark transition —
    # the backpressure episode log mirrored into obs as admit.shed/resume
    backpressure_events: list = field(default_factory=list)
    # live re-planning (repro.controlplane): completed plan hot-swaps, and one
    # (virtual time, reason) entry per swap for continuity assertions
    plan_swaps: int = 0
    swap_log: list = field(default_factory=list)
    # replan governance (controlplane.ReplanPolicy): every considered re-solve
    # as a JSON-able dict {t_s, accepted, reason, benefit_rps, cost_s, ...} —
    # rejected candidates are as much a control action as accepted ones
    replan_decisions: list = field(default_factory=list)
    # virtual seconds the new epoch's pools were throttled by residual
    # occupancy carried from older epochs, one entry per swap: the measured
    # swap transient the replan policy prices into its cost/benefit gate
    swap_transient_s: list = field(default_factory=list)
    # retired-epoch GC: epochs whose runtimes/dispatchers were dropped before
    # finalize, and the busy chip-seconds per class frozen per epoch at
    # retire time (horizon-independent, so utilization stays exact)
    epochs_gcd: int = 0
    epoch_busy: dict = field(default_factory=dict)
    # measured wall seconds per (epoch, pipeline_id, stage_idx), real
    # execution only (pipeline ids restart at 0 after each plan swap)
    stage_wall_s: dict = field(default_factory=dict)
    batch_wall_s: list[float] = field(default_factory=list)
    utilization: dict = field(default_factory=dict)
    feedback_scales: dict = field(default_factory=dict)

    # ----------------------------------------------------------- aggregates
    @property
    def attainment(self) -> float:
        return attainment(self.outcomes)

    @property
    def served(self) -> int:
        return sum(1 for o in self.outcomes if o.completion_s is not None)

    @property
    def dropped(self) -> int:
        return sum(1 for o in self.outcomes if o.completion_s is None)

    @property
    def goodput_rps(self) -> float:
        """Requests completed within SLO per second (paper's goodput)."""
        ok = sum(1 for o in self.outcomes if o.ok)
        return ok / max(self.horizon_s, 1e-9)

    @property
    def mean_batch_size(self) -> float:
        if not self.dispatches:
            return 0.0
        return float(np.mean([d.batch_size for d in self.dispatches]))

    def queue_delay_pct(self, q: float) -> float:
        if not self.queue_delay_s:
            return 0.0
        if len(self.queue_delay_s) == 1:
            # a 1-sample percentile is that sample; skip interpolation noise
            return float(self.queue_delay_s[0])
        return float(np.percentile(self.queue_delay_s, q))

    # -------------------------------------------------------------- finish
    def absorb_epoch(self, epoch: int, runtime: ClusterRuntime) -> None:
        """Freeze a retiring epoch's horizon-independent aggregates so its
        runtime can be dropped (retired-epoch GC): busy chip-seconds per class
        plus any drifted feedback scales.  `finalize` folds the frozen
        contributions back in — in epoch order, so utilization comes out
        float-identical to keeping every retired runtime until the end."""
        self.epoch_busy[epoch] = busy_by_class(runtime)
        self._absorb_scales(epoch, runtime)

    def _absorb_scales(self, epoch: int, runtime: ClusterRuntime) -> None:
        for p in runtime.pipelines:
            for si, s in enumerate(p.stages):
                if abs(s.lat_scale - 1.0) > 1e-12:
                    self.feedback_scales[(epoch, p.pipeline_id, si)] = s.lat_scale

    def finalize(self, runtime: ClusterRuntime, retired=(),
                 current_epoch: int = 0) -> None:
        """Freeze end-of-run aggregates derived from the cluster runtime(s).

        `retired` maps epoch -> runtime for plan epochs replaced by hot-swaps
        but not yet garbage-collected; `current_epoch` labels `runtime`'s
        feedback scales.  Retired epochs' accumulated busy time — plus that
        of epochs already absorbed at GC time — still counts toward
        utilization (same physical chips, same horizon), so telemetry stays
        continuous across swaps whether or not the runtimes were GC'd along
        the way.
        """
        horizon = max(self.horizon_s, 1e-9)
        for epoch, rt in dict(retired).items():
            self.absorb_epoch(epoch, rt)
        # one accumulation, one division: epoch order then the live runtime,
        # so GC'd and non-GC'd accounting sum in the same order bit-for-bit
        total: dict[str, float] = {}
        for epoch in sorted(self.epoch_busy):
            for c, b in self.epoch_busy[epoch].items():
                total[c] = total.get(c, 0.0) + b
        for c, b in busy_by_class(runtime).items():
            total[c] = total.get(c, 0.0) + b
        if runtime.cluster is None:
            # synthetic runtimes (e.g. the equivalence suite's randomized
            # twins) carry no cluster inventory: no utilization denominator
            self.utilization = {}
        else:
            counts = runtime.cluster.counts
            self.utilization = {
                c: total.get(c, 0.0) / (counts[c] * horizon) if counts.get(c) else 0.0
                for c in runtime.cluster.classes
            }
        self._absorb_scales(current_epoch, runtime)

    def snapshot(self) -> dict:
        """JSON-able summary (consumed by BENCH_e2e.json and the example)."""
        walls = {
            f"e{epoch}p{pid}s{si}": {
                "n": len(v),
                "mean_ms": float(np.mean(v)) * 1e3,
                # a 1-sample percentile is just that sample; taking it
                # directly avoids interpolation noise on singleton lists
                "p99_ms": (float(v[0]) if len(v) == 1
                           else float(np.percentile(v, 99))) * 1e3,
            }
            for (epoch, pid, si), v in self.stage_wall_s.items() if v
        }
        return {
            "schema_version": SCHEMA_VERSION,
            "requests": len(self.outcomes),
            "served": self.served,
            "dropped": self.dropped,
            "attainment": self.attainment,
            "goodput_rps": self.goodput_rps,
            "horizon_s": self.horizon_s,
            "mean_batch_size": self.mean_batch_size,
            "dispatches": len(self.dispatches),
            "probes_per_dispatch": self.probes_per_dispatch,
            "scheduler": dict(self.scheduler),
            "queue_delay_p50_ms": self.queue_delay_pct(50) * 1e3,
            "queue_delay_p99_ms": self.queue_delay_pct(99) * 1e3,
            "drops": {
                "admission_reject": self.admission_rejects,
                "backpressure_reject": self.backpressure_rejects,
                "overflow_shed": self.overflow_sheds,
                "expired": self.expiry_drops,
                "scheduler": self.sched_drops,
                "exec_failure": self.exec_failures,
                "node_loss": self.node_loss_drops,
            },
            "faults": {
                "injected": self.faults_injected,
                "node_losses": self.node_losses,
                "retries": self.retries,
                "retry_exhausted": self.retry_exhausted,
                "resizes": self.resizes,
            },
            "requested_horizon_s": self.requested_horizon_s,
            "backpressure_events": [list(e) for e in self.backpressure_events],
            "inflight_hwm": self.inflight_hwm,
            "plan_swaps": self.plan_swaps,
            "epochs_gcd": self.epochs_gcd,
            "swap_transient_s": list(self.swap_transient_s),
            "replan": {
                "considered": len(self.replan_decisions),
                "accepted": sum(1 for d in self.replan_decisions if d["accepted"]),
                "rejected": sum(1 for d in self.replan_decisions if not d["accepted"]),
            },
            "utilization_by_class": dict(self.utilization),
            "stage_wall": walls,
            "feedback_scales": {f"e{e}p{p}s{s}": v
                                for (e, p, s), v in self.feedback_scales.items()},
        }

    def summary(self) -> str:
        s = self.snapshot()
        util = ", ".join(f"{c}={u:.1%}" for c, u in s["utilization_by_class"].items())
        return (
            f"served {s['served']}/{s['requests']} "
            f"(attainment {s['attainment']:.1%}, goodput {s['goodput_rps']:.1f} rps) "
            f"in {s['dispatches']} batches (mean bs {s['mean_batch_size']:.2f}); "
            f"queue delay p50/p99 {s['queue_delay_p50_ms']:.2f}/"
            f"{s['queue_delay_p99_ms']:.2f} ms; drops {s['drops']}; "
            f"util {util or 'n/a'}; inflight hwm {s['inflight_hwm']}"
        )
