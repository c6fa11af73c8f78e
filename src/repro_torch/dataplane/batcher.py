"""Reservation-driven adaptive batching — Algorithm 1, shared with the sim.

This module deliberately contains **no scheduling logic**.  The pipeline /
path / batch-size decision (paper section 5.4, Algorithm 1) lives in
`core.scheduler.ReservationScheduler`, the exact object the discrete-event
simulator drives; the batcher's job is to own the admission-controlled
queues (queues.py) and hand them to that scheduler, so that simulated and
real execution provably follow one implementation (see the parity test in
tests/test_dataplane.py).

`scheduler_cls` lets callers inject an alternative Algorithm 1
implementation: `DataPlane(scheduler_cls=...)` threads through here, and the
decision-equivalence suite uses it to run the frozen pre-optimization
scheduler (`core._reference.ReferenceReservationScheduler`) through the
whole plane and prove bit-identical outcomes against the optimized default.
"""

from __future__ import annotations

from repro_torch.core.reservation import PipelineRuntime
from repro_torch.core.runtime import ClusterRuntime
from repro_torch.core.scheduler import (  # noqa: F401  (re-exported action types)
    Dispatch,
    Drop,
    ReservationScheduler,
    SchedulerStats,
    WaitUntil,
)
from repro_torch.core.types import Request

from .queues import AdmissionPolicy, QueueSet


def unloaded_latency_s(pipeline: PipelineRuntime) -> float:
    """Best-case end-to-end latency of a pipeline: batch 1 on idle pools, at
    each stage's current `lat_scale` (every table grows with the batch:
    the cost model's, and measured ones as `calibrate_runtime` keeps them).

    The expiry prune and the admission check hold it against deadlines, so
    it must not exceed any service time the scheduler plans:
    `AdaptiveBatcher.refresh_min_service` re-reads it whenever measured
    feedback moves a scale.  Transfers are excluded — admission should err
    on the admitting side, and co-located hops cost nothing anyway.
    """
    return sum(stage.latency(1) for stage in pipeline.stages)


def min_service_by_model(runtime: ClusterRuntime) -> dict[str, float]:
    """The fastest pipeline's `unloaded_latency_s` for each served model."""
    out: dict[str, float] = {}
    for p in runtime.pipelines:
        lat = unloaded_latency_s(p)
        cur = out.get(p.model_name)
        out[p.model_name] = lat if cur is None else min(cur, lat)
    return out


class AdaptiveBatcher:
    """Admission-controlled queues + the shared Algorithm 1 scheduler."""

    def __init__(self, runtime: ClusterRuntime,
                 policy: AdmissionPolicy | None = None,
                 scheduler_cls=ReservationScheduler) -> None:
        self.runtime = runtime
        min_service = min_service_by_model(runtime)
        capacity: dict[str, int] = {}
        for p in runtime.pipelines:
            # optimistic per-quantum clearing capacity: each pipeline serves
            # `unified_batch` requests per pool slot, with min-stage pool
            # width slots in parallel — the watermark shed bound's divisor
            width = max(1, min(len(s.vdevs) for s in p.stages))
            capacity[p.model_name] = (
                capacity.get(p.model_name, 0) + p.unified_batch * width)
        self.queues = QueueSet(min_service, policy, capacity_hint=capacity)
        # the simulator's scheduler, pointed at our queues
        self.sched = scheduler_cls(runtime, queues=self.queues.by_model)

    # ------------------------------------------------------------------ api
    def offer(self, req: Request, now: float
              ) -> tuple[str | None, list[Request]]:
        """Admission front door; returns (drop cause or None if admitted,
        overflow-shed requests)."""
        return self.queues.offer(req, now)

    def plan(self, model: str, now: float
             ) -> tuple[list[Request], list[Dispatch | Drop | WaitUntil]]:
        """One scheduling round: cheap expiry prune, then Algorithm 1.

        Returns (expired requests dropped by the prune, scheduler actions).
        """
        expired = self.queues.prune(model, now)
        return expired, self.sched.schedule(model, now)

    def refresh_min_service(self) -> None:
        """Re-derive every queue's best-case service time after feedback
        moved a stage's `lat_scale`, so the expiry prune and the admission
        check stay below what the scheduler's probes plan."""
        for model, lat in min_service_by_model(self.runtime).items():
            self.queues.queue(model).min_service_s = lat

    def pending(self, model: str) -> int:
        return self.queues.pending(model)

    def total_pending(self) -> int:
        """All-model queue depth (the observability gauge)."""
        return self.queues.total_pending()

    def take_all(self) -> list[Request]:
        """Drain every queue for a plan hot-swap; admission counters are not
        touched (the requests were already admitted once)."""
        return self.queues.take_all()

    @property
    def stats(self) -> SchedulerStats:
        return self.sched.stats
