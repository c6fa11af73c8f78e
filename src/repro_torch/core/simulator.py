"""Discrete-event simulator for the PPipe data plane (paper section 6).

Mirrors the paper's Java simulator: a global event queue ordered by timestamp
with handlers for request arrivals, scheduler wake-ups, stage executions and
feature-map transfers.  Actual stage durations deviate from planned ones by a
configurable lognormal noise factor; the feedback-correction mechanism
(section 5.4) reports actual usage back and re-syncs the reservation tables.

The same engine runs the reservation scheduler and the reactive baseline
(which resolves transfers FIFO on NICs, exposing contention D3).
"""

from __future__ import annotations

import heapq
import itertools
from dataclasses import dataclass, field

import numpy as np

from .reservation import ProbeResult, VDevRes
from .runtime import ClusterRuntime, utilization_by_class
from .scheduler import Dispatch, Drop, ReactiveScheduler, ReservationScheduler, WaitUntil
from .types import Request, RequestOutcome, attainment


@dataclass
class BatchJob:
    job_id: int
    pipeline_id: int
    requests: list[Request]
    probe: ProbeResult
    stage_idx: int = 0
    clock: float = 0.0  # actual time the batch finished its previous hop


@dataclass
class SimResult:
    outcomes: list[RequestOutcome]
    horizon_s: float
    utilization: dict[str, float]
    probes_per_dispatch: float
    xfer_actual: list[float] = field(default_factory=list)

    @property
    def attainment(self) -> float:
        return attainment(self.outcomes)


class Simulator:
    ARRIVAL, WAKE, STAGE_DONE, XFER_DONE = range(4)

    def __init__(
        self,
        runtime: ClusterRuntime,
        trace: list[Request],
        noise_sigma: float = 0.02,
        seed: int = 0,
        reactive: bool = False,
        gc_interval_s: float = 1.0,
    ) -> None:
        self.rt = runtime
        self.trace = sorted(trace)
        self.rng = np.random.default_rng(seed)
        self.noise_sigma = noise_sigma
        # amortized timeline-GC cadence (decision-neutral, see
        # ClusterRuntime.maybe_gc); math.inf disables GC entirely
        self.gc_interval_s = gc_interval_s
        self.sched = (
            ReactiveScheduler(runtime) if reactive else ReservationScheduler(runtime)
        )
        self.reactive = reactive
        self.events: list[tuple[float, int, int, object]] = []
        self.seq = itertools.count()
        self.outcomes: list[RequestOutcome] = []
        self.jobs: dict[int, BatchJob] = {}
        self.job_ids = itertools.count()
        self.vdev_actual_free: dict[int, float] = {
            v.vdev_id: 0.0 for v in runtime.vdevs
        }
        self.nic_ul_free: dict[int, float] = {n.node_id: 0.0 for n in runtime.nodes}
        self.nic_dl_free: dict[int, float] = {n.node_id: 0.0 for n in runtime.nodes}
        self.xfer_actual: list[float] = []
        self._wakes: dict[str, float] = {}

    # ------------------------------------------------------------------ events
    def push(self, t: float, kind: int, payload: object) -> None:
        heapq.heappush(self.events, (t, next(self.seq), kind, payload))

    def run(self) -> SimResult:
        for req in self.trace:
            self.push(req.arrival_s, self.ARRIVAL, req)
        horizon = self.trace[-1].arrival_s if self.trace else 0.0
        while self.events:
            t, _, kind, payload = heapq.heappop(self.events)
            if kind == self.ARRIVAL:
                req: Request = payload
                self.sched.enqueue(req)
                self._run_scheduler(req.model_name, t)
            elif kind == self.WAKE:
                self._wakes.pop(payload, None)
                self._run_scheduler(payload, t)
            elif kind == self.STAGE_DONE:
                self._on_stage_done(t, payload)
            elif kind == self.XFER_DONE:
                self._on_xfer_done(t, payload)
            self.rt.maybe_gc(t, self.gc_interval_s)
            horizon = max(horizon, t)
        return SimResult(
            outcomes=self.outcomes,
            horizon_s=max(horizon, 1e-9),
            utilization=utilization_by_class(self.rt, max(horizon, 1e-9)),
            probes_per_dispatch=self.sched.stats.probes_per_dispatch,
            xfer_actual=self.xfer_actual,
        )

    # --------------------------------------------------------------- scheduler
    def _run_scheduler(self, model: str, now: float) -> None:
        for action in self.sched.schedule(model, now):
            if isinstance(action, Drop):
                self.outcomes.append(
                    RequestOutcome(
                        req_id=action.request.req_id,
                        arrival_s=action.request.arrival_s,
                        deadline_s=action.request.deadline_s,
                        completion_s=None,
                    )
                )
            elif isinstance(action, WaitUntil):
                # coalesce wake-ups per model
                cur = self._wakes.get(model)
                if cur is None or action.time_s < cur - 1e-9:
                    self._wakes[model] = action.time_s
                    self.push(action.time_s, self.WAKE, model)
            elif isinstance(action, Dispatch):
                job = BatchJob(
                    job_id=next(self.job_ids),
                    pipeline_id=action.pipeline.pipeline_id,
                    requests=action.requests,
                    probe=action.probe_result,
                    clock=now,
                )
                self.jobs[job.job_id] = job
                self._start_stage(now, job)

    # -------------------------------------------------------------- execution
    def _noise(self) -> float:
        if self.noise_sigma <= 0:
            return 1.0
        return float(
            np.exp(self.rng.normal(0.0, self.noise_sigma))
        )

    def _start_stage(self, now: float, job: BatchJob) -> None:
        k = job.stage_idx
        gpu: VDevRes = job.probe.path[k]
        planned_start = job.probe.stage_starts[k]
        planned_dur = job.probe.stage_durs[k]
        start = max(planned_start, job.clock, self.vdev_actual_free[gpu.vdev_id])
        dur = planned_dur * self._noise()
        self.vdev_actual_free[gpu.vdev_id] = start + dur
        gpu.busy_s += dur
        if not self.reactive:
            gpu.timeline.correct(planned_start, planned_dur, start, dur)
        self.push(start + dur, self.STAGE_DONE, (job.job_id, start, dur))

    def _on_stage_done(self, t: float, payload: tuple) -> None:
        job_id, _, _ = payload
        job = self.jobs[job_id]
        job.clock = t
        job.stage_idx += 1
        if job.stage_idx >= len(job.probe.path):
            self._complete(job, t)
            return
        k = job.stage_idx
        src = job.probe.path[k - 1]
        dst = job.probe.path[k]
        stage = None
        pipeline = self.rt.pipelines[job.pipeline_id]
        stage = pipeline.stages[k]
        nbytes = stage.in_bytes_per_req * len(job.requests)
        if src.node is dst.node or nbytes <= 0:
            self._start_stage(t, job)
            return
        bw = min(src.node.nic_bw, dst.node.nic_bw)
        dur = nbytes / bw
        if self.reactive:
            # uncoordinated FIFO on both NICs: wait for both to free up
            start = max(
                t,
                self.nic_ul_free[src.node.node_id],
                self.nic_dl_free[dst.node.node_id],
            )
        else:
            planned_start = job.probe.xfer_starts[k - 1]
            planned_dur = job.probe.xfer_durs[k - 1]
            start = max(
                planned_start,
                t,
                self.nic_ul_free[src.node.node_id],
                self.nic_dl_free[dst.node.node_id],
            )
            src.node.uplink.correct(planned_start, planned_dur, start, dur)
            dst.node.downlink.correct(planned_start, planned_dur, start, dur)
        self.nic_ul_free[src.node.node_id] = start + dur
        self.nic_dl_free[dst.node.node_id] = start + dur
        self.xfer_actual.append(start + dur - t)
        self.push(start + dur, self.XFER_DONE, job_id)

    def _on_xfer_done(self, t: float, job_id: int) -> None:
        job = self.jobs[job_id]
        job.clock = t
        self._start_stage(t, job)

    def _complete(self, job: BatchJob, t: float) -> None:
        for req in job.requests:
            self.outcomes.append(
                RequestOutcome(
                    req_id=req.req_id,
                    arrival_s=req.arrival_s,
                    deadline_s=req.deadline_s,
                    completion_s=t,
                    pipeline_id=job.pipeline_id,
                )
            )
        del self.jobs[job.job_id]


def run_simulation(
    runtime: ClusterRuntime,
    trace: list[Request],
    noise_sigma: float = 0.02,
    seed: int = 0,
    reactive: bool = False,
    gc_interval_s: float = 1.0,
) -> SimResult:
    return Simulator(
        runtime, trace, noise_sigma=noise_sigma, seed=seed, reactive=reactive,
        gc_interval_s=gc_interval_s,
    ).run()
