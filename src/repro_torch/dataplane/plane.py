"""The event-driven serving data plane.

`DataPlane.serve(trace)` replays a request trace through the PPipe stack:
admission-controlled queues (queues.py) -> the shared Algorithm 1 scheduler
(batcher.py) -> reservation-driven stage/transfer execution with overlapped
real dispatch on the device (dispatcher.py) -> telemetry (metrics.py).

Scheduling runs on a *virtual* clock in trace seconds, while the dispatcher
executes batches for real in wall time underneath.  The two clocks meet in
`FeedbackController`: measured wall durations are calibrated into virtual
seconds and, in ``feedback="measured"`` mode, replace the planned stage
durations and re-synchronize the reservation timelines via
`Timeline.correct`.  With planned feedback and no dispatcher the virtual
execution is decision-identical to the reference package's `DataPlane`.

This is the serve path of the reference's `dataplane/plane.py`.  Plan
hot-swap with epoch GC, fault injection (`fail_host`, `fail_chips`,
stragglers, retries), `serve_stream` with backpressure edges and the
observer hooks are not ported yet: this plane serves one plan epoch, and an
executor failure propagates to the caller.
"""

from __future__ import annotations

import heapq
import itertools
import time
from dataclasses import dataclass

import torch

from repro_torch.core import reservation
from repro_torch.core.plan import ClusterPlan
from repro_torch.core.reservation import PipelineRuntime
from repro_torch.core.runtime import ClusterRuntime
from repro_torch.core.scheduler import Dispatch, Drop, WaitUntil
from repro_torch.core.types import Request, RequestOutcome

from .batcher import AdaptiveBatcher
from .dispatcher import FeedbackController, PoolDispatcher
from .metrics import DispatchRecord, Telemetry
from .queues import AdmissionPolicy


@dataclass
class _Job:
    job_id: int
    pipeline_id: int
    requests: list[Request]
    probe: reservation.ProbeResult
    exec_id: int | None  # dispatcher job id (None when no real execution)
    pipeline: PipelineRuntime
    stage_idx: int = 0
    clock: float = 0.0  # virtual time the batch finished its previous hop


def _default_tokens(n: int, seq_len: int, device) -> torch.Tensor:
    """Batch-bucketed dummy tokens on `device`: pad the batch to the next
    power of two so the number of distinct stage shapes stays logarithmic
    in batch size."""
    bucket = 1
    while bucket < n:
        bucket *= 2
    return torch.ones((bucket, seq_len), dtype=torch.int64, device=device)


def _token_fn_for(executors_by_pipeline, token_fn):
    """`token_fn(n, seq_len)`, defaulting to tokens on the first stage's
    device."""
    if token_fn is not None:
        return token_fn
    first = next(iter(executors_by_pipeline.values()))[0]
    return lambda n, seq_len: _default_tokens(n, seq_len, first.device)


class DataPlane:
    """Asynchronous reservation-driven serving engine."""

    ARRIVAL, WAKE, STAGE_DONE, XFER_DONE = range(4)

    def __init__(
        self,
        runtime: ClusterRuntime,
        dispatcher: PoolDispatcher | None = None,
        policy: AdmissionPolicy | None = None,
        feedback: str = "planned",
        seq_len: int = 32,
        token_fn=None,
        feedback_alpha: float = 0.4,
        gc_interval_s: float = 1.0,
    ) -> None:
        if feedback not in ("planned", "measured"):
            raise ValueError(f"feedback must be planned|measured, got {feedback!r}")
        if feedback == "measured" and dispatcher is None:
            raise ValueError("measured feedback requires a dispatcher")
        self.feedback = feedback
        # amortized timeline-GC cadence in virtual seconds (decision-neutral,
        # see ClusterRuntime.maybe_gc); math.inf disables GC
        self.gc_interval_s = gc_interval_s
        self.seq_len = seq_len
        self.tel = Telemetry()
        self.events: list[tuple] = []
        self.seq = itertools.count()
        self.jobs: dict[int, _Job] = {}
        self.job_ids = itertools.count()
        self._wakes: dict[str, float] = {}
        self.rt = runtime
        self.batcher = AdaptiveBatcher(runtime, policy)
        self.dispatcher = dispatcher
        self.token_fn = (_token_fn_for(dispatcher.executors, token_fn)
                         if dispatcher is not None else token_fn)
        self.fb = (
            FeedbackController(runtime, alpha=feedback_alpha,
                               adapt_latency=feedback == "measured")
            if dispatcher is not None else None
        )
        self.vdev_virtual_free = {v.vdev_id: 0.0 for v in runtime.vdevs}
        self.nic_ul_free = {n.node_id: 0.0 for n in runtime.nodes}
        self.nic_dl_free = {n.node_id: 0.0 for n in runtime.nodes}

    # ------------------------------------------------------------------ events
    def push(self, t: float, kind: int, payload: object) -> None:
        # rank 0 for arrivals, 1 for derived events: at equal t an arrival
        # always processes before the work it could join
        rank = 0 if kind == self.ARRIVAL else 1
        heapq.heappush(self.events, (t, rank, next(self.seq), kind, payload))

    def serve(self, trace: list[Request]) -> Telemetry:
        """Replay a finite trace to completion."""
        for req in sorted(trace):
            self.push(req.arrival_s, self.ARRIVAL, req)
        horizon = 0.0
        while self.events:
            t, _, _, kind, payload = heapq.heappop(self.events)
            if kind == self.ARRIVAL:
                self._admit(payload, t)
                self._run_scheduler(payload.model_name, t)
            elif kind == self.WAKE:
                self._wakes.pop(payload, None)
                self._run_scheduler(payload, t)
            elif kind == self.STAGE_DONE:
                self._on_stage_done(t, payload)
            elif kind == self.XFER_DONE:
                self._on_xfer_done(t, payload)
            self.rt.maybe_gc(t, self.gc_interval_s)
            horizon = max(horizon, t)
        return self._finalize_serve(horizon)

    def _finalize_serve(self, horizon: float) -> Telemetry:
        """Horizon accounting, scheduler stats, wall-measurement harvest,
        telemetry finalize."""
        self.tel.horizon_s = max(horizon, 1e-9)
        st = self.batcher.stats
        self.tel.probes_per_dispatch = st.probe_calls / max(1, st.dispatches)
        self.tel.scheduler = {
            "probe_calls": st.probe_calls,
            "dispatches": st.dispatches,
            "probe_cache_hits": st.probe_cache_hits,
            "bisect_searches": st.bisect_searches,
        }
        if self.dispatcher is not None:
            self._harvest_dispatcher(self.dispatcher)
        self.tel.finalize(self.rt)
        return self.tel

    # --------------------------------------------------------------- arrivals
    def _admit(self, req: Request, now: float) -> None:
        """Offer to the queues, record reject/shed outcomes."""
        cause, shed = self.batcher.offer(req, now)
        if cause is not None:
            self._drop(req, now, cause)
        for r in shed:
            self._drop(r, now, "overflow_shed")

    # --------------------------------------------------------------- scheduler
    def _run_scheduler(self, model: str, now: float) -> None:
        expired, actions = self.batcher.plan(model, now)
        for r in expired:
            self._drop(r, now, "expired")
        for action in actions:
            if isinstance(action, Drop):
                self._drop(action.request, now, "scheduler")
            elif isinstance(action, WaitUntil):
                # coalesce wake-ups per model
                cur = self._wakes.get(model)
                if cur is None or action.time_s < cur - 1e-9:
                    self._wakes[model] = action.time_s
                    self.push(action.time_s, self.WAKE, model)
            elif isinstance(action, Dispatch):
                self._dispatch(now, action)

    def _dispatch(self, now: float, action: Dispatch) -> None:
        pr = action.probe_result
        exec_id = None
        if self.dispatcher is not None:
            tokens = self.token_fn(len(action.requests), self.seq_len)
            exec_id = self.dispatcher.submit(action, tokens)
        depth_after = self.batcher.pending(action.pipeline.model_name)
        self.tel.dispatches.append(DispatchRecord(
            t_s=now,
            pipeline_id=action.pipeline.pipeline_id,
            batch_size=len(action.requests),
            planned_finish_s=pr.finish_time,
            oldest_deadline_s=min(r.deadline_s for r in action.requests),
            queue_len_after=depth_after,
        ))
        self.tel.queue_delay_s.extend(now - r.arrival_s for r in action.requests)
        job = _Job(
            job_id=next(self.job_ids),
            pipeline_id=action.pipeline.pipeline_id,
            requests=action.requests,
            probe=pr,
            exec_id=exec_id,
            pipeline=action.pipeline,
            clock=now,
        )
        self.jobs[job.job_id] = job
        self._start_stage(now, job)

    # -------------------------------------------------------------- execution
    def _stage_dur(self, job: _Job, k: int) -> float:
        """Virtual duration of stage k: planned, or calibrated-measured when
        real execution feeds back (the data-plane analogue of sim noise)."""
        planned = job.probe.stage_durs[k]
        if self.feedback != "measured" or job.exec_id is None:
            return planned
        wall = self.dispatcher.poll_stage(job.exec_id, k)
        return self.fb.observe(job.pipeline_id, k, planned, wall)

    def _start_stage(self, now: float, job: _Job) -> None:
        k = job.stage_idx
        gpu = job.probe.path[k]
        planned_start = job.probe.stage_starts[k]
        planned_dur = job.probe.stage_durs[k]
        start = max(planned_start, job.clock, self.vdev_virtual_free[gpu.vdev_id])
        dur = self._stage_dur(job, k)
        self.vdev_virtual_free[gpu.vdev_id] = start + dur
        gpu.busy_s += dur
        gpu.timeline.correct(planned_start, planned_dur, start, dur)
        self.push(start + dur, self.STAGE_DONE, (job.job_id, start, dur))

    def _on_stage_done(self, t: float, payload: tuple) -> None:
        job = self.jobs[payload[0]]
        job.clock = t
        job.stage_idx += 1
        if job.stage_idx >= len(job.probe.path):
            self._complete(job, t)
            return
        k = job.stage_idx
        src = job.probe.path[k - 1]
        dst = job.probe.path[k]
        stage = job.pipeline.stages[k]
        nbytes = stage.in_bytes_per_req * len(job.requests)
        if src.node is dst.node or nbytes <= 0:
            self._start_stage(t, job)
            return
        bw = min(src.node.nic_bw, dst.node.nic_bw)
        dur = nbytes / bw
        planned_start = job.probe.xfer_starts[k - 1]
        planned_dur = job.probe.xfer_durs[k - 1]
        start = max(planned_start, t, self.nic_ul_free[src.node.node_id],
                    self.nic_dl_free[dst.node.node_id])
        src.node.uplink.correct(planned_start, planned_dur, start, dur)
        dst.node.downlink.correct(planned_start, planned_dur, start, dur)
        self.nic_ul_free[src.node.node_id] = start + dur
        self.nic_dl_free[dst.node.node_id] = start + dur
        self.push(start + dur, self.XFER_DONE, job.job_id)

    def _on_xfer_done(self, t: float, job_id: int) -> None:
        job = self.jobs[job_id]
        job.clock = t
        self._start_stage(t, job)

    def _complete(self, job: _Job, t: float) -> None:
        for req in job.requests:
            self.tel.outcomes.append(RequestOutcome(
                req_id=req.req_id,
                arrival_s=req.arrival_s,
                deadline_s=req.deadline_s,
                completion_s=t,
                pipeline_id=job.pipeline_id,
            ))
        del self.jobs[job.job_id]

    # per-request drop counters
    _DROP_COUNTERS = {
        "admission_reject": "admission_rejects",
        "backpressure_reject": "backpressure_rejects",
        "overflow_shed": "overflow_sheds",
        "expired": "expiry_drops",
        "scheduler": "sched_drops",
    }

    def _drop(self, req: Request, now: float, cause: str) -> None:
        attr = self._DROP_COUNTERS.get(cause)
        if attr is not None:
            setattr(self.tel, attr, getattr(self.tel, attr) + 1)
        self.tel.outcomes.append(RequestOutcome(
            req_id=req.req_id,
            arrival_s=req.arrival_s,
            deadline_s=req.deadline_s,
            completion_s=None,
        ))

    # -------------------------------------------------------------- wall side
    def _harvest_dispatcher(self, disp: PoolDispatcher) -> None:
        disp.drain_all()
        for c in disp.take_completed():
            self.tel.batch_wall_s.append(c.total_wall_s)
            for si, w in enumerate(c.stage_wall_s):
                # keyed (epoch, pipeline, stage) as in the reference; this
                # plane serves a single plan epoch, 0
                self.tel.stage_wall_s.setdefault(
                    (0, c.pipeline_id, si), []).append(w)
        self.tel.inflight_hwm = max(self.tel.inflight_hwm, disp.inflight_hwm)


def serve_trace(
    runtime: ClusterRuntime,
    trace: list[Request],
    dispatcher: PoolDispatcher | None = None,
    policy: AdmissionPolicy | None = None,
    feedback: str = "planned",
    seq_len: int = 32,
    token_fn=None,
) -> Telemetry:
    """One-shot helper: build a DataPlane and serve `trace` through it."""
    dp = DataPlane(runtime, dispatcher=dispatcher, policy=policy,
                   feedback=feedback, seq_len=seq_len, token_fn=token_fn)
    return dp.serve(trace)


# ----------------------------------------------------------------------------
# Builders: PipelinePlan -> real executors (the MILP -> execution hand-off)
# ----------------------------------------------------------------------------


def build_executors(cfg, plan: ClusterPlan, layer_block_map,
                    generator: torch.Generator, quantize_boundary: bool = True):
    """Materialize every pipeline of a ClusterPlan as StageExecutors.

    Partitions with identical block ranges share one executor; parameters
    are initialized once, on the generator's device, and shared — on a
    single host all pool members are co-resident.
    Returns {pipeline_id: [StageExecutor per stage]}.
    """
    from repro_torch.serving.engine import StageExecutor, split_stages

    ranges = sorted({(s.block_start, s.block_end)
                     for pp in plan.pipelines for s in pp.stages})
    model, fns = split_stages(cfg, list(ranges), layer_block_map)
    params = model.init(generator)
    ex_by_range = {
        r: StageExecutor(stage_fn=fn, params=params,
                         quantize_boundary=quantize_boundary)
        for r, fn in zip(ranges, fns)
    }
    return {
        pid: [ex_by_range[(s.block_start, s.block_end)] for s in pp.stages]
        for pid, pp in enumerate(plan.pipelines)
    }


def _synchronize(x: torch.Tensor) -> None:
    if x.is_cuda:
        torch.cuda.synchronize(x.device)


def calibrate_runtime(runtime: ClusterRuntime, executors_by_pipeline,
                      seq_len: int, batch_sizes=None, reps: int = 2,
                      token_fn=None) -> dict:
    """Offline profiling pass (the paper's section 5.1 profiler, for real):
    measure each stage at each batch size and overwrite the analytic
    latency tables with measured wall seconds, so the scheduler's virtual
    clock *is* the wall clock and SLOs/deadlines become physically meaningful.
    Each stage is timed between two device synchronisations.

    Returns {(pipeline_id, stage_idx, batch): seconds} for reporting.
    """
    token_fn = _token_fn_for(executors_by_pipeline, token_fn)
    measured: dict = {}
    for p in runtime.pipelines:
        execs = executors_by_pipeline[p.pipeline_id]
        bss = batch_sizes or sorted({1, 2, 4, 8, p.unified_batch})
        bss = [b for b in bss if b <= p.unified_batch] or [p.unified_batch]
        per_stage: list[dict[int, float]] = [dict() for _ in execs]
        for bs in bss:
            tokens = token_fn(bs, seq_len)
            for _ in range(reps):
                carry = tokens
                for si, ex in enumerate(execs):
                    if si > 0:
                        carry = ex.transfer(carry)
                    _synchronize(carry)
                    t0 = time.perf_counter()
                    carry = ex(carry)
                    _synchronize(carry)
                    dt = time.perf_counter() - t0
                    cur = per_stage[si].get(bs)
                    per_stage[si][bs] = dt if cur is None else min(cur, dt)
        for si, stage in enumerate(p.stages):
            stage.latency_by_batch = dict(per_stage[si])
            stage.lat_scale = 1.0
            for bs, dt in per_stage[si].items():
                measured[(p.pipeline_id, si, bs)] = dt
        # measured tables may be non-monotone (profiling noise): re-decide
        # whether the batch-size bisection stays decision-safe
        reservation.validate_bisection(p)
    return measured
