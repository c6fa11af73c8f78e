"""Overlapped pool dispatch: real execution of scheduled batches.

PyTorch launches on a CUDA stream are asynchronous: calling a stage enqueues
its kernels on the current stream and returns as soon as the host has issued
them.  The dispatcher exploits this to keep several batches in flight across
pipeline stages: all stages of a batch (including boundary transfers) are
enqueued the moment Algorithm 1 dispatches it, and timing
`torch.cuda.Event`s are recorded on the stage's device before and after
each stage.  Nothing blocks until a measurement point (`poll_stage`, which
synchronizes on the stage's event) or the in-flight window fills.  On CUDA
a stage's duration is the device time between its two events, not the
host time between two polls: the host issues a stage more slowly than
the card runs it, so by the time it polls, later stages are often done
already, and host deltas would hand one stage the whole chain's time and
the next almost none.  On the CPU, eager execution is synchronous, a stage
is ready when its call returns, and durations are host deltas.

The measured wall durations flow back through `FeedbackController`, which
(a) converts wall time into the scheduler's virtual clock via a per-stage
calibration ratio and (b) re-synchronizes the latency model by nudging
`StageRuntime.lat_scale` toward the observed speed — the paper's section 5.4
feedback-correction mechanism closing the loop on real hardware.
"""

from __future__ import annotations

import itertools
import time
from dataclasses import dataclass

import torch

from repro_torch.core.runtime import ClusterRuntime
from repro_torch.core.scheduler import Dispatch
from repro_torch.serving.engine import StageExecutor


def _ready_event(x: torch.Tensor):
    """A timing event recorded on `x`'s device's current stream after the
    work queued so far (the work that makes `x`), or None for a CPU tensor
    (ready once computed)."""
    if not x.is_cuda:
        return None
    ev = torch.cuda.Event(enable_timing=True)
    ev.record(torch.cuda.current_stream(x.device))
    return ev


@dataclass
class _InFlight:
    job_id: int
    pipeline_id: int
    n_requests: int
    members: list[int]  # pool-member index per stage (telemetry only)
    outputs: list  # per-stage output tensors
    events: list  # per-stage ready event (None on the CPU)
    starts: list  # per-stage event recorded before it runs (None on the CPU)
    submit_wall: float
    ready_wall: list  # per-stage wall timestamp once observed ready
    epoch: int = 0  # plan epoch at submit time (telemetry bucketing)

    def stage_wall(self, k: int) -> float:
        """Seconds stage k took, once it is ready: device time between its
        two events on CUDA, host delta between ready times on the CPU."""
        if self.events[k] is not None and self.starts[k] is not None:
            return self.starts[k].elapsed_time(self.events[k]) / 1e3
        prev = self.submit_wall if k == 0 else self.ready_wall[k - 1]
        return max(self.ready_wall[k] - prev, 0.0)


@dataclass
class CompletedBatch:
    job_id: int
    pipeline_id: int
    n_requests: int
    members: list[int]
    stage_wall_s: list  # measured wall duration per stage
    submit_wall: float
    done_wall: float
    # plan epoch the batch was SUBMITTED under.  A dispatcher may serve
    # several epochs (swap_plan's factory can return the same instance), and
    # pipeline ids restart at 0 per epoch — telemetry keys stage walls by
    # (epoch, pipeline, stage), so the batch must carry its own epoch
    epoch: int = 0

    @property
    def total_wall_s(self) -> float:
        return self.done_wall - self.submit_wall


class PoolDispatcher:
    """Executes dispatched batches on StageExecutors with bounded overlap."""

    def __init__(self, executors_by_pipeline: dict[int, list[StageExecutor]],
                 vdev_map: dict[int, tuple[int, int]] | None = None,
                 max_inflight: int = 4) -> None:
        self.executors = executors_by_pipeline
        # vdev_id -> (stage_idx, member_idx); lets probe paths name members
        self.vdev_map = vdev_map or {}
        self.max_inflight = max(1, max_inflight)
        self._inflight: list[_InFlight] = []
        self._completed: list[CompletedBatch] = []
        self._done_by_id: dict[int, CompletedBatch] = {}
        self._job_ids = itertools.count()
        self.inflight_hwm = 0
        self.submitted = 0
        # stamped onto every submitted batch; the DataPlane keeps it in sync
        # with its plan epoch so a dispatcher reused across swap_plan calls
        # still buckets measurements under the epoch that submitted them
        self.current_epoch = 0
        # optional repro_torch.obs.Observer (set by DataPlane._install_runtime):
        # every retired batch's wall measurements flow to it as a
        # "batch.wall" journal event — the wall-clock side of the trace
        self.obs = None

    @classmethod
    def from_runtime(cls, runtime: ClusterRuntime,
                     executors_by_pipeline: dict[int, list[StageExecutor]],
                     max_inflight: int = 4) -> "PoolDispatcher":
        vdev_map = {}
        for p in runtime.pipelines:
            for si, stage in enumerate(p.stages):
                for mi, v in enumerate(stage.vdevs):
                    vdev_map[v.vdev_id] = (si, mi)
        return cls(executors_by_pipeline, vdev_map, max_inflight)

    # ----------------------------------------------------------- submission
    def submit(self, dispatch: Dispatch, tokens) -> int:
        """Enqueue every stage of a scheduled batch; non-blocking."""
        members = [self.vdev_map.get(v.vdev_id, (si, 0))[1]
                   for si, v in enumerate(dispatch.probe_result.path)]
        return self.submit_chain(dispatch.pipeline.pipeline_id, tokens, members)

    def submit_chain(self, pipeline_id: int, tokens, members=None) -> int:
        execs = self.executors[pipeline_id]
        members = members if members is not None else [0] * len(execs)
        t0 = time.perf_counter()
        carry = tokens
        outputs, events, starts = [], [], []
        for si, ex in enumerate(execs):
            if si > 0:
                carry = ex.transfer(carry)
            starts.append(_ready_event(carry))
            carry = ex(carry)  # async on CUDA: enqueues and returns
            outputs.append(carry)
            events.append(_ready_event(carry))
        job = _InFlight(
            job_id=next(self._job_ids),
            pipeline_id=pipeline_id,
            n_requests=int(tokens.shape[0]),
            members=list(members),
            outputs=outputs,
            events=events,
            starts=starts,
            submit_wall=t0,
            ready_wall=[None] * len(outputs),
            epoch=self.current_epoch,
        )
        self._inflight.append(job)
        self.submitted += 1
        self.inflight_hwm = max(self.inflight_hwm, len(self._inflight))
        while len(self._inflight) > self.max_inflight:
            self._retire(self._inflight[0])
        return job.job_id

    @property
    def inflight(self) -> int:
        return len(self._inflight)

    # ---------------------------------------------------------- measurement
    def poll_stage(self, job_id: int, stage_idx: int) -> float:
        """Block until stage `stage_idx` of `job_id` is ready; return its
        measured duration (`_InFlight.stage_wall`).

        Safe to call for a batch the in-flight window already retired — the
        recorded measurement is returned instead.
        """
        done = self._done_by_id.get(job_id)
        if done is not None:
            return done.stage_wall_s[stage_idx]
        job = self._find(job_id)
        self._measure_through(job, stage_idx)
        dur = job.stage_wall(stage_idx)
        if stage_idx == len(job.outputs) - 1:
            self._retire(job)
        return dur

    def drain(self, job_id: int) -> CompletedBatch:
        done = self._done_by_id.get(job_id)
        if done is not None:
            return done
        self._retire(self._find(job_id))
        return self._done_by_id[job_id]

    def drain_all(self) -> list[CompletedBatch]:
        """Block on every in-flight batch; returns ALL completed batches."""
        while self._inflight:
            self._retire(self._inflight[0])
        return self._completed

    def take_completed(self) -> list[CompletedBatch]:
        """Hand off (and forget) all completed batches.  Also the retention
        bound for the by-id lookup: once telemetry has harvested a batch, no
        poll_stage/drain for it can still be pending, so a dispatcher reused
        across serve() runs does not accumulate CompletedBatch records."""
        out, self._completed = self._completed, []
        self._done_by_id.clear()
        return out

    def shutdown(self) -> None:
        """Retire this dispatcher: block on anything still in flight and drop
        the executor/vdev references so stage programs and parameters can
        be reclaimed.  Callers harvest `take_completed()` FIRST — shutdown is
        the last call the data plane's retired-epoch GC makes on a
        dispatcher, after its final batch completed and its measurements
        were folded into telemetry."""
        self.drain_all()
        self._completed.clear()
        self._done_by_id.clear()
        self.executors = {}
        self.vdev_map = {}

    # ------------------------------------------------------------ internals
    def _find(self, job_id: int) -> _InFlight:
        for job in self._inflight:
            if job.job_id == job_id:
                return job
        raise KeyError(f"job {job_id} not in flight")

    def _measure_through(self, job: _InFlight, stage_idx: int) -> None:
        for k in range(stage_idx + 1):
            if job.ready_wall[k] is None:
                if job.events[k] is not None:
                    job.events[k].synchronize()
                job.ready_wall[k] = time.perf_counter()

    def _retire(self, job: _InFlight) -> None:
        self._measure_through(job, len(job.outputs) - 1)
        walls = [job.stage_wall(k) for k in range(len(job.outputs))]
        self._inflight.remove(job)
        done = CompletedBatch(
            job_id=job.job_id,
            pipeline_id=job.pipeline_id,
            n_requests=job.n_requests,
            members=job.members,
            stage_wall_s=walls,
            submit_wall=job.submit_wall,
            done_wall=job.ready_wall[-1],
            epoch=job.epoch,
        )
        self._completed.append(done)
        self._done_by_id[job.job_id] = done
        if self.obs is not None:
            self.obs.on_batch_wall(done)


class FeedbackController:
    """Feedback correction (paper section 5.4) for the real data plane.

    Wall clock and the scheduler's virtual clock run at unrelated rates (the
    latency model prices TPU pools; execution may be a CPU re-enactment), so
    the first observation of each (pipeline, stage) pins a calibration ratio
    `wall seconds per virtual second`.  Subsequent measured durations are
    mapped into virtual time through it; persistent drift from the planned
    latency is folded into `StageRuntime.lat_scale` with a multiplicative
    EWMA, so future probe() calls price the stage at its observed speed.
    """

    def __init__(self, runtime: ClusterRuntime, alpha: float = 0.4,
                 adapt_latency: bool = True,
                 scale_bounds: tuple[float, float] = (0.05, 20.0)) -> None:
        self.runtime = runtime
        self.alpha = alpha
        self.adapt_latency = adapt_latency
        self.scale_bounds = scale_bounds
        self._by_id = {p.pipeline_id: p for p in runtime.pipelines}
        self.calib: dict[tuple[int, int], float] = {}
        self.last_ratio: dict[tuple[int, int], float] = {}
        self.observations = 0

    def observe(self, pipeline_id: int, stage_idx: int,
                planned_s: float, measured_wall_s: float) -> float:
        """Fold one measured stage execution back in; returns the measured
        duration expressed in virtual seconds."""
        key = (pipeline_id, stage_idx)
        measured_wall_s = max(measured_wall_s, 1e-12)
        planned_s = max(planned_s, 1e-12)
        cal = self.calib.get(key)
        if cal is None:
            cal = self.calib[key] = measured_wall_s / planned_s
        virtual = measured_wall_s / cal
        ratio = virtual / planned_s
        self.last_ratio[key] = ratio
        self.observations += 1
        if self.adapt_latency:
            stage = self._by_id[pipeline_id].stages[stage_idx]
            lo, hi = self.scale_bounds
            stage.lat_scale = min(hi, max(lo, stage.lat_scale * ratio ** self.alpha))
        return virtual
