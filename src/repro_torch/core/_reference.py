"""Frozen pre-optimization scheduler hot path (the PR-4 reference).

This module is a verbatim copy of `Timeline`, `earliest_slot_multi`,
`probe()` and `ReservationScheduler.schedule` as they stood BEFORE the
hot-path overhaul (pruned probes, monotone batch-size bisection, O(1)
tail-append timelines).  It exists for two consumers only:

* the decision-equivalence suite (`tests/test_sched_equivalence.py`), which
  proves the optimized implementations produce bit-identical dispatch /
  drop / wait streams and final timeline state on randomized runtimes; and
* `benchmarks/bench_sched.py`, which measures old-vs-new scheduler
  throughput (`BENCH_sched.json`) against the genuine pre-PR stack
  (`use_reference_timelines` swaps in `ReferenceTimeline` so the baseline
  does not silently benefit from the new Timeline fast paths).

Do NOT optimize, refactor or "fix" anything here — any divergence from the
historical behaviour silently weakens the equivalence proof.  The only
permitted edits are renames forced by imports.
"""

from __future__ import annotations

import bisect
from collections import deque

from .reservation import (
    PipelineRuntime,
    ProbeResult,
    Reservation,
    reserve,
)
from .scheduler import Dispatch, Drop, SchedulerStats, WaitUntil


class ReferenceTimeline:
    """Pre-PR `Timeline`: bisect everywhere, no tail fast paths."""

    __slots__ = ("starts", "ends")

    def __init__(self) -> None:
        self.starts: list[float] = []
        self.ends: list[float] = []

    @property
    def last_end(self) -> float:
        return self.ends[-1] if self.ends else 0.0

    def earliest_slot(self, t: float, dur: float) -> float:
        if dur <= 0:
            return t
        i = bisect.bisect_right(self.ends, t)  # first interval ending after t
        cur = t
        while i < len(self.starts):
            if cur + dur <= self.starts[i] + 1e-12:
                return cur
            cur = max(cur, self.ends[i])
            i += 1
        return cur

    def reserve(self, start: float, dur: float) -> None:
        if dur <= 0:
            return
        end = start + dur
        i = bisect.bisect_left(self.starts, start)
        if i > 0 and self.ends[i - 1] >= start - 1e-12:
            i -= 1
            start = min(start, self.starts[i])
            end = max(end, self.ends[i])
            del self.starts[i], self.ends[i]
        while i < len(self.starts) and self.starts[i] <= end + 1e-12:
            end = max(end, self.ends[i])
            del self.starts[i], self.ends[i]
        self.starts.insert(i, start)
        self.ends.insert(i, end)

    def correct(self, planned_start: float, planned_dur: float,
                actual_start: float, actual_dur: float) -> None:
        self.release(planned_start, planned_dur)
        self.reserve(actual_start, actual_dur)

    def release(self, start: float, dur: float) -> None:
        end = start + dur
        i = 0
        while i < len(self.starts):
            s, e = self.starts[i], self.ends[i]
            if e <= start + 1e-12 or s >= end - 1e-12:
                i += 1
                continue
            del self.starts[i], self.ends[i]
            if s < start:
                self.starts.insert(i, s)
                self.ends.insert(i, start)
                i += 1
            if e > end:
                self.starts.insert(i, end)
                self.ends.insert(i, e)
                i += 1

    def busy_between(self, t0: float, t1: float) -> float:
        total = 0.0
        for s, e in zip(self.starts, self.ends):
            total += max(0.0, min(e, t1) - max(s, t0))
        return total

    def gc(self, now: float) -> None:
        i = bisect.bisect_right(self.ends, now)
        if i > 0:
            del self.starts[:i], self.ends[:i]


def reference_earliest_slot_multi(timelines, t: float, dur: float) -> float:
    """Pre-PR `earliest_slot_multi`: capped fixpoint iteration."""
    cur = t
    for _ in range(1000):
        nxt = cur
        for tl in timelines:
            nxt = max(nxt, tl.earliest_slot(nxt, dur))
        if nxt == cur:
            return cur
        cur = nxt
    return cur  # pragma: no cover - pathological fragmentation


def reference_probe(pipeline: PipelineRuntime, bs: int, now: float) -> ProbeResult:
    """Pre-PR `probe()`: full pool scan, per-member reservation lists."""
    t_g = now
    path = []
    resv: list[Reservation] = []
    wait = 0.0
    stage_starts: list[float] = []
    stage_durs: list[float] = []
    xfer_starts: list[float] = []
    xfer_durs: list[float] = []
    last = None

    for si, stage in enumerate(pipeline.stages):
        l_i = stage.latency(bs)
        best = None  # (finish, gpu, local_resv, wait_delta, xs, xd, ss)
        for gpu in stage.vdevs:
            t = t_g
            local: list[Reservation] = []
            w = 0.0
            xs = xd = 0.0
            if last is not None and stage.in_bytes_per_req > 0:
                bw = min(last.node.nic_bw, gpu.node.nic_bw)
                l_n = stage.in_bytes_per_req * bs / bw
                if last.node is gpu.node:
                    l_n = 0.0  # co-located: feature map stays on host
                if l_n > 0:
                    s = reference_earliest_slot_multi(
                        [last.node.uplink, gpu.node.downlink], t, l_n
                    )
                    w += s - t
                    local.append(Reservation(last.node.uplink, s, l_n, "ul"))
                    local.append(Reservation(gpu.node.downlink, s, l_n, "dl"))
                    xs, xd = s, l_n
                    t = s + l_n
            s = gpu.timeline.earliest_slot(t, l_i)
            w += s - t
            local.append(Reservation(gpu.timeline, s, l_i, "gpu", holder=gpu))
            finish = s + l_i
            if best is None or finish < best[0]:
                best = (finish, gpu, local, w, xs, xd, s)
        finish, gpu, local, w, xs, xd, ss = best
        path.append(gpu)
        resv.extend(local)
        wait += w
        stage_starts.append(ss)
        stage_durs.append(stage.latency(bs))
        if si > 0:
            xfer_starts.append(xs)
            xfer_durs.append(xd)
        t_g = finish
        last = gpu

    return ProbeResult(
        path=path,
        reservations=resv,
        finish_time=t_g,
        wait_time=wait,
        stage_starts=stage_starts,
        stage_durs=stage_durs,
        xfer_starts=xfer_starts,
        xfer_durs=xfer_durs,
    )


class ReferenceReservationScheduler:
    """Pre-PR Algorithm 1: re-probes everything, linear batch-size scan."""

    def __init__(self, runtime, queues=None) -> None:
        self.runtime = runtime
        self.queues: dict[str, deque] = queues if queues is not None else {}
        self.stats = SchedulerStats()
        for p in runtime.pipelines:
            self.queues.setdefault(p.model_name, deque())

    def enqueue(self, req) -> None:
        self.queues.setdefault(req.model_name, deque()).append(req)

    def pending(self, model: str) -> int:
        return len(self.queues.get(model, ()))

    def schedule(self, model: str, now: float):
        out = []
        q = self.queues.get(model)
        pipelines = self.runtime.pipelines_of(model)
        if not q or not pipelines:
            return out
        while q:
            # Step 1: pick the pipeline with the lowest waiting time at its
            # unified batch size.
            best_p, best_wait = None, float("inf")
            for p in pipelines:
                r = reference_probe(p, p.unified_batch, now)
                self.stats.probe_calls += 1
                if r.wait_time < best_wait:
                    best_wait, best_p = r.wait_time, p
            p = best_p
            # Step 2: largest batch size meeting the oldest deadline.
            chosen_bs, chosen_r = 0, None
            for bs in range(p.unified_batch, 0, -1):
                r = reference_probe(p, bs, now)
                self.stats.probe_calls += 1
                if r.finish_time <= q[0].deadline_s + 1e-12:
                    chosen_bs, chosen_r = bs, r
                    break
            if chosen_bs == 0:
                self.stats.drops += 1
                out.append(Drop(q.popleft()))
                continue  # start over with the next oldest request
            if len(q) < chosen_bs:
                slack = q[0].deadline_s - chosen_r.finish_time
                wake = now + max(0.0, slack)
                if slack > 1e-6:
                    out.append(WaitUntil(wake))
                    break
                chosen_bs = len(q)  # last moment: dispatch what we have
                chosen_r = reference_probe(p, chosen_bs, now)
                self.stats.probe_calls += 1
                if chosen_r.finish_time > q[0].deadline_s + 1e-12:
                    self.stats.drops += 1
                    out.append(Drop(q.popleft()))
                    continue
            reserve(chosen_r)
            batch = [q.popleft() for _ in range(chosen_bs)]
            self.stats.dispatches += 1
            out.append(Dispatch(pipeline=p, requests=batch, probe_result=chosen_r))
        return out


def use_reference_timelines(runtime) -> None:
    """Replace every (empty) Timeline on `runtime` with a ReferenceTimeline,
    so a benchmark baseline runs the genuine pre-PR stack instead of quietly
    inheriting the optimized Timeline fast paths.  Call right after
    `build_runtime`, before any reservation exists."""
    for v in runtime.vdevs:
        assert not v.timeline.starts, "swap timelines before reserving"
        v.timeline = ReferenceTimeline()
    for n in runtime.nodes:
        n.uplink = ReferenceTimeline()
        n.downlink = ReferenceTimeline()
