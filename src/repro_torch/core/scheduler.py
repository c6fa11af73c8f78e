"""Adaptive batching schedulers (paper section 5.4, Algorithm 1) and the
reactive baseline used in the Fig. 10 ablation.

The reservation scheduler makes three decisions per batch: which pooled
pipeline (lowest probe() waiting time at the pipeline's unified batch size),
which path within it, and the largest batch size whose probed completion time
meets the oldest request's deadline.  It then drops / waits / dispatches.

Hot-path structure (DESIGN.md section 8): probe() is pure given the
reservation timelines, and within one `schedule()` call the timelines only
move when a dispatch commits via `reserve()`.  So probes are memoized per
(pipeline, batch size) and the memo is invalidated exactly at `reserve()`:
Step 2 reuses Step 1's unified-batch probe instead of re-probing, drop
storms stop re-probing every pipeline per popped request, and the
last-moment shrink re-uses any batch size the search already priced.  The
batch-size search itself bisects in O(log B) when `validate_bisection`
proved finish_time monotone in bs for the pipeline ("exact" mode), bisects
the monotone envelope bounds and exact-probes only the ambiguous band when
pools span hosts ("envelope" mode, DESIGN.md section 11), and falls back to
the reference linear scan otherwise — every path is decision-identical to
the frozen pre-optimization copy in `core/_reference.py`, enforced by
tests/test_sched_equivalence.py.
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass

from .reservation import (
    INF,
    PipelineRuntime,
    ProbeResult,
    probe,
    probe_lower_bound,
    probe_upper_envelope,
    reserve,
)
from .runtime import ClusterRuntime
from .types import Request


@dataclass
class Dispatch:
    pipeline: PipelineRuntime
    requests: list[Request]
    probe_result: ProbeResult


@dataclass
class Drop:
    request: Request


@dataclass
class WaitUntil:
    time_s: float


@dataclass
class SchedulerStats:
    probe_calls: int = 0
    dispatches: int = 0
    drops: int = 0
    # memo hits: decisions that the pre-PR scheduler paid a probe() for and
    # the optimized one served from the per-round cache
    probe_cache_hits: int = 0
    # Step-2 searches resolved by bisection instead of the linear scan
    bisect_searches: int = 0
    # Step-2 searches resolved by the envelope-bounded bisection (pools span
    # hosts: bisect monotone bounds, exact-probe only the ambiguous band)
    envelope_searches: int = 0
    # bound evaluations (probe_upper_envelope + probe_lower_bound calls)
    # paid by envelope searches — NOT exact probes, kept out of probe_calls
    # so probe-count parity with the reference stays meaningful
    envelope_bound_evals: int = 0

    @property
    def probes_per_dispatch(self) -> float:
        return self.probe_calls / max(1, self.dispatches)


class ReservationScheduler:
    """PPipe's data-plane scheduler (Algorithm 1).

    `queues` may be any mapping of model name to a deque-compatible object
    (append / popleft / len / [0]).  The discrete-event simulator uses plain
    FIFO deques; the real data plane (repro_torch.dataplane) injects its
    admission-controlled, deadline-ordered queues — either way THIS class is
    the single Algorithm 1 implementation driving both.
    """

    def __init__(self, runtime: ClusterRuntime, queues=None) -> None:
        self.runtime = runtime
        self.queues: dict[str, deque[Request]] = (
            queues if queues is not None else {}
        )
        self.stats = SchedulerStats()
        # model -> pipelines, resolved once: runtime.pipelines is immutable
        # after build (a plan swap installs a whole new runtime + scheduler)
        self._by_model: dict[str, list[PipelineRuntime]] = {}
        for p in runtime.pipelines:
            self.queues.setdefault(p.model_name, deque())

    def enqueue(self, req: Request) -> None:
        self.queues.setdefault(req.model_name, deque()).append(req)

    def pending(self, model: str) -> int:
        return len(self.queues.get(model, ()))

    def _pipelines_of(self, model: str) -> list[PipelineRuntime]:
        ps = self._by_model.get(model)
        if ps is None:
            ps = self._by_model[model] = self.runtime.pipelines_of(model)
        return ps

    def _probe_cached(self, cache: dict, p: PipelineRuntime, bs: int,
                      now: float) -> ProbeResult:
        key = (p.pipeline_id, bs)
        r = cache.get(key)
        if r is None:
            r = probe(p, bs, now)
            self.stats.probe_calls += 1
            cache[key] = r
        else:
            self.stats.probe_cache_hits += 1
        return r

    def _envelope_cached(self, cache: dict, p: PipelineRuntime, bs: int,
                         now: float) -> float:
        # bound values share the probe memo dict under a tagged key; same
        # invalidation discipline (cleared at reserve()).
        key = ("env", p.pipeline_id, bs)
        v = cache.get(key)
        if v is None:
            v = cache[key] = probe_upper_envelope(p, bs, now)
            self.stats.envelope_bound_evals += 1
        return v

    def schedule(self, model: str, now: float) -> list[Dispatch | Drop | WaitUntil]:
        """Run Algorithm 1 until the queue cannot make progress at `now`."""
        out: list[Dispatch | Drop | WaitUntil] = []
        q = self.queues.get(model)
        pipelines = self._pipelines_of(model)
        if not q or not pipelines:
            return out
        stats = self.stats
        # (pipeline_id, bs) -> ProbeResult.  probe() is pure given the
        # timelines and `now` is fixed for this call, so entries stay exact
        # across loop iterations (drops don't move timelines) and are
        # invalidated wholesale at each reserve().
        cache: dict[tuple[int, int], ProbeResult] = {}
        while q:
            # Step 1: pick the pipeline with the lowest waiting time at its
            # unified batch size.
            best_p, best_r, best_wait = None, None, INF
            for p in pipelines:
                r = self._probe_cached(cache, p, p.unified_batch, now)
                if r.wait_time < best_wait:
                    best_wait, best_p, best_r = r.wait_time, p, r
            p = best_p
            # Step 2: largest batch size meeting the oldest deadline.  The
            # unified-batch probe IS the Step-1 result — reuse it.
            deadline = q[0].deadline_s + 1e-12
            chosen_bs, chosen_r = 0, None
            if best_r.finish_time <= deadline:
                chosen_bs, chosen_r = p.unified_batch, best_r
            elif p.unified_batch > 1:
                if p.bisection_ok:
                    # finish_time monotone in bs (validated at build time)
                    # => feasibility downward-closed => largest feasible
                    # batch found in O(log B) probes.
                    stats.bisect_searches += 1
                    lo, hi = 0, p.unified_batch - 1
                    while lo < hi:
                        mid = (lo + hi + 1) // 2
                        r = self._probe_cached(cache, p, mid, now)
                        if r.finish_time <= deadline:
                            lo = mid
                        else:
                            hi = mid - 1
                    if lo > 0:
                        # lo was only ever set by a feasible probe: cached
                        chosen_bs = lo
                        chosen_r = cache[(p.pipeline_id, lo)]
                elif p.bisection_mode == "envelope":
                    # Pools span hosts: finish(bs) is not provably monotone,
                    # but it is sandwiched between two monotone bounds.
                    # Bisect the upper envelope for a feasibility FLOOR a
                    # (every bs <= a with env(bs) <= deadline is provably
                    # feasible), bisect the lower bound for a CEILING b
                    # (every bs > b is provably infeasible), then exact-probe
                    # the ambiguous band (a, b] largest-first — the first
                    # feasible probe is exactly the linear scan's answer,
                    # else the answer is a.  See DESIGN.md section 11.
                    stats.envelope_searches += 1
                    lo, hi = 0, p.unified_batch - 1
                    while lo < hi:
                        mid = (lo + hi + 1) // 2
                        if self._envelope_cached(cache, p, mid, now) <= deadline:
                            lo = mid
                        else:
                            hi = mid - 1
                    floor_bs = lo
                    lo, hi = floor_bs, p.unified_batch - 1
                    while lo < hi:
                        mid = (lo + hi + 1) // 2
                        stats.envelope_bound_evals += 1
                        if probe_lower_bound(p, mid, now) <= deadline:
                            lo = mid
                        else:
                            hi = mid - 1
                    ceil_bs = lo
                    for bs in range(ceil_bs, floor_bs, -1):
                        r = self._probe_cached(cache, p, bs, now)
                        if r.finish_time <= deadline:
                            chosen_bs, chosen_r = bs, r
                            break
                    if chosen_bs == 0 and floor_bs > 0:
                        # provably feasible by env(floor_bs) <= deadline; the
                        # exact probe supplies the dispatch reservations
                        chosen_bs = floor_bs
                        chosen_r = self._probe_cached(cache, p, floor_bs, now)
                else:
                    # linear fallback: correctness never depends on
                    # profiling artifacts (non-monotone measured tables)
                    for bs in range(p.unified_batch - 1, 0, -1):
                        r = self._probe_cached(cache, p, bs, now)
                        if r.finish_time <= deadline:
                            chosen_bs, chosen_r = bs, r
                            break
            if chosen_bs == 0:
                stats.drops += 1
                out.append(Drop(q.popleft()))
                continue  # start over with the next oldest request
            if len(q) < chosen_bs:
                # Wait for more requests until the last moment the queue can
                # still be served without violating q[0]'s SLO.
                slack = q[0].deadline_s - chosen_r.finish_time
                wake = now + max(0.0, slack)
                if slack > 1e-6:
                    out.append(WaitUntil(wake))
                    break
                # last moment: dispatch what we have (memoized if the
                # search already priced this batch size this round)
                chosen_bs = len(q)
                chosen_r = self._probe_cached(cache, p, chosen_bs, now)
                if chosen_r.finish_time > q[0].deadline_s + 1e-12:
                    stats.drops += 1
                    out.append(Drop(q.popleft()))
                    continue
            reserve(chosen_r)
            cache.clear()  # reservations moved the timelines: memo is stale
            batch = [q.popleft() for _ in range(chosen_bs)]
            stats.dispatches += 1
            out.append(Dispatch(pipeline=p, requests=batch, probe_result=chosen_r))
        return out


class ReactiveScheduler:
    """Ablation baseline (paper section 7.4): per-pool adaptive batching with no
    resource-usage tracking.  Each dispatch greedily takes the least-loaded
    pool member and the largest batch whose nominal latency fits the oldest
    deadline; network transfers queue FIFO on NICs without coordination, so
    contention (D3) emerges as queueing delay."""

    def __init__(self, runtime: ClusterRuntime, queues=None) -> None:
        self.runtime = runtime
        self.queues: dict[str, deque[Request]] = (
            queues if queues is not None else {}
        )
        self.stats = SchedulerStats()
        # actual availability times, maintained reactively (not reservations)
        self.vdev_free: dict[int, float] = {v.vdev_id: 0.0 for v in runtime.vdevs}
        for p in runtime.pipelines:
            self.queues.setdefault(p.model_name, deque())

    def enqueue(self, req: Request) -> None:
        self.queues.setdefault(req.model_name, deque()).append(req)

    def pending(self, model: str) -> int:
        return len(self.queues.get(model, ()))

    def schedule(self, model: str, now: float) -> list[Dispatch | Drop | WaitUntil]:
        out: list[Dispatch | Drop | WaitUntil] = []
        q = self.queues.get(model)
        pipelines = self.runtime.pipelines_of(model)
        if not q or not pipelines:
            return out
        while q:
            # pick pipeline whose first-stage pool frees up soonest
            def first_free(p: PipelineRuntime) -> float:
                return min(self.vdev_free[v.vdev_id] for v in p.stages[0].vdevs)

            p = min(pipelines, key=first_free)
            start = max(now, first_free(p))
            # largest batch whose nominal (reservation-blind) completion meets
            # the oldest deadline — i.e. the paper's per-pool SLO check.
            nominal = lambda bs: start + sum(s.latency(bs) for s in p.stages)
            chosen_bs = 0
            for bs in range(p.unified_batch, 0, -1):
                if nominal(bs) <= q[0].deadline_s:
                    chosen_bs = bs
                    break
            if chosen_bs == 0:
                self.stats.drops += 1
                out.append(Drop(q.popleft()))
                continue
            if len(q) < chosen_bs:
                slack = q[0].deadline_s - nominal(min(len(q), chosen_bs))
                if slack > 1e-6:
                    out.append(WaitUntil(now + slack))
                    break
                chosen_bs = len(q)
            # build a pseudo probe result: greedy first-free member per stage,
            # NO network awareness (transfer timing resolved by the simulator)
            path = []
            t = start
            stage_starts, stage_durs = [], []
            for s in p.stages:
                gpu = min(s.vdevs, key=lambda v: self.vdev_free[v.vdev_id])
                st = max(t, self.vdev_free[gpu.vdev_id])
                dur = s.latency(chosen_bs)
                path.append(gpu)
                stage_starts.append(st)
                stage_durs.append(dur)
                self.vdev_free[gpu.vdev_id] = st + dur
                t = st + dur
            r = ProbeResult(
                path=path, reservations=[], finish_time=t, wait_time=start - now,
                stage_starts=stage_starts, stage_durs=stage_durs,
                xfer_starts=[0.0] * (len(path) - 1),
                xfer_durs=[-1.0] * (len(path) - 1),  # -1 => simulator computes
            )
            batch = [q.popleft() for _ in range(chosen_bs)]
            self.stats.dispatches += 1
            out.append(Dispatch(pipeline=p, requests=batch, probe_result=r))
        return out
