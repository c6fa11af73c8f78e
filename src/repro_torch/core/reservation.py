"""Resource reservation mechanism (paper section 5.4, Algorithm 2).

Every schedulable resource — virtual device, host uplink, host downlink —
carries a `Timeline` of reserved half-open intervals.  `probe()` walks a
pooled pipeline greedily, choosing for each partition the pool member that
minimizes batch completion time given current reservations, and returns the
path plus the exact intervals to reserve; `reserve()` commits them.  Feature-
map transfers require *simultaneous* slots on the sender's uplink and the
receiver's downlink (`earliest_slot_multi`).

Feedback correction (`Timeline.correct`) re-synchronizes the scheduler's view
with actual execution times reported by nodes.

Hot-path notes (DESIGN.md section 8): `Timeline.reserve`/`earliest_slot`
take O(1) fast paths at the tail (the overwhelmingly common case after
`gc`), `earliest_slot_multi` is a merged-gap walk visiting each interval at
most once, and `probe()` stops scanning a pool the moment a member achieves
the stage's zero-wait lower bound (first-fit early exit — provably the same
winner under the first-minimum tie-break) and only materializes Reservation
records for the winning member.  All of this is decision-identical to the
frozen pre-optimization copy in `core/_reference.py`, enforced bit-for-bit
by tests/test_sched_equivalence.py.
"""

from __future__ import annotations

import bisect
from dataclasses import dataclass, field

INF = float("inf")


class Timeline:
    """Sorted, non-overlapping reservation intervals for one resource."""

    __slots__ = ("starts", "ends")

    def __init__(self) -> None:
        self.starts: list[float] = []
        self.ends: list[float] = []

    @property
    def last_end(self) -> float:
        """End of the latest reservation (0.0 when empty): the earliest time
        this resource is guaranteed free of *booked* work."""
        return self.ends[-1] if self.ends else 0.0

    def earliest_slot(self, t: float, dur: float) -> float:
        """Earliest start >= t such that [start, start+dur) is free."""
        if dur <= 0:
            return t
        ends = self.ends
        if not ends or t >= ends[-1]:
            return t  # O(1) tail fast path: nothing booked at or after t
        i = bisect.bisect_right(ends, t)  # first interval ending after t
        starts = self.starts
        n = len(starts)
        cur = t
        while i < n:
            if cur + dur <= starts[i] + 1e-12:
                return cur
            e = ends[i]
            if e > cur:
                cur = e
            i += 1
        return cur

    def reserve(self, start: float, dur: float) -> None:
        if dur <= 0:
            return
        end = start + dur
        starts, ends = self.starts, self.ends
        if not starts:
            starts.append(start)
            ends.append(end)
            return
        if start > starts[-1]:
            # O(1) tail fast path: bisect_left would land past the final
            # interval, so the only possible neighbour is ends[-1].  Same
            # merge predicate as the general path below.
            if ends[-1] >= start - 1e-12:
                if end > ends[-1]:
                    ends[-1] = end
                return
            starts.append(start)
            ends.append(end)
            return
        i = bisect.bisect_left(starts, start)
        # merge with neighbours if touching/overlapping
        if i > 0 and ends[i - 1] >= start - 1e-12:
            i -= 1
            start = min(start, starts[i])
            end = max(end, ends[i])
            del starts[i], ends[i]
        while i < len(starts) and starts[i] <= end + 1e-12:
            end = max(end, ends[i])
            del starts[i], ends[i]
        starts.insert(i, start)
        ends.insert(i, end)

    def correct(self, planned_start: float, planned_dur: float,
                actual_start: float, actual_dur: float) -> None:
        """Feedback correction: replace a planned interval with reality."""
        self.release(planned_start, planned_dur)
        self.reserve(actual_start, actual_dur)

    def release(self, start: float, dur: float) -> None:
        """Remove [start, start+dur) from the reserved set (splitting if needed).

        Interval lists are sorted and non-overlapping, so everything ending
        at/before `start` is a prefix (skipped via bisect) and the first
        interval starting at/after `end` terminates the scan — O(log n +
        overlaps) instead of the reference's full O(n) walk.  This is the
        feedback-correction hot path: `correct()` calls it once per executed
        stage/transfer."""
        end = start + dur
        starts, ends = self.starts, self.ends
        # first interval with e > start + 1e-12 (reference skip predicate)
        i = bisect.bisect_right(ends, start + 1e-12)
        n = len(starts)
        while i < n:
            s, e = starts[i], ends[i]
            if s >= end - 1e-12:
                return  # sorted: every later interval starts even further right
            del starts[i], ends[i]
            n -= 1
            if s < start:
                starts.insert(i, s)
                ends.insert(i, start)
                i += 1
                n += 1
            if e > end:
                starts.insert(i, end)
                ends.insert(i, e)
                i += 1
                n += 1

    def busy_between(self, t0: float, t1: float) -> float:
        total = 0.0
        for s, e in zip(self.starts, self.ends):
            total += max(0.0, min(e, t1) - max(s, t0))
        return total

    def gc(self, now: float) -> None:
        """Drop intervals fully in the past (keeps probe() O(near-future))."""
        i = bisect.bisect_right(self.ends, now)
        if i > 0:
            del self.starts[:i], self.ends[:i]


def earliest_slot_multi(timelines: list[Timeline], t: float, dur: float) -> float:
    """Earliest start >= t at which *all* timelines are free for `dur`
    (paper: simultaneous uplink+downlink availability).

    Merged-gap walk: every timeline keeps a cursor at its first interval
    that could still block the candidate start, and each interval is visited
    at most once — O(total intervals) worst case, replacing the old capped
    fixpoint iteration (which redid bisects per round and could bail out
    non-converged at pathological fragmentation).  The result is the least
    common free point, i.e. exactly the old fixpoint."""
    if dur <= 0:
        return t
    cur = t
    tail_free = True
    for tl in timelines:
        if tl.ends and cur < tl.ends[-1]:
            tail_free = False
            break
    if tail_free:
        return cur  # O(1): past every booking on every timeline
    if len(timelines) == 1:
        return timelines[0].earliest_slot(cur, dur)
    idx = [bisect.bisect_right(tl.ends, cur) for tl in timelines]
    while True:
        moved = False
        for k, tl in enumerate(timelines):
            starts, ends = tl.starts, tl.ends
            i = idx[k]
            n = len(starts)
            while i < n:
                if cur + dur <= starts[i] + 1e-12:
                    break  # free window on this timeline at cur
                e = ends[i]
                if e > cur:
                    cur = e
                    moved = True
                i += 1
            idx[k] = i
        if not moved:
            return cur


# ----------------------------------------------------------------------------
# Instantiated cluster resources
# ----------------------------------------------------------------------------


@dataclass
class NodeRes:
    node_id: int
    accel_class: str
    uplink: Timeline = field(default_factory=Timeline)
    downlink: Timeline = field(default_factory=Timeline)
    nic_bw: float = 0.0
    # physical host index within the class inventory (chip_id // chips_per
    # _host).  node_id is allocation-order and NOT stable across plan epochs;
    # (accel_class, host_id) is — it names the physical NIC, which is what
    # cross-epoch resource coupling keys on.
    host_id: int = 0


@dataclass
class VDevRes:
    vdev_id: int
    node: NodeRes
    chip_id: int
    accel_class: str
    vfrac: int
    timeline: Timeline = field(default_factory=Timeline)
    busy_s: float = 0.0  # accumulated actual execution time (utilization metric)


@dataclass
class Reservation:
    resource: Timeline
    start: float
    dur: float
    kind: str  # "gpu" | "ul" | "dl"
    holder: object | None = None  # VDevRes for kind=="gpu"


@dataclass
class ProbeResult:
    path: list[VDevRes]
    reservations: list[Reservation]
    finish_time: float
    wait_time: float
    stage_starts: list[float]
    stage_durs: list[float]
    xfer_starts: list[float]
    xfer_durs: list[float]


@dataclass
class StageRuntime:
    """One partition pool at runtime: members + latency/transfer models."""

    vdevs: list[VDevRes]
    latency_by_batch: dict[int, float]
    # bytes to transfer INTO this stage per request (0 for first stage)
    in_bytes_per_req: float
    # feedback-correction multiplier: the data plane's FeedbackController sets
    # this to the EWMA of measured/planned duration so future probes price the
    # stage at its observed speed (paper section 5.4, feedback correction).
    lat_scale: float = 1.0

    # lazily computed pool facts for probe()'s early-exit threshold: the set
    # of member node identities and the best member NIC bandwidth.  Static
    # after build_runtime (pool membership never changes within a plan
    # epoch; a swap builds a fresh runtime).
    _node_ids: frozenset | None = field(default=None, repr=False, compare=False)
    _bw_max: float = field(default=0.0, repr=False, compare=False)

    def latency(self, bs: int) -> float:
        return self._base_latency(bs) * self.lat_scale

    def _base_latency(self, bs: int) -> float:
        if bs in self.latency_by_batch:
            return self.latency_by_batch[bs]
        # conservative: next profiled batch size above bs
        for b in sorted(self.latency_by_batch):
            if b >= bs:
                return self.latency_by_batch[b]
        return self.latency_by_batch[max(self.latency_by_batch)]

    def _pool_info(self) -> tuple[frozenset, float]:
        ids = self._node_ids
        if ids is None:
            ids = self._node_ids = frozenset(
                v.node.node_id for v in self.vdevs)
            self._bw_max = max((v.node.nic_bw for v in self.vdevs), default=0.0)
        return ids, self._bw_max


@dataclass
class PipelineRuntime:
    pipeline_id: int
    model_name: str
    unified_batch: int
    stages: list[StageRuntime]
    # True when probe(pipeline, bs, now).finish_time is provably monotone
    # non-decreasing in bs, so the scheduler's batch-size search may bisect
    # instead of scanning linearly.  Set by validate_bisection() at
    # runtime-build / re-calibration time; defaults to the always-correct
    # linear fallback.  See DESIGN.md section 8 for the argument.
    bisection_ok: bool = False
    # Gate outcome in full: "exact" (bisection_ok — finish itself is
    # monotone), "envelope" (latency tables monotone but upstream pools span
    # nodes: finish is NOT provably monotone, yet it is sandwiched between
    # the monotone bounds probe_lower_bound/probe_upper_envelope, so the
    # scheduler bisects the bounds and exact-probes only the ambiguous
    # band), or "linear" (non-monotone tables — full scan).  Stamped by
    # validate_bisection() alongside bisection_ok.
    bisection_mode: str = "linear"


def validate_bisection(pipeline: PipelineRuntime) -> bool:
    """Decide how the scheduler's batch-size search may run for `pipeline`:
    stamp `pipeline.bisection_mode` and `pipeline.bisection_ok`.

    probe()'s finish time is provably monotone non-decreasing in bs (mode
    "exact", bisection_ok=True) when every per-member finish is monotone AND
    the per-member timing environment does not depend on which member won
    the previous stage.  Concretely:

    * every stage's latency table must induce a non-decreasing latency over
      1..unified_batch (measured tables can violate this — profiling noise);
      `lat_scale` is a positive uniform multiplier, so feedback correction
      preserves the ordering and needs no re-validation;
    * transfer duration is linear in bs and `earliest_slot`/`_multi` are
      monotone in (t, dur) — always true;
    * for every receiving stage (in_bytes > 0) the UPSTREAM pool must live
      on a single node.  Otherwise the greedy winner of the previous stage
      can switch nodes as bs grows, changing the uplink timeline and the
      co-location pattern the next stage sees — which genuinely breaks
      monotonicity (stricter than the obvious table-only condition; see
      DESIGN.md section 8).

    When only the last condition fails (pools span hosts — the common case
    once a class pool exceeds chips_per_host), the finish is still bracketed
    by two monotone functions of bs — probe_lower_bound below it and
    probe_upper_envelope above it — so the scheduler can bisect the bounds
    and fall back to exact probes only inside the band where they disagree
    about feasibility (mode "envelope"; DESIGN.md section 11).  bisection_ok
    keeps its original strict meaning (finish itself provably monotone), so
    existing callers reading the bool are unaffected.

    Call again after replacing any `latency_by_batch` table
    (calibrate_runtime, ProfileStore.reprice_runtime do)."""
    monotone = True
    for stage in pipeline.stages:
        prev = None
        for b in range(1, pipeline.unified_batch + 1):
            cur = stage._base_latency(b)
            if prev is not None and cur < prev:
                monotone = False
                break
            prev = cur
        if not monotone:
            break
    single_upstream = True
    if monotone:
        for si, stage in enumerate(pipeline.stages):
            if si > 0 and stage.in_bytes_per_req > 0:
                if len({v.node.node_id
                        for v in pipeline.stages[si - 1].vdevs}) > 1:
                    single_upstream = False
                    break
    if not monotone:
        pipeline.bisection_mode = "linear"
    elif single_upstream:
        pipeline.bisection_mode = "exact"
    else:
        pipeline.bisection_mode = "envelope"
    pipeline.bisection_ok = pipeline.bisection_mode == "exact"
    return pipeline.bisection_ok


def probe_lower_bound(pipeline: PipelineRuntime, bs: int, now: float) -> float:
    """Cheap lower bound on probe(pipeline, bs, now).finish_time: the
    contention-free chain that pays, per stage, the best-case transfer and
    the stage latency with zero queueing wait.

    Validity: probe()'s per-member finish only adds waits on top of exactly
    these terms, and every member's transfer bandwidth min(upstream NIC,
    member NIC) is <= min(max upstream NIC, max member NIC) — max of
    pairwise mins equals min of maxes here because the max-NIC upstream node
    paired with the max-NIC member realizes both maxima.  When the upstream
    and stage pools share a node, a co-located path with zero transfer may
    exist, so the bound charges no transfer at all.  The arithmetic uses the
    same association order as probe() (`t + l_n` then `+ l_i`), so the bound
    never exceeds the probed finish by float re-association.

    Monotone non-decreasing in bs whenever every stage latency table is
    (transfer time is linear in bs; IEEE add/divide preserve ordering).
    O(stages) — no timeline walks."""
    t = now
    prev: StageRuntime | None = None
    for stage in pipeline.stages:
        l_i = stage.latency(bs)
        in_bytes = stage.in_bytes_per_req
        if prev is not None and in_bytes > 0:
            up_ids, up_bw = prev._pool_info()
            node_ids, bw_max = stage._pool_info()
            if not (up_ids & node_ids):
                bwm = up_bw if up_bw < bw_max else bw_max
                t = t + in_bytes * bs / bwm
        t = t + l_i
        prev = stage
    return t


def probe_upper_envelope(pipeline: PipelineRuntime, bs: int, now: float) -> float:
    """Monotone upper bound on probe(pipeline, bs, now).finish_time for
    pipelines whose upstream pools span nodes (bisection_mode "envelope").

    probe()'s finish fails to be monotone in bs only because the greedy
    winner of stage i-1 can switch NODES as bs grows, changing the uplink
    timeline and co-location pattern stage i sees.  This walk removes that
    dependence: at each receiving stage it takes the MAX over every
    candidate upstream node u of the stage-minimum finish computed as if the
    batch arrived from u.  For fixed u, each member's finish is monotone in
    (arrival, bs) — same slot/transfer arithmetic as probe() — so the
    per-u minimum is monotone, the max over u is monotone, and the chained
    arrival keeps the whole walk monotone by induction.  It dominates the
    real probe because the real winner's node is one of the candidates and
    the envelope arrival is >= the real arrival (induction again).

    Within each fixed-u member scan the same zero-wait early exit as
    probe() applies (the threshold is a lower bound on every member's
    finish for that u, and only the min VALUE is needed here).  Cost:
    O(stages x upstream_nodes x pool) timeline walks worst case, paid
    O(log B) times per gated search instead of O(B) exact probes."""
    t_g = now
    prev: StageRuntime | None = None
    for stage in pipeline.stages:
        l_i = stage.latency(bs)
        in_bytes = stage.in_bytes_per_req
        if prev is None or in_bytes <= 0:
            # no transfer: identical to probe()'s stage-min at arrival t_g
            threshold = t_g + l_i
            best = INF
            for gpu in stage.vdevs:
                s = gpu.timeline.earliest_slot(t_g, l_i)
                finish = s + l_i
                if finish < best:
                    best = finish
                    if finish <= threshold:
                        break
            t_g = best
        else:
            node_ids, bw_max = stage._pool_info()
            worst = -INF
            seen: set[int] = set()
            for up in prev.vdevs:
                up_node = up.node
                if up_node.node_id in seen:
                    continue
                seen.add(up_node.node_id)
                up_bw = up_node.nic_bw
                ul = up_node.uplink
                if up_node.node_id in node_ids:
                    threshold = t_g + l_i
                else:
                    bwm = up_bw if up_bw < bw_max else bw_max
                    threshold = (t_g + in_bytes * bs / bwm) + l_i
                best = INF
                for gpu in stage.vdevs:
                    t = t_g
                    gpu_node = gpu.node
                    bw = up_bw if up_bw < gpu_node.nic_bw else gpu_node.nic_bw
                    l_n = in_bytes * bs / bw
                    if up_node is gpu_node:
                        l_n = 0.0
                    if l_n > 0:
                        s = earliest_slot_multi([ul, gpu_node.downlink], t, l_n)
                        t = s + l_n
                    s = gpu.timeline.earliest_slot(t, l_i)
                    finish = s + l_i
                    if finish < best:
                        best = finish
                        if finish <= threshold:
                            break
                if best > worst:
                    worst = best
            t_g = worst
        prev = stage
    return t_g


def probe(pipeline: PipelineRuntime, bs: int, now: float) -> ProbeResult:
    """Algorithm 2, probe(): greedy per-stage pool-member selection.

    Decision-identical to `_reference.reference_probe` (the pre-optimization
    copy) but with the pool scan pruned: a member whose resources are free
    on arrival achieves the stage's zero-wait lower bound, and no member —
    scanned or not — can beat that bound, so the scan stops there.  Since
    the reference keeps the FIRST strict minimum, the first member to hit
    the bound is exactly the member the full scan would have chosen.
    Reservation records are built only for the winning member."""
    t_g = now
    path: list[VDevRes] = []
    resv: list[Reservation] = []
    wait = 0.0
    stage_starts: list[float] = []
    stage_durs: list[float] = []
    xfer_starts: list[float] = []
    xfer_durs: list[float] = []
    last: VDevRes | None = None

    for si, stage in enumerate(pipeline.stages):
        l_i = stage.latency(bs)
        in_bytes = stage.in_bytes_per_req
        xfer = last is not None and in_bytes > 0
        if xfer:
            last_node = last.node
            last_bw = last_node.nic_bw
            ul = last_node.uplink
            node_ids, bw_max = stage._pool_info()
            if last_node.node_id in node_ids:
                # some member is co-located: zero-wait bound skips the xfer
                threshold = t_g + l_i
            else:
                # every member pays a transfer; the best case uses the
                # fattest member NIC.  Same association order as the member
                # arithmetic below so equality is exact in floats.
                bwm = last_bw if last_bw < bw_max else bw_max
                threshold = (t_g + in_bytes * bs / bwm) + l_i
        else:
            threshold = t_g + l_i
        best_finish = INF
        best = None  # (gpu, wait_delta, xs, xd, ss)
        for gpu in stage.vdevs:
            t = t_g
            w = 0.0
            xs = xd = 0.0
            if xfer:
                gpu_node = gpu.node
                bw = last_bw if last_bw < gpu_node.nic_bw else gpu_node.nic_bw
                l_n = in_bytes * bs / bw
                if last_node is gpu_node:
                    l_n = 0.0  # co-located: feature map stays on host
                if l_n > 0:
                    s = earliest_slot_multi([ul, gpu_node.downlink], t, l_n)
                    w += s - t
                    xs, xd = s, l_n
                    t = s + l_n
            s = gpu.timeline.earliest_slot(t, l_i)
            w += s - t
            finish = s + l_i
            if finish < best_finish:
                best_finish = finish
                best = (gpu, w, xs, xd, s)
                if finish <= threshold:
                    break  # zero-wait bound hit: no member can beat this
        gpu, w, xs, xd, ss = best
        path.append(gpu)
        if xd > 0.0:
            resv.append(Reservation(ul, xs, xd, "ul"))
            resv.append(Reservation(gpu.node.downlink, xs, xd, "dl"))
        resv.append(Reservation(gpu.timeline, ss, l_i, "gpu", holder=gpu))
        wait += w
        stage_starts.append(ss)
        stage_durs.append(l_i)
        if si > 0:
            xfer_starts.append(xs)
            xfer_durs.append(xd)
        t_g = best_finish
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


def reserve(result: ProbeResult) -> None:
    """Algorithm 2, reserve(): commit every interval returned by probe()."""
    for r in result.reservations:
        r.resource.reserve(r.start, r.dur)


def cancel(result: ProbeResult) -> None:
    """Undo reserve(): release every interval a probe committed.

    Used by the data plane when a dispatched batch cannot execute (executor
    failure) so its reserved capacity is returned to the pool.
    """
    for r in result.reservations:
        r.resource.release(r.start, r.dur)
