"""The event-driven serving data plane.

`DataPlane.serve(trace)` replays a request trace through the full PPipe
stack: admission-controlled queues (queues.py) -> the shared Algorithm 1
scheduler (batcher.py) -> reservation-driven stage/transfer execution with
overlapped real dispatch on the device (dispatcher.py) -> telemetry
(metrics.py).

Scheduling runs on a *virtual* clock in trace seconds — the latency model
prices accelerator pools, and arrival timestamps/SLOs live on that axis —
while the dispatcher executes batches for real in wall time underneath.  The
two clocks meet in `FeedbackController`: measured wall durations are
calibrated into virtual seconds and, in ``feedback="measured"`` mode, replace
the planned stage durations and re-synchronize the reservation timelines via
`Timeline.correct`.

This is the reference package's `dataplane/plane.py` with its device code
in PyTorch: the event loop, plan hot-swap with epoch GC and cross-epoch
resource coupling, `serve_stream` with backpressure edges, fault injection
(`fail_host`, `fail_chips`, stragglers, bounded retries) and the observer
hooks are the reference's, line for line; `_default_tokens`,
`build_executors` and `calibrate_runtime` make tensors on the executors'
device and time stages between synchronisations of their stream.  With planned
feedback and no dispatcher the plane is decision-identical to the
reference's (tests/test_torch_dataplane.py, tests/test_torch_api.py).
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
from repro_torch.core.runtime import ClusterRuntime, build_runtime
from repro_torch.core.scheduler import Dispatch, Drop, WaitUntil
from repro_torch.core.types import ModelProfile, Request, RequestOutcome
from repro_torch.obs.observer import (
    OP_ARRIVE,
    OP_COMPLETE,
    OP_DISPATCH,
    OP_DROP,
    OP_STAGE,
    OP_XFER,
)

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
    # the runtime objects this batch was probed/dispatched on.  A plan
    # hot-swap (swap_plan) replaces DataPlane.rt/dispatcher/fb, so in-flight
    # jobs must keep their own references to finish on the old plan's pools.
    pipeline: PipelineRuntime = None
    epoch: int = 0
    dispatcher: PoolDispatcher | None = None
    fb: FeedbackController | None = None
    stage_idx: int = 0
    clock: float = 0.0  # virtual time the batch finished its previous hop
    # highest stage index that actually started executing (-1 = none): a
    # started stage's planned interval was already replaced by its actual
    # one (Timeline.correct), so cancelling the job must leave it booked
    started: int = -1


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
        scheduler_cls=None,
        observer=None,
    ) -> None:
        if feedback not in ("planned", "measured"):
            raise ValueError(f"feedback must be planned|measured, got {feedback!r}")
        if feedback == "measured" and dispatcher is None:
            raise ValueError("measured feedback requires a dispatcher")
        self.policy = policy
        self.feedback = feedback
        self.feedback_alpha = feedback_alpha
        # amortized timeline-GC cadence in virtual seconds (decision-neutral,
        # see ClusterRuntime.maybe_gc); math.inf disables GC
        self.gc_interval_s = gc_interval_s
        # Algorithm 1 implementation the batcher drives; None = the shared
        # optimized ReservationScheduler.  The reference package's
        # equivalence suite injects its frozen
        # `core._reference.ReferenceReservationScheduler` here to prove the
        # whole plane is decision-identical under either.
        self.scheduler_cls = scheduler_cls
        self.seq_len = seq_len
        # the caller's token factory; None makes tokens on the device of the
        # current dispatcher's first stage (set per epoch in _install_runtime)
        self._token_fn_arg = token_fn
        self.token_fn = token_fn
        self.tel = Telemetry()
        self.events: list[tuple[float, int, int, object]] = []
        self.seq = itertools.count()
        self.jobs: dict[int, _Job] = {}
        self.job_ids = itertools.count()
        # plan epoch: bumped by swap_plan; resource-free maps are keyed by
        # (epoch, id) because vdev/node ids restart at 0 in each new runtime
        self.epoch = 0
        # epochs retired by swap_plan but not yet garbage-collected, keyed by
        # epoch number.  An epoch's runtime/dispatcher live exactly until its
        # last in-flight job completes (_maybe_gc_epoch), bounding memory to
        # the in-flight window under arbitrarily many swaps.
        self._retired_runtimes: dict[int, ClusterRuntime] = {}
        self._retired_dispatchers: dict[int, PoolDispatcher] = {}
        self._epoch_inflight: dict[int, int] = {}
        # scheduler stats accumulated from batchers retired by swap_plan, so
        # probes_per_dispatch (and the cache-hit/bisection counters surfaced
        # in Telemetry.snapshot) stay continuous across plan epochs
        self._retired_probe_calls = 0
        self._retired_dispatches = 0
        self._retired_cache_hits = 0
        self._retired_bisects = 0
        # physical resource occupancy shared across plan epochs, keyed by the
        # *stable* physical identity — chip (class, chip_id), NIC direction
        # (class, host_id) — mapping epoch -> latest known end of that epoch's
        # work on the resource.  Updated live at every stage/transfer start,
        # so an old-epoch stage whose actual start slips past its reservation
        # still excludes later epochs exactly (ROADMAP cross-epoch coupling);
        # entries drain at epoch GC (all ends are then in the past).
        self._phys_chip: dict[tuple[str, int], dict[int, float]] = {}
        self._phys_nic_ul: dict[tuple[str, int], dict[int, float]] = {}
        self._phys_nic_dl: dict[tuple[str, int], dict[int, float]] = {}
        # governance toggles — tests flip these to reproduce legacy behaviour
        # (snapshot-only residual seeding / keep-until-finalize accounting)
        self.cross_epoch_coupling = True
        self.epoch_gc = True
        # optional repro_torch.obs.Observer: when set, arrival/drop/dispatch/
        # stage/transfer/complete/swap events flow into its windowed metrics
        # and decision journal (which subsumes the old ad-hoc exec_log — the
        # cross-epoch no-double-booking property tests audit "exec.stage"/
        # "exec.xfer" journal events).  Hot sites push pre-encoded OP_*
        # tuples straight into the observer's deferred buffer (one list
        # append per event, materialized lazily off the serving path); None
        # (the default) skips every hook behind an `is not None` check,
        # keeping the off path decision-identical and near-zero-cost.
        self.obs = observer
        self.vdev_virtual_free: dict[tuple[int, int], float] = {}
        self.nic_ul_free: dict[tuple[int, int], float] = {}
        self.nic_dl_free: dict[tuple[int, int], float] = {}
        self._wakes: dict[str, float] = {}
        # called as hook(request, now) after each arrival is admitted/rejected;
        # the ReplanLoop (repro_torch.controlplane) registers itself here
        self.arrival_hooks: list = []
        # per-model backpressure edge state (True while between an admit.shed
        # and its admit.resume); plane-level so it survives swap_plan's queue
        # rebuild and the post-swap poll can emit the resume edge
        self._bp_shedding: dict[str, bool] = {}
        # ---- elastic-cluster fault state (repro_torch.faults, DESIGN.md §13) ----
        # attached FaultInjector (set by FaultInjector.attach): consulted
        # once per dispatch for transient exec failures and for the bounded
        # retry budget; None keeps the legacy fail-the-batch behaviour
        self.faults = None
        # straggler multipliers keyed by physical chip (class, chip_id):
        # actual stage durations on these chips are inflated, and the slip
        # flows through Timeline.correct + the cross-epoch free maps exactly
        # like measured-feedback slip
        self._slowdowns: dict[tuple[str, int], float] = {}
        # remaining retry budget per req_id (only requests that failed at
        # least once appear; entries clear at completion or exhaustion)
        self._retry_left: dict[int, int] = {}
        # called as hook(now, accel_class, host_id, lost_chips) after a node
        # loss cancelled its in-flight work and released reservations, but
        # BEFORE the victims are re-admitted — the ReplanLoop registers its
        # mandatory replan here so victims re-enter queues priced on the
        # post-loss topology
        self.loss_hooks: list = []
        self._install_runtime(runtime, dispatcher)

    def _install_runtime(self, runtime: ClusterRuntime,
                         dispatcher: PoolDispatcher | None) -> None:
        """Install `runtime` (+ optional dispatcher) as the current plan
        epoch: fresh admission queues/batcher, feedback controller, and
        epoch-keyed resource-free maps.  Shared by __init__ (epoch 0) and
        swap_plan (subsequent epochs) so the two paths cannot diverge."""
        self.rt = runtime
        if self.scheduler_cls is None:
            self.batcher = AdaptiveBatcher(runtime, self.policy)
        else:
            self.batcher = AdaptiveBatcher(runtime, self.policy,
                                           scheduler_cls=self.scheduler_cls)
        self.dispatcher = dispatcher
        if dispatcher is not None:
            # batches submitted from now on belong to this plan epoch — the
            # same dispatcher instance may legitimately serve several epochs
            # (swap_plan factories can reuse compiled executors), and stage
            # walls must not blend across them
            dispatcher.current_epoch = self.epoch
            # wall-clock batch measurements flow to the same observer
            dispatcher.obs = self.obs
            self.token_fn = _token_fn_for(dispatcher.executors, self._token_fn_arg)
        self.fb = (
            FeedbackController(runtime, alpha=self.feedback_alpha,
                               adapt_latency=self.feedback == "measured")
            if dispatcher is not None else None
        )
        self.vdev_virtual_free.update(
            {(self.epoch, v.vdev_id): 0.0 for v in runtime.vdevs})
        self.nic_ul_free.update(
            {(self.epoch, n.node_id): 0.0 for n in runtime.nodes})
        self.nic_dl_free.update(
            {(self.epoch, n.node_id): 0.0 for n in runtime.nodes})

    # ------------------------------------------------------------------ events
    def push(self, t: float, kind: int, payload: object) -> None:
        # rank 0 for arrivals, 1 for derived events: at equal t an arrival
        # always processes before the work it could join — exactly the order
        # batch `serve` produced when every arrival was pushed up front (all
        # arrival seqs below all derived seqs), now independent of WHEN the
        # arrival entered the heap.  That independence is what makes
        # serve(trace) bit-identical to serve_stream(TraceSource(trace)).
        rank = 0 if kind == self.ARRIVAL else 1
        heapq.heappush(self.events, (t, rank, next(self.seq), kind, payload))

    def serve(self, trace: list[Request]) -> Telemetry:
        """Replay a finite trace (= stream its sorted arrivals)."""
        return self.serve_stream(iter(sorted(trace)))

    def serve_stream(self, arrivals, horizon_s: float | None = None) -> Telemetry:
        """Pull-based serve: consume `arrivals` (an iterator of Requests in
        non-decreasing arrival_s order, possibly unbounded) incrementally —
        the next arrival enters the event heap only once the heap holds no
        earlier event, so unbounded sources never materialize.

        `horizon_s` truncates the source: arrivals at or after it are never
        admitted (the half-open [0, horizon) convention of the trace
        generators); already-admitted work still drains to completion.
        Required when `arrivals` is unbounded."""
        arrivals = iter(arrivals)
        pending: Request | None = next(arrivals, None)
        last_arrival = -float("inf")
        horizon = 0.0
        while True:
            # admit every source arrival due before the next heap event;
            # one-request lookahead keeps memory O(in-flight), not O(trace)
            while pending is not None and (
                horizon_s is None or pending.arrival_s < horizon_s
            ) and (
                not self.events or pending.arrival_s <= self.events[0][0]
            ):
                if pending.arrival_s < last_arrival:
                    raise ValueError(
                        "source arrivals must be non-decreasing: got "
                        f"{pending.arrival_s} after {last_arrival}")
                last_arrival = pending.arrival_s
                self.push(pending.arrival_s, self.ARRIVAL, pending)
                pending = next(arrivals, None)
            if pending is not None and (
                    horizon_s is not None and pending.arrival_s >= horizon_s):
                pending = None  # source truncated at the horizon
            if not self.events:
                break
            t, _, _, kind, payload = heapq.heappop(self.events)
            if kind == self.ARRIVAL:
                self._on_arrival(t, payload)
            elif kind == self.WAKE:
                self._wakes.pop(payload, None)
                self._run_scheduler(payload, t)
            elif kind == self.STAGE_DONE:
                self._on_stage_done(t, payload)
            elif kind == self.XFER_DONE:
                self._on_xfer_done(t, payload)
            self.rt.maybe_gc(t, self.gc_interval_s)
            horizon = max(horizon, t)
        return self._finalize_serve(horizon, requested=horizon_s)

    def _finalize_serve(self, horizon: float,
                        requested: float | None = None) -> Telemetry:
        """Shared serve epilogue: horizon accounting, scheduler stats,
        wall-measurement harvest, telemetry/observer finalize."""
        self.tel.requested_horizon_s = requested
        if requested is not None:
            # open-ended serve truncated at a requested horizon: goodput
            # denominates over the full requested window even if the last
            # event landed earlier (idle tail is real serving time)
            horizon = max(horizon, requested)
        self.tel.horizon_s = max(horizon, 1e-9)
        st = self.batcher.stats
        probes = self._retired_probe_calls + st.probe_calls
        dispatches = self._retired_dispatches + st.dispatches
        self.tel.probes_per_dispatch = probes / max(1, dispatches)
        self.tel.scheduler = {
            "probe_calls": probes,
            "dispatches": dispatches,
            "probe_cache_hits": self._retired_cache_hits + st.probe_cache_hits,
            "bisect_searches": self._retired_bisects + st.bisect_searches,
        }
        self._harvest_measurements()
        self.tel.finalize(self.rt, self._retired_runtimes,
                          current_epoch=self.epoch)
        if self.obs is not None:
            self.obs.finalize(
                self.tel.horizon_s,
                self.rt.cluster.counts if self.rt.cluster is not None else None)
        return self.tel

    # --------------------------------------------------------------- arrivals
    def _admit(self, req: Request, now: float) -> None:
        """Admission bookkeeping shared by live arrivals and swap carry-over:
        offer to the queues, record reject/shed outcomes."""
        cause, shed = self.batcher.offer(req, now)
        if cause is not None:
            self._drop(req, now, cause)
        for r in shed:
            self._drop(r, now, "overflow_shed")

    def _on_arrival(self, t: float, req: Request) -> None:
        if self.obs is not None:
            self.obs.push((OP_ARRIVE, t, req))
        self._admit(req, t)
        self._run_scheduler(req.model_name, t)
        for hook in list(self.arrival_hooks):
            hook(req, t)

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
        self._poll_backpressure(model, now)

    # ----------------------------------------------------------- backpressure
    def _poll_backpressure(self, model: str, now: float) -> None:
        """Edge-detect watermark state per model and journal the transitions
        (`admit.shed` on entering backpressure, `admit.resume` on leaving).

        Runs after every scheduling round — both arrival- and wake-driven —
        so the resume edge fires as soon as dispatches drain the queue below
        the low watermark, not only on the next arrival.  The flag dict is
        plane-level (it survives swap_plan's queue rebuild), so a swap that
        clears the congestion emits the resume edge naturally."""
        q = self.batcher.queues.by_model.get(model)
        if q is None or q.policy.high_watermark is None:
            return
        was = self._bp_shedding.get(model, False)
        if not was and q.bp_active:
            self._bp_shedding[model] = True
            self.tel.backpressure_events.append(
                (now, model, "shed", len(q)))
            if self.obs is not None:
                self.obs.on_admit_shed(now, model, len(q),
                                       q.shed, q.backpressure_rejected)
        elif was:
            if q.maybe_resume() or not q.bp_active:
                self._bp_shedding[model] = False
                self.tel.backpressure_events.append(
                    (now, model, "resume", len(q)))
                if self.obs is not None:
                    self.obs.on_admit_resume(now, model, len(q))

    # -------------------------------------------------------------- hot swap
    def swap_plan(
        self,
        new_plan: ClusterPlan,
        profiles: dict[str, ModelProfile],
        now: float,
        *,
        dispatcher_factory=None,
        runtime_setup=None,
        slo_margin: float = 0.0,
        reason: str = "replan",
    ) -> ClusterRuntime:
        """Install a re-solved ClusterPlan without dropping in-flight work.

        Drain-and-swap semantics (the control loop's hand-off point):

        * **in-flight batches** keep executing on the old plan's pools — every
          `_Job` carries its own pipeline/epoch/dispatcher references, so
          pending STAGE_DONE/XFER_DONE events resolve against the retired
          runtime and the batch completes (or legitimately misses its SLO)
          exactly as if no swap had happened;
        * **queued requests** are carried over to the new plan's queues at
          `now` through the normal admission path (a request the new plan can
          no longer serve in time is rejected and gets a drop outcome — never
          silently lost);
        * **new arrivals** and scheduling rounds run on the new runtime
          immediately.

        `now` is the virtual time of the swap (carried requests are
        re-admitted at it).  `slo_margin` is the margin the plan was solved
        against, so the swap gate enforces the same budget as the solve.
        `dispatcher_factory(new_runtime)` builds the real-execution dispatcher
        for the new plan (None keeps the new epoch virtual).
        `runtime_setup(new_runtime)` runs right after the runtime is built and
        BEFORE any carried request is re-admitted or scheduled — the hook for
        re-pricing stage latencies at measured speed (ProfileStore
        .reprice_runtime), so the very first post-swap scheduling round probes
        at the speed the plan was solved for.  Telemetry (the `self.tel`
        object, counters, outcomes) is continuous across the swap; retired
        epochs contribute utilization exactly whether they are kept to
        finalize or garbage-collected the moment their last in-flight job
        completes (`_maybe_gc_epoch`).  The residual occupancy the new epoch
        inherits is recorded per swap in `tel.swap_transient_s` — the
        measured swap-transient cost the replan policy prices.
        """
        if self.dispatcher is not None and dispatcher_factory is None:
            # a plane executing for real (planned or measured feedback) must
            # not silently degrade to virtual execution at a swap; measured
            # mode additionally mirrors the invariant __init__ enforces
            raise ValueError(
                "swap_plan on a plane with a live dispatcher requires a "
                "dispatcher_factory for the new plan"
            )
        # Everything that can fail happens BEFORE any state is mutated, so a
        # raising validate/build/setup/factory leaves the plane serving the
        # old plan untouched (no half-swap, no drained-and-lost requests).
        new_plan.validate(profiles, slo_margin=slo_margin)
        new_rt = build_runtime(new_plan, profiles)
        if runtime_setup is not None:
            runtime_setup(new_rt)
        new_dispatcher = dispatcher_factory(new_rt) if dispatcher_factory else None
        if self.dispatcher is not None and new_dispatcher is None:
            # a factory that *returns* None degrades the plane just like a
            # missing factory would — refuse before any state is touched
            raise ValueError(
                "dispatcher_factory returned None for a plane with a live "
                "dispatcher"
            )
        # ---- point of no return ------------------------------------------
        old_rt = self.rt
        old_epoch = self.epoch
        self._retired_runtimes[old_epoch] = old_rt
        if self.dispatcher is not None and new_dispatcher is not self.dispatcher:
            # a factory may legitimately return the SAME dispatcher instance
            # (executors are shared across epochs); never retire the object
            # that keeps serving, or epoch GC would gut its executors mid-run
            self._retired_dispatchers[old_epoch] = self.dispatcher
        pending = self.batcher.take_all()
        self._retired_probe_calls += self.batcher.stats.probe_calls
        self._retired_dispatches += self.batcher.stats.dispatches
        self._retired_cache_hits += self.batcher.stats.probe_cache_hits
        self._retired_bisects += self.batcher.stats.bisect_searches
        self.epoch += 1
        self._install_runtime(new_rt, new_dispatcher)
        transient = self._seed_residual_occupancy(old_rt, old_epoch, now)
        # stale WaitUntil coalescing state refers to the old queues; scheduled
        # WAKE events still fire but harmlessly re-run the new scheduler
        self._wakes.clear()
        self.tel.plan_swaps += 1
        self.tel.swap_log.append((now, reason))
        self.tel.swap_transient_s.append(transient)
        if self.obs is not None:
            self.obs.on_swap(now, old_epoch, self.epoch, reason, transient,
                             len(pending))
        models: list[str] = []
        for req in pending:
            # _admit rejects requests for models the new plan dropped (even
            # under the permissive policy), so every carried request either
            # re-enters a served queue or gets a drop outcome here
            self._admit(req, now)
            if req.model_name not in models:
                models.append(req.model_name)
        for m in models:
            self._run_scheduler(m, now)
        # an old epoch with nothing in flight retires on the spot
        self._maybe_gc_epoch(old_epoch)
        return new_rt

    # ---------------------------------------------- cross-epoch resources
    @staticmethod
    def _phys_wait(phys: dict, key: tuple[str, int], epoch: int) -> float:
        """Latest end any *other* epoch holds on physical resource `key`.

        Epochs of one resource never overlap (different plan epochs load
        different pools/weights, so a chip serves exactly one at a time);
        within an epoch, co-resident vdevs (vfrac > 1) stay concurrent —
        that sharing is priced into the partition latency, not serialized
        here.  Symmetric on purpose: a *retired* epoch's slipping stage also
        waits for work the new epoch already started on the chip."""
        by_epoch = phys.get(key)
        if not by_epoch:
            return 0.0
        return max((end for e, end in by_epoch.items() if e != epoch),
                   default=0.0)

    @staticmethod
    def _phys_note(phys: dict, key: tuple[str, int], epoch: int,
                   end: float) -> None:
        by_epoch = phys.setdefault(key, {})
        if end > by_epoch.get(epoch, 0.0):
            by_epoch[epoch] = end

    def _seed_residual_occupancy(self, old_rt: ClusterRuntime, old_epoch: int,
                                 now: float) -> float:
        """Fold the retiring epoch's booked occupancy into the shared
        physical free maps, then seed the new epoch's timelines from them.

        Drain-and-swap does not duplicate hardware: batches dispatched under
        the old plan keep their physical chips/NICs busy until they drain, so
        the new plan's pools on those resources must not probe as free at
        `now`.  Chips are identified by (class, chip_id) and NIC directions
        by (class, host_id) — `build_runtime` allocates every epoch's chips
        per class in the same order over the same inventory.  The fold
        records each old resource's last *booked* end (reservation timelines
        cover dispatched-but-unfinished work; the epoch free maps cover
        started stages/transfers) as that epoch's entry in the shared map;
        `_start_stage`/`_on_stage_done` keep refining the entries with actual
        execution ends, so a stage that slips past its booking after the
        swap still excludes other epochs exactly (no snapshot staleness).
        The seed is reserved on the new resources' timelines so probe() and
        the free-map path both wait it out; entries of an epoch vanish when
        its last job completes (_maybe_gc_epoch) — by then they are all in
        the past.  Returns the swap transient: the longest residual (virtual
        seconds past `now`) any new-epoch resource inherited."""
        # drop sub-entries that already drained (cheap O(resources) tidy-up)
        for phys in (self._phys_chip, self._phys_nic_ul, self._phys_nic_dl):
            for key in list(phys):
                by_epoch = phys[key]
                for e in [e for e, end in by_epoch.items() if end <= now]:
                    del by_epoch[e]
                if not by_epoch:
                    del phys[key]
        for v in old_rt.vdevs:
            end = max(v.timeline.last_end,
                      self.vdev_virtual_free.get((old_epoch, v.vdev_id), 0.0))
            if end > now:
                self._phys_note(self._phys_chip, (v.accel_class, v.chip_id),
                                old_epoch, end)
        for n in old_rt.nodes:
            key = (n.accel_class, n.host_id)
            ul = max(n.uplink.last_end,
                     self.nic_ul_free.get((old_epoch, n.node_id), 0.0))
            if ul > now:
                self._phys_note(self._phys_nic_ul, key, old_epoch, ul)
            dl = max(n.downlink.last_end,
                     self.nic_dl_free.get((old_epoch, n.node_id), 0.0))
            if dl > now:
                self._phys_note(self._phys_nic_dl, key, old_epoch, dl)
        transient = 0.0
        for v in self.rt.vdevs:
            free = self._phys_wait(self._phys_chip,
                                   (v.accel_class, v.chip_id), self.epoch)
            if free > now:
                self.vdev_virtual_free[(self.epoch, v.vdev_id)] = free
                v.timeline.reserve(now, free - now)
                transient = max(transient, free - now)
        for n in self.rt.nodes:
            key = (n.accel_class, n.host_id)
            ul = self._phys_wait(self._phys_nic_ul, key, self.epoch)
            if ul > now:
                self.nic_ul_free[(self.epoch, n.node_id)] = ul
                n.uplink.reserve(now, ul - now)
                transient = max(transient, ul - now)
            dl = self._phys_wait(self._phys_nic_dl, key, self.epoch)
            if dl > now:
                self.nic_dl_free[(self.epoch, n.node_id)] = dl
                n.downlink.reserve(now, dl - now)
                transient = max(transient, dl - now)
        return transient

    # ------------------------------------------------------------ epoch GC
    def _release_graphs(self, disp: PoolDispatcher) -> None:
        """Release the CUDA graphs of the retired dispatcher `disp`'s stage
        executors that no dispatcher still serving (the live one, another
        retired epoch's) shares; a later plan that needs one of them again
        captures it anew in its warm."""
        from repro_torch.serving.engine import StageExecutor

        live = [self.dispatcher, *self._retired_dispatchers.values()]
        kept = [ex for d in live if d is not None
                for execs in d.executors.values() for ex in execs]
        for execs in disp.executors.values():
            for ex in execs:
                if isinstance(ex, StageExecutor) and not any(ex is k for k in kept):
                    ex.release_graphs()

    def _maybe_gc_epoch(self, epoch: int) -> None:
        """Drop a retired epoch the moment its last in-flight job completes.

        Telemetry keeps exact per-epoch aggregates (`Telemetry.absorb_epoch`
        freezes busy chip-seconds + feedback scales; the dispatcher's wall
        measurements are harvested first), so finalize-time utilization is
        float-identical to the keep-everything accounting — while runtimes,
        timelines, dispatchers and (epoch, id) free-map entries of long
        traces with many swaps stay bounded by the in-flight window."""
        if not self.epoch_gc or epoch == self.epoch:
            return
        rt = self._retired_runtimes.get(epoch)
        if rt is None or self._epoch_inflight.get(epoch, 0) > 0:
            return
        del self._retired_runtimes[epoch]
        self._epoch_inflight.pop(epoch, None)
        disp = self._retired_dispatchers.pop(epoch, None)
        if disp is not None and disp is not self.dispatcher:
            # belt-and-braces: swap_plan never retires the live dispatcher,
            # but shutting down a still-serving object would silently drop
            # every subsequent batch, so guard here too
            self._harvest_dispatcher(disp)
            self._release_graphs(disp)
            disp.shutdown()
        self.tel.absorb_epoch(epoch, rt)
        self.tel.epochs_gcd += 1
        for free in (self.vdev_virtual_free, self.nic_ul_free,
                     self.nic_dl_free):
            for k in [k for k in free if k[0] == epoch]:
                del free[k]
        # the epoch's physical occupancy is fully in the past (its last job
        # just completed), so its shared-map entries cannot constrain anyone
        for phys in (self._phys_chip, self._phys_nic_ul, self._phys_nic_dl):
            for key in list(phys):
                phys[key].pop(epoch, None)
                if not phys[key]:
                    del phys[key]

    def _dispatch(self, now: float, action: Dispatch) -> None:
        pr = action.probe_result
        exec_id = None
        if self.faults is not None and self.faults.exec_fault_due():
            # injected transient stage-exec failure (deterministic from the
            # injector's seed): capacity back, then bounded retry
            reservation.cancel(pr)
            self._retry_batch(now, action)
            return
        if self.dispatcher is not None:
            tokens = self.token_fn(len(action.requests), self.seq_len)
            try:
                exec_id = self.dispatcher.submit(action, tokens)
            except Exception:  # noqa: BLE001 — executor died: return capacity
                reservation.cancel(pr)
                self._retry_batch(now, action)
                return
        # telemetry only for batches that actually execute
        depth_after = self.batcher.pending(action.pipeline.model_name)
        self.tel.dispatches.append(DispatchRecord(
            t_s=now,
            pipeline_id=action.pipeline.pipeline_id,
            batch_size=len(action.requests),
            planned_finish_s=pr.finish_time,
            oldest_deadline_s=min(r.deadline_s for r in action.requests),
            queue_len_after=depth_after,
            epoch=self.epoch,
        ))
        self.tel.queue_delay_s.extend(now - r.arrival_s for r in action.requests)
        job = _Job(
            job_id=next(self.job_ids),
            pipeline_id=action.pipeline.pipeline_id,
            requests=action.requests,
            probe=pr,
            exec_id=exec_id,
            pipeline=action.pipeline,
            epoch=self.epoch,
            dispatcher=self.dispatcher,
            fb=self.fb,
            clock=now,
        )
        self.jobs[job.job_id] = job
        self._epoch_inflight[self.epoch] = (
            self._epoch_inflight.get(self.epoch, 0) + 1)
        if self.obs is not None:
            self.obs.push((OP_DISPATCH, now, job.job_id, self.epoch,
                           action.pipeline.pipeline_id, action.requests,
                           depth_after, len(self.jobs), pr.finish_time,
                           self.batcher.total_pending()))
        self._start_stage(now, job)

    def _retry_batch(self, now: float, action: Dispatch) -> None:
        """Transient exec failure: bounded retry-with-hedging (DESIGN §13).

        Each failed request with budget left re-enters the EDF queue through
        the normal admission path — the next scheduling round re-probes
        EVERY pool, so the retry is hedged across pool members rather than
        pinned to the member that just failed (or is straggling).  Without
        an attached injector the budget is 0, reproducing the legacy
        fail-the-batch behaviour exactly.  Requests out of budget drop with
        the explicit ``exec_failure`` cause — never silently."""
        self.tel.exec_failures += 1  # per BATCH; drops are per request
        budget = self.faults.max_retries if self.faults is not None else 0
        readmit: list[Request] = []
        exhausted: list[Request] = []
        for r in action.requests:
            left = self._retry_left.get(r.req_id, budget)
            if left > 0:
                self._retry_left[r.req_id] = left - 1
                readmit.append(r)
            else:
                exhausted.append(r)
        if self.obs is not None:
            self.obs.on_retry_attempt(now, -1, action.pipeline.pipeline_id,
                                      len(action.requests), len(readmit))
        for r in exhausted:
            self._retry_left.pop(r.req_id, None)
            self.tel.retry_exhausted += 1
            if self.obs is not None:
                self.obs.on_retry_exhausted(now, r.req_id, budget + 1)
            self._drop(r, now, "exec_failure")
        if readmit:
            self.tel.retries += 1
            for r in readmit:
                self._admit(r, now)
            # a WAKE at `now` re-runs the scheduler once the current round's
            # actions finish — flat stack, and the retry budget bounds the
            # number of rounds even at exec_fault_rate 1.0
            model = action.pipeline.model_name
            cur = self._wakes.get(model)
            if cur is None or now < cur - 1e-9:
                self._wakes[model] = now
                self.push(now, self.WAKE, model)

    # ------------------------------------------------------- abrupt node loss
    def fail_host(self, accel_class: str, host_id: int | None = None,
                  now: float = 0.0) -> dict:
        """Spot-preempt one whole host of `accel_class` (DESIGN.md §13).

        `host_id` defaults to the class's tail host — the recommended target
        because `build_runtime` numbers chips sequentially per class, so
        losing the tail keeps every surviving chip's physical identity
        stable across the mandatory replan."""
        cluster = self.rt.cluster
        cph = cluster.chips_per_host if cluster is not None else 4
        n = cluster.counts.get(accel_class, 0) if cluster is not None else 0
        if host_id is None:
            host_id = max(n - 1, 0) // cph
        lost = {(accel_class, cid)
                for cid in range(host_id * cph, (host_id + 1) * cph)}
        return self.fail_chips(lost, now, accel_class=accel_class,
                               host_id=host_id)

    def fail_chips(self, lost, now: float, *, accel_class: str | None = None,
                   host_id: int | None = None) -> dict:
        """Abrupt loss of physical chips: cancel the in-flight batches that
        still need them, release their not-yet-run reservations, fire the
        mandatory-replan hooks, then re-admit each victim request iff the
        certified queue bound (`ModelQueue.completion_lb_s`, DESIGN §12)
        says its deadline is still reachable — otherwise it drops with the
        explicit ``node_loss`` cause.  Every in-flight request on the lost
        chips therefore resolves to exactly one outcome (no silent loss)."""
        lost = set(lost)
        affected = [
            job for job in self.jobs.values()
            if any((v.accel_class, v.chip_id) in lost
                   for v in job.probe.path[job.stage_idx:])
        ]
        victims: list[Request] = []
        epochs: set[int] = set()
        for job in affected:
            self._release_unstarted(job)
            del self.jobs[job.job_id]
            self._epoch_inflight[job.epoch] = (
                self._epoch_inflight.get(job.epoch, 1) - 1)
            epochs.add(job.epoch)
            victims.extend(job.requests)
        for epoch in sorted(epochs):
            self._maybe_gc_epoch(epoch)
        # the dead chips' physical identity must not throttle whatever the
        # replanned epoch maps onto their ids (tail-stable renumbering)
        for key in sorted(lost):
            self._phys_chip.pop(key, None)
            self._slowdowns.pop(key, None)
        if accel_class is not None and host_id is not None:
            self._phys_nic_ul.pop((accel_class, host_id), None)
            self._phys_nic_dl.pop((accel_class, host_id), None)
        self.tel.node_losses += 1
        for hook in list(self.loss_hooks):
            hook(now, accel_class, host_id, lost)
        readmitted = dropped = 0
        models: list[str] = []
        for req in victims:
            q = self.batcher.queues.by_model.get(req.model_name)
            if q is not None and \
                    q.completion_lb_s(len(q), now) <= req.deadline_s + 1e-9:
                self._admit(req, now)
                readmitted += 1
                if req.model_name not in models:
                    models.append(req.model_name)
            else:
                self._drop(req, now, "node_loss")
                dropped += 1
        for m in models:
            self._run_scheduler(m, now)
        if self.obs is not None:
            self.obs.on_pool_drain(
                now, accel_class if accel_class is not None else "*",
                host_id if host_id is not None else -1,
                len(affected), readmitted, dropped)
        return {"inflight_failed": len(affected),
                "readmitted": readmitted, "dropped": dropped}

    @staticmethod
    def _release_unstarted(job: _Job) -> None:
        """Release the planned reservations a cancelled job never used.

        Only not-yet-started work may be released: started stages/transfers
        had their planned intervals replaced by actuals (Timeline.correct),
        and releasing the actual region of work that already ran would
        double-book the surviving resource under it.  Reservation order per
        stage is [ul, dl,] gpu (core.reservation.probe), so the stage
        counter advances on each "gpu" record; a transfer into stage k ran
        iff ``stage_idx`` already reached k (it is corrected synchronously
        in `_on_stage_done`)."""
        si = 0
        for r in job.probe.reservations:
            if r.kind == "gpu":
                if si > job.started:
                    r.resource.release(r.start, r.dur)
                si += 1
            elif si > job.stage_idx:  # ul/dl of the transfer INTO stage si
                r.resource.release(r.start, r.dur)

    def set_chip_slowdown(self, accel_class: str, chip_id: int | None,
                          factor: float) -> None:
        """Mark physical chips as stragglers: actual stage durations on them
        are multiplied by `factor` (>= 1); `chip_id` None hits every chip of
        the class, factor 1.0 clears.  The slip is visible to the scheduler
        the same way measured-feedback slip is — via Timeline.correct and
        the cross-epoch free maps — so subsequent probes route around the
        straggler (the pool-level hedge PPipe's probe() gives for free)."""
        if chip_id is not None:
            chips = [chip_id]
        else:
            cluster = self.rt.cluster
            chips = range(cluster.counts.get(accel_class, 0)
                          if cluster is not None else 0)
        for cid in chips:
            key = (accel_class, cid)
            if factor == 1.0:
                self._slowdowns.pop(key, None)
            else:
                self._slowdowns[key] = factor

    # -------------------------------------------------------------- execution
    def _stage_dur(self, job: _Job, k: int) -> float:
        """Virtual duration of stage k: planned, or calibrated-measured when
        real execution feeds back (the data-plane analogue of sim noise)."""
        planned = job.probe.stage_durs[k]
        if self.feedback != "measured" or job.exec_id is None:
            return planned
        wall = job.dispatcher.poll_stage(job.exec_id, k)
        dur = job.fb.observe(job.pipeline_id, k, planned, wall)
        if job.fb.adapt_latency:
            self.batcher.refresh_min_service()
        return dur

    def _start_stage(self, now: float, job: _Job) -> None:
        k = job.stage_idx
        gpu = job.probe.path[k]
        planned_start = job.probe.stage_starts[k]
        planned_dur = job.probe.stage_durs[k]
        start = max(planned_start, job.clock,
                    self.vdev_virtual_free[(job.epoch, gpu.vdev_id)])
        chip = (gpu.accel_class, gpu.chip_id)
        if self.cross_epoch_coupling:
            # exact cross-epoch exclusion: the physical chip may still be
            # running (or already booked by) another plan epoch — including
            # slip past that epoch's reservations, which the swap-time seed
            # alone cannot see
            start = max(start, self._phys_wait(self._phys_chip, chip,
                                               job.epoch))
        dur = self._stage_dur(job, k)
        if self._slowdowns:
            # straggler chip (fault injection): the actual duration slips
            # past the reservation, exactly like measured-feedback slip
            dur *= self._slowdowns.get(chip, 1.0)
        job.started = k
        self.vdev_virtual_free[(job.epoch, gpu.vdev_id)] = start + dur
        self._phys_note(self._phys_chip, chip, job.epoch, start + dur)
        gpu.busy_s += dur
        gpu.timeline.correct(planned_start, planned_dur, start, dur)
        if self.obs is not None:
            self.obs.push((OP_STAGE, job.job_id, job.epoch, job.pipeline_id,
                           k, gpu.accel_class, gpu.chip_id, gpu.vdev_id,
                           start, dur, len(job.requests)))
        self.push(start + dur, self.STAGE_DONE, (job.job_id, start, dur))

    def _on_stage_done(self, t: float, payload: tuple) -> None:
        job_id, _, _ = payload
        job = self.jobs.get(job_id)
        if job is None:
            return  # batch cancelled by node loss; its heap events are stale
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
        ul_key = (src.node.accel_class, src.node.host_id)
        dl_key = (dst.node.accel_class, dst.node.host_id)
        start = max(
            planned_start,
            t,
            self.nic_ul_free[(job.epoch, src.node.node_id)],
            self.nic_dl_free[(job.epoch, dst.node.node_id)],
        )
        if self.cross_epoch_coupling:
            start = max(start,
                        self._phys_wait(self._phys_nic_ul, ul_key, job.epoch),
                        self._phys_wait(self._phys_nic_dl, dl_key, job.epoch))
        src.node.uplink.correct(planned_start, planned_dur, start, dur)
        dst.node.downlink.correct(planned_start, planned_dur, start, dur)
        self.nic_ul_free[(job.epoch, src.node.node_id)] = start + dur
        self.nic_dl_free[(job.epoch, dst.node.node_id)] = start + dur
        self._phys_note(self._phys_nic_ul, ul_key, job.epoch, start + dur)
        self._phys_note(self._phys_nic_dl, dl_key, job.epoch, start + dur)
        if self.obs is not None:
            self.obs.push((OP_XFER, job.job_id, job.epoch, ul_key, dl_key,
                           start, dur))
        self.push(start + dur, self.XFER_DONE, job_id)

    def _on_xfer_done(self, t: float, job_id: int) -> None:
        job = self.jobs.get(job_id)
        if job is None:
            return  # batch cancelled by node loss; its heap events are stale
        job.clock = t
        self._start_stage(t, job)

    def _complete(self, job: _Job, t: float) -> None:
        if self._retry_left:
            for req in job.requests:
                self._retry_left.pop(req.req_id, None)
        for req in job.requests:
            self.tel.outcomes.append(RequestOutcome(
                req_id=req.req_id,
                arrival_s=req.arrival_s,
                deadline_s=req.deadline_s,
                completion_s=t,
                pipeline_id=job.pipeline_id,
            ))
            if self.obs is not None:
                self.obs.push((OP_COMPLETE, t, req, job.job_id))
        del self.jobs[job.job_id]
        self._epoch_inflight[job.epoch] = (
            self._epoch_inflight.get(job.epoch, 1) - 1)
        self._maybe_gc_epoch(job.epoch)

    # per-request drop counters; exec_failure stays a per-BATCH counter at
    # its call site, so it is deliberately absent here
    _DROP_COUNTERS = {
        "admission_reject": "admission_rejects",
        "backpressure_reject": "backpressure_rejects",
        "overflow_shed": "overflow_sheds",
        "expired": "expiry_drops",
        "scheduler": "sched_drops",
        "node_loss": "node_loss_drops",
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
        if self.obs is not None:
            self.obs.push((OP_DROP, now, req, cause))

    # -------------------------------------------------------------- wall side
    def _harvest_dispatcher(self, disp: PoolDispatcher) -> None:
        disp.drain_all()
        for c in disp.take_completed():
            self.tel.batch_wall_s.append(c.total_wall_s)
            for si, w in enumerate(c.stage_wall_s):
                # keyed by the epoch the batch was SUBMITTED under (stamped
                # by the dispatcher — _install_runtime keeps current_epoch
                # in sync, so this is exact even when one dispatcher serves
                # several epochs): pipeline ids restart at 0 after a swap,
                # and stage walls of unrelated partitions must not blend
                # into one percentile bucket
                self.tel.stage_wall_s.setdefault(
                    (c.epoch, c.pipeline_id, si), []).append(w)
        self.tel.inflight_hwm = max(self.tel.inflight_hwm, disp.inflight_hwm)

    def _harvest_measurements(self) -> None:
        # dispatchers of GC'd epochs were harvested at retire time; this
        # covers surviving retired epochs (epoch_gc off) + the live one
        for disp in (*self._retired_dispatchers.values(), self.dispatcher):
            if disp is None:
                continue
            self._harvest_dispatcher(disp)


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
    """Wait for the current stream, where the stages run (never the whole
    device: that is refused while a background warm captures a graph)."""
    if x.is_cuda:
        torch.cuda.current_stream(x.device).synchronize()


def calibrate_runtime(runtime: ClusterRuntime, executors_by_pipeline,
                      seq_len: int, batch_sizes=None, reps: int = 2,
                      token_fn=None) -> dict:
    """Offline profiling pass (the paper's section 5.1 profiler, for real):
    measure each stage at each batch size and overwrite the analytic
    latency tables with measured wall seconds, so the scheduler's virtual
    clock *is* the wall clock and SLOs/deadlines become physically meaningful.
    Each stage is timed between two synchronisations of its stream.

    A stage's table keeps no batch slower than a larger one: where the
    stage costs about the same at every batch size (launch- and host-bound
    stages), timing noise would otherwise price a short batch above a full
    one, and Algorithm 1's last-moment dispatch of a short batch, planned
    at the full batch's latency, would then miss the deadline it waited
    for and drop its requests.

    Returns {(pipeline_id, stage_idx, batch): seconds} as measured, for
    reporting.
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
            table, cap = {}, float("inf")
            for bs in sorted(per_stage[si], reverse=True):
                cap = table[bs] = min(cap, per_stage[si][bs])
            stage.latency_by_batch = dict(sorted(table.items()))
            stage.lat_scale = 1.0
            for bs, dt in per_stage[si].items():
                measured[(p.pipeline_id, si, bs)] = dt
        # re-decide whether the batch-size bisection stays decision-safe
        reservation.validate_bisection(p)
    return measured
