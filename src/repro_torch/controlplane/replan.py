"""Online re-planning: workload-drift detection + periodic re-solve + hot swap.

The paper runs its MILP "periodically as the workload mix and rates shift"
(sections 5, 6) — the slow cadence of the two-cadence system.  This module
closes that loop over the live data plane:

* `DriftMonitor` — sliding-window rate/mix estimators over the arrival
  stream (the same stream `dataplane.metrics` attributes outcomes to);
* `ReplanLoop`   — registered as a DataPlane arrival hook; every
  `check_interval_s` of virtual time it compares the current window against
  the baseline the active plan was solved for and, past the drift
  thresholds, re-solves through the `Planner` facade (optionally at measured
  `ProfileStore` speed) and installs the result via
  `DataPlane.swap_plan` — in-flight batches finish on the old pools;
* `ReplanPolicy` — the governance layer between the two: a cost/benefit
  gate (estimated goodput gain vs. solver wall time + measured swap
  transient) with a cooldown window and an oscillation damper, so the
  paper's assumption that plan installs are rare, bounded-cost events
  survives adversarial (oscillating) workloads.  Accept/reject decisions
  land in `Telemetry.replan_decisions`.

Everything runs on the data plane's virtual clock, so the loop behaves
identically under simulation replay and real serving — with one deliberate
exception: the `ReplanPolicy` gate prices solver *wall* time, which matches
the virtual axis only on a calibrated runtime; pin it (`cost_ewma=0`) when
replay determinism matters (see the PolicyConfig axis caveat).
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from typing import TYPE_CHECKING

import numpy as np
from scipy.optimize import linprog

from repro_torch.core.plan import ClusterPlan
from repro_torch.core.types import ClusterSpec

from .planner import Objective, Planner
from .profiles import ProfileStore

if TYPE_CHECKING:  # avoid importing the data plane (and torch) at module load
    from repro_torch.dataplane.plane import DataPlane


@dataclass(frozen=True)
class ReplanConfig:
    """Cadence of the slow control loop.

    Deliberately carries NO drift-sensitivity knobs (ROADMAP "adaptive
    drift thresholds", closed): tripping is hair-trigger by design — the
    internal `_RATE_TRIP`/`_MIX_TRIP` floors exist only to filter
    estimation noise — because the accept/reject decision belongs to the
    `ReplanPolicy` cost/benefit gate, not to static thresholds an operator
    would have to re-tune per workload.  An ungated loop (policy=None)
    therefore re-solves on every noticeable shift: that is the
    always-replan upper bound the benchmarks compare the gate against.
    """

    window_s: float = 2.0  # sliding estimation window (virtual seconds)
    check_interval_s: float = 0.5  # min spacing between drift checks
    min_requests: int = 16  # don't estimate from thin air
    source: str = "analytic"  # which ProfileStore tables price the re-solve
    max_swaps: int | None = None  # safety bound (None = unbounded)
    max_failures: int = 8  # disarm the loop after this many failed re-plans


# Internal drift-trip floors: just above sliding-window estimation noise, far
# below anything worth hand-tuning.  Tripping is cheap (consider() runs no
# solver); the ReplanPolicy gate prices every trip, so these are NOT part of
# the config surface — loosen/tighten here only if the estimators change.
_RATE_TRIP = 0.2  # relative total-rate change that trips a check
_MIX_TRIP = 0.1  # total-variation distance of the model mix that trips


class DriftMonitor:
    """Sliding-window arrival-rate and model-mix estimators."""

    def __init__(self, window_s: float = 2.0) -> None:
        self.window_s = window_s
        self._arrivals: deque[tuple[float, str]] = deque()
        self._start: float | None = None  # first observation ever

    def observe(self, model: str, t: float) -> None:
        if self._start is None:
            self._start = t
        self._arrivals.append((t, model))
        self._evict(t)

    def _evict(self, now: float) -> None:
        w = self._arrivals
        while w and w[0][0] < now - self.window_s:
            w.popleft()

    def count(self, now: float) -> int:
        self._evict(now)
        return len(self._arrivals)

    def _effective_window(self, now: float) -> float:
        """The stretch of time the window actually covers.  Early in a run
        (now - first arrival < window_s) dividing by the full window would
        underestimate rates ~2x and fake a rate drop, so use elapsed time."""
        if self._start is None:
            return self.window_s
        return max(min(self.window_s, now - self._start), 1e-9)

    def rates(self, now: float) -> dict[str, float]:
        """Per-model arrival rate (rps) over the window."""
        self._evict(now)
        eff = self._effective_window(now)
        counts: dict[str, int] = {}
        for _, m in self._arrivals:
            counts[m] = counts.get(m, 0) + 1
        return {m: c / eff for m, c in counts.items()}

    def mix(self, now: float) -> dict[str, float]:
        """Normalized model mix over the window (sums to 1 when non-empty)."""
        rates = self.rates(now)
        total = sum(rates.values())
        if total <= 0:
            return {}
        return {m: r / total for m, r in rates.items()}


def mix_distance(a: dict[str, float], b: dict[str, float]) -> float:
    """Total-variation distance between two model mixes (0..1)."""
    keys = set(a) | set(b)
    return 0.5 * sum(abs(a.get(k, 0.0) - b.get(k, 0.0)) for k in keys)


@dataclass
class ReplanEvent:
    t_s: float
    rates: dict[str, float]
    weights: dict[str, float]
    throughput_rps: float


def estimate_benefit_scalar(rates: dict[str, float], plan: ClusterPlan,
                            store: ProfileStore,
                            source: str = "analytic") -> float:
    """The legacy fungible-capacity benefit estimate (one best-case
    `request_cost` exchange rate; capacity is a single pool).

    Kept as the comparison baseline for the per-class estimator the policy
    gate now uses: on heterogeneous mixes this prices every model at its
    *best* class and pools all classes together, so it over-credits
    re-solves whenever the shared best class is the scarce one (see
    `ReplanPolicy.estimate_benefit`).
    """
    total = sum(rates.values())
    if total <= 0:
        return 0.0
    models = sorted(set(store.profiles) | set(rates))
    costs = {m: store.request_cost(m, source) for m in models
             if m in store.profiles}
    attain_now = sum(min(rates.get(m, 0.0), plan.throughput_of(m))
                     for m in models)
    capacity = sum(plan.throughput_of(m) * costs.get(m, 0.0)
                   for m in models)
    unit = sum((rates.get(m, 0.0) / total) * costs.get(m, 0.0)
               for m in models)
    if unit <= 0.0 or capacity <= 0.0:
        return 0.0
    candidate = min(total, capacity / unit)
    return max(0.0, candidate - attain_now)


# ---------------------------------------------------------------------------
# Replan governance: the cost/benefit gate + hysteresis (ROADMAP item)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class PolicyConfig:
    """Knobs of the replan cost/benefit gate and its hysteresis.

    The gate accepts a drift-triggered re-solve only when the estimated
    goodput gain pays for the disruption:

        benefit_rps  >  max(min_gain_rps,
                            gain_cost_ratio * cost_s * rate_rps / amortize_s)

    where `cost_s` is the EWMA'd solver wall time plus the EWMA'd measured
    swap transient (virtual seconds the new epoch inherits as residual
    occupancy) — i.e. a swap must win back, over `amortize_s`, at least the
    requests it puts at risk while the solver runs and the pools drain.
    After every accepted swap a cooldown of

        cooldown_s + damper_stretch_s * flip_score

    suppresses further solves.  The base `cooldown_s` is a churn guard only
    (a genuine shift may legitimately want a quick refinement re-solve once
    the post-flip window is clean); the real hysteresis is the additive
    stretch: `flip_score` is an EWMA (weight `damper_alpha`) of a per-swap
    oscillation indicator — 1 when the swap returned to the mix the
    *previous* swap moved away from — so a workload that keeps bouncing
    A->B->A->B stretches its own cooldown toward
    `cooldown_s + damper_stretch_s` instead of thrashing plans, while a
    genuine sustained shift decays the score back and re-plans at the base
    cadence.

    Axis caveat: the swap transient is virtual seconds, but the solver wall
    is wall-clock — the two coincide exactly only on a calibrated runtime
    (where virtual time IS wall time).  In pure simulation replay the wall
    component makes gate verdicts host-speed dependent; pin it for
    deterministic replay with `cost_ewma=0` + a fixed `solver_wall_init_s`
    (what the benchmarks do).
    """

    cooldown_s: float = 0.5  # base spacing between accepted swaps (virtual s)
    amortize_s: float = 4.0  # horizon over which a swap must pay off
    gain_cost_ratio: float = 1.0  # required benefit per unit of priced cost
    min_gain_rps: float = 0.0  # absolute goodput-gain floor
    damper_alpha: float = 0.5  # EWMA weight of the oscillation indicator
    damper_stretch_s: float = 4.0  # extra cooldown at flip_score == 1
    solver_wall_init_s: float = 0.05  # cost prior before any solve was timed
    cost_ewma: float = 0.5  # EWMA weight for solver-wall/transient updates


@dataclass
class ReplanDecision:
    """One considered re-solve — accepted or not, it is a control action."""

    t_s: float
    accepted: bool
    reason: str
    benefit_rps: float = 0.0
    required_rps: float = 0.0
    cost_s: float = 0.0
    flip_score: float = 0.0
    cooldown_until_s: float = float("-inf")

    def as_dict(self) -> dict:
        return {
            "t_s": self.t_s,
            "accepted": self.accepted,
            "reason": self.reason,
            "benefit_rps": self.benefit_rps,
            "required_rps": self.required_rps,
            "cost_s": self.cost_s,
            "flip_score": self.flip_score,
            # None (not -inf) before the first swap: keeps telemetry dumps
            # strict-JSON safe
            "cooldown_until_s": (None if self.cooldown_until_s == float("-inf")
                                 else self.cooldown_until_s),
        }


class ReplanPolicy:
    """Cost/benefit gate + hysteresis between drift detection and the solver.

    `consider()` is cheap (no solver call): it estimates what a re-solve at
    the observed mix could buy and compares that against the priced cost of
    getting there.  The benefit estimate converts the current plan's
    per-model throughput into fungible capacity units via
    `ProfileStore.request_cost` (best-case chip-seconds per request), assumes
    a re-solve can redistribute those units to match the observed mix, and
    takes the goodput delta over what the current plan already attains — an
    optimistic estimate by construction, which errs on the side of letting
    the exact solver decide, while still zeroing out re-solves for mixes the
    current plan serves fine.

    State transitions happen only on `notify_swap` (accepted + installed) and
    never on failed solves — `notify_failure` leaves the cooldown and damper
    untouched, so one failed event cannot suppress or double-count the next.
    """

    def __init__(self, config: PolicyConfig | None = None) -> None:
        self.config = config or PolicyConfig()
        self.decisions: list[ReplanDecision] = []
        self.flip_score = 0.0
        self.solver_wall_s = self.config.solver_wall_init_s
        self.transient_s = 0.0
        self.failures = 0
        self._cooldown_until = float("-inf")
        self._prev_mix: dict[str, float] | None = None  # mix before last swap
        # cooldown window whose rejection is already on record: consider()
        # returns the recorded decision instead of appending a duplicate,
        # so a drift that stays tripped produces one decision per window,
        # not one per check (bounded telemetry on long traces)
        self._reject_logged_until = float("-inf")

    @property
    def cooldown_until(self) -> float:
        return self._cooldown_until

    # ------------------------------------------------------------- estimate
    def estimate_benefit(self, rates: dict[str, float], plan: ClusterPlan,
                         store: ProfileStore, source: str = "analytic") -> float:
        """Goodput (rps) a mix-matched re-solve could add over the current
        plan, pricing capacity as per-CLASS pools instead of one fungible
        exchange rate.

        A small transportation LP: maximize mix-matched goodput G subject to
        every model m drawing its share `G * s_m` from per-class allocations
        `x_mk` that fit the cluster's per-class chip inventory at the
        `request_cost_by_class` rates,

            max G   s.t.  sum_k x_mk = G * s_m          (each model m)
                          sum_m r_mk * x_mk <= C_k      (each class k)
                          x >= 0,  0 <= G <= total.

        Still optimistic by construction (no partitioning/SLO/transfer
        structure, so the exact solver gets the final word), but it no
        longer prices every model at its best class against one pooled
        capacity: when the mix piles onto models whose only fast class is
        the scarce one, the class constraint caps G where the scalar
        estimator would over-credit the re-solve and open the gate for
        nothing.  Falls back to the scalar estimate if the LP solver bails.
        """
        total = sum(rates.values())
        if total <= 0:
            return 0.0
        models = sorted(set(store.profiles) | set(rates))
        # per-class chip-seconds/request; unprofiled-but-requested models
        # price as free (same optimism as the scalar estimator)
        costs = {m: store.request_cost_by_class(m, source) for m in models
                 if m in store.profiles}
        attain_now = sum(min(rates.get(m, 0.0), plan.throughput_of(m))
                         for m in models)
        classes = list(plan.cluster.classes)
        cap = [float(plan.cluster.counts[k]) for k in classes]
        if not costs or not any(c > 0 for c in cap):
            return 0.0
        n_m, n_k = len(models), len(classes)
        # variables: [G, x_00 .. x_{m-1,k-1}] (model-major)
        c = np.zeros(1 + n_m * n_k)
        c[0] = -1.0
        a_eq = np.zeros((n_m, 1 + n_m * n_k))
        for i, m in enumerate(models):
            a_eq[i, 0] = -rates.get(m, 0.0) / total
            a_eq[i, 1 + i * n_k: 1 + (i + 1) * n_k] = 1.0
        a_ub = np.zeros((n_k, 1 + n_m * n_k))
        for i, m in enumerate(models):
            r = costs.get(m, {})
            for j, k in enumerate(classes):
                a_ub[j, 1 + i * n_k + j] = r.get(k, 0.0)
        res = linprog(
            c, A_ub=a_ub, b_ub=cap, A_eq=a_eq, b_eq=np.zeros(n_m),
            bounds=[(0.0, total)] + [(0.0, None)] * (n_m * n_k),
            method="highs",
        )
        if res.status != 0 or res.x is None:
            return estimate_benefit_scalar(rates, plan, store, source)
        return max(0.0, float(res.x[0]) - attain_now)

    # ------------------------------------------------------------- decision
    def consider(self, now: float, rates: dict[str, float], plan: ClusterPlan,
                 store: ProfileStore, source: str = "analytic") -> ReplanDecision:
        """Gate one drift trip.  Returns the decision; appends it to
        `decisions` unless it merely repeats the current window's recorded
        rejection (callers can detect a fresh decision by list growth)."""
        cfg = self.config
        if now < self._cooldown_until:
            if self._cooldown_until <= self._reject_logged_until:
                return self.decisions[-1]  # this window is already on record
            d = ReplanDecision(
                t_s=now, accepted=False, reason="cooldown",
                flip_score=self.flip_score,
                cooldown_until_s=self._cooldown_until,
            )
            self.decisions.append(d)
            self._reject_logged_until = self._cooldown_until
            return d
        total = sum(rates.values())
        benefit = self.estimate_benefit(rates, plan, store, source)
        cost_s = self.solver_wall_s + self.transient_s
        required = max(cfg.min_gain_rps,
                       cfg.gain_cost_ratio * cost_s * total / cfg.amortize_s)
        accepted = benefit > required
        d = ReplanDecision(
            t_s=now, accepted=accepted,
            reason="gain" if accepted else "marginal",
            benefit_rps=benefit, required_rps=required, cost_s=cost_s,
            flip_score=self.flip_score, cooldown_until_s=self._cooldown_until,
        )
        self.decisions.append(d)
        if not accepted:
            # not-worth-it drift: hold off re-pricing for one base cooldown
            # (no damper).  The drift stays *pending* — a later, cleaner
            # window may legitimately price the same shift profitable (e.g.
            # right after a flip the estimation window still blends the old
            # mix) — but it is re-priced at cooldown cadence, not every
            # check, so a permanently-marginal workload cannot spam the
            # solver gate or the decision log.
            self._cooldown_until = max(self._cooldown_until,
                                       now + cfg.cooldown_s)
            self._reject_logged_until = self._cooldown_until
        return d

    # ------------------------------------------------------------ feedback
    def notify_swap(self, now: float, old_mix: dict[str, float],
                    new_mix: dict[str, float], solver_wall_s: float,
                    transient_s: float) -> None:
        """An accepted re-solve was installed: fold the measured costs into
        the EWMAs, update the oscillation damper, open the cooldown."""
        cfg = self.config
        a = cfg.cost_ewma
        self.solver_wall_s += a * (max(solver_wall_s, 0.0) - self.solver_wall_s)
        self.transient_s += a * (max(transient_s, 0.0) - self.transient_s)
        flip = 0.0
        if self._prev_mix is not None:
            # the swap moved the plan *back* toward the mix the previous
            # swap abandoned: that is one oscillation period
            if mix_distance(new_mix, self._prev_mix) < \
                    mix_distance(new_mix, old_mix) - 1e-12:
                flip = 1.0
        self.flip_score += cfg.damper_alpha * (flip - self.flip_score)
        self._prev_mix = dict(old_mix)
        self._cooldown_until = now + cfg.cooldown_s + (
            cfg.damper_stretch_s * self.flip_score)

    def notify_failure(self, now: float) -> None:
        """A gated-through re-solve failed downstream (solver exception or
        infeasible).  Deliberately does NOT touch the cooldown, the damper or
        the cost EWMAs: the failure is the ReplanLoop's event to count
        (exactly once), and a failed solve must neither extend nor reset the
        hysteresis window of the next genuine one."""
        self.failures += 1

    def record_mandatory(self, now: float, reason: str) -> ReplanDecision:
        """A topology-loss replan is *mandatory*: the live plan references
        hardware that no longer exists, so feasibility — not benefit — is at
        stake.  Records an accepted decision WITHOUT consulting or touching
        the benefit gate, the cooldown or the oscillation damper: a holdoff
        opened by an earlier rejected drift (or a recent swap's stretched
        cooldown) must never defer restoring feasibility."""
        d = ReplanDecision(
            t_s=now, accepted=True, reason=f"mandatory:{reason}",
            flip_score=self.flip_score,
            cooldown_until_s=self._cooldown_until,
        )
        self.decisions.append(d)
        # the window-rejection dedup keys off decisions[-1]; a mandatory
        # record in between must not be replayed as that cached rejection
        self._reject_logged_until = float("-inf")
        return d


@dataclass
class ReplanLoop:
    """The slow half of the two-cadence system, wired to a live DataPlane."""

    planner: Planner
    store: ProfileStore
    cluster: ClusterSpec
    dataplane: "DataPlane"
    config: ReplanConfig = field(default_factory=ReplanConfig)
    objective: Objective | None = None
    dispatcher_factory: object = None  # factory(new_runtime) -> PoolDispatcher
    # setup(new_runtime) hook run by swap_plan BEFORE carried requests are
    # re-admitted.  None = the source-based default (reprice_runtime when
    # re-solves are priced from measured tables); a calibrated real
    # deployment overrides this with its re-calibration closure
    # (repro_torch.api.Session wires that automatically)
    runtime_setup: object = None
    # cost/benefit gate + hysteresis between drift and the solver; None keeps
    # the ungated re-solve-on-every-trip behaviour (benchmarks compare both)
    policy: ReplanPolicy | None = None
    events: list[ReplanEvent] = field(default_factory=list)

    def __post_init__(self) -> None:
        self.monitor = DriftMonitor(self.config.window_s)
        self._last_check = float("-inf")
        self._baseline_rate: float | None = None
        self._baseline_mix: dict[str, float] = {}
        self.objective = self.objective or self.planner.objective
        self.failed_replans: list[tuple[float, str]] = []  # full failure log
        self._consecutive_failures = 0  # resets on every successful swap

    # ---------------------------------------------------------------- wiring
    def attach(self) -> "ReplanLoop":
        """Register on the data plane's arrival stream (drift cadence) and
        its node-loss hooks (mandatory replans); returns self."""
        self.dataplane.arrival_hooks.append(self.on_arrival)
        self.dataplane.loss_hooks.append(self.on_node_loss)
        return self

    def set_baseline(self, rates: dict[str, float]) -> None:
        """Pin the workload the *current* plan was solved for."""
        total = sum(rates.values())
        self._baseline_rate = total
        self._baseline_mix = (
            {m: r / total for m, r in rates.items()} if total > 0 else {}
        )

    def on_arrival(self, req, now: float) -> None:
        self.monitor.observe(req.model_name, now)
        self.maybe_replan(now)

    # ----------------------------------------------------------------- logic
    def drifted(self, now: float) -> bool:
        if self.monitor.count(now) < self.config.min_requests:
            return False
        rates = self.monitor.rates(now)
        total = sum(rates.values())
        if self._baseline_rate is None:
            # first full window: adopt it as the baseline, no re-solve
            self.set_baseline(rates)
            return False
        rate_rel = abs(total - self._baseline_rate) / max(self._baseline_rate, 1e-9)
        mix_tv = mix_distance(self.monitor.mix(now), self._baseline_mix)
        tripped = rate_rel > _RATE_TRIP or mix_tv > _MIX_TRIP
        obs = getattr(self.dataplane, "obs", None)
        if obs is not None:
            obs.on_drift(now, rate_rel, mix_tv, tripped)
        return tripped

    def maybe_replan(self, now: float) -> ClusterPlan | None:
        """Drift check at the configured cadence; past the thresholds, the
        policy gate (when present) prices the candidate re-solve and only a
        positive verdict reaches the solver + hot-swap."""
        if now - self._last_check < self.config.check_interval_s:
            return None
        self._last_check = now
        if self.config.max_swaps is not None and len(self.events) >= self.config.max_swaps:
            return None
        if self._consecutive_failures >= self.config.max_failures:
            return None  # circuit breaker: something is persistently wrong
        if not self.drifted(now):
            return None
        if self.policy is not None:
            n0 = len(self.policy.decisions)
            decision = self.policy.consider(
                now, self.monitor.rates(now), self.dataplane.rt.plan,
                self.store, source=self.config.source,
            )
            if len(self.policy.decisions) > n0:  # fresh, not a window repeat
                self.dataplane.tel.replan_decisions.append(decision.as_dict())
                obs = getattr(self.dataplane, "obs", None)
                if obs is not None:
                    obs.on_replan_decision(now, decision.as_dict())
            if not decision.accepted:
                # the baseline is NOT adopted: the drift stays pending so a
                # later (possibly cleaner) window can re-price it — the
                # policy's holdoff bounds how often that happens
                return None
        return self.replan(now)

    # ------------------------------------------------------- mandatory path
    def on_node_loss(self, now: float, accel_class, host_id, lost) -> None:
        """DataPlane loss hook: shrink the planning inventory by the lost
        chips and force a mandatory replan before the victims re-admit."""
        counts = dict(self.cluster.counts)
        for cname in sorted({c for c, _ in lost}):
            n_lost = sum(1 for c, cid in lost
                         if c == cname and cid < counts.get(cname, 0))
            if n_lost:
                left = counts[cname] - n_lost
                if left > 0:
                    counts[cname] = left
                else:
                    counts.pop(cname, None)
        self.force_replan(now, reason="node_loss", cluster=ClusterSpec(
            counts=counts, chips_per_host=self.cluster.chips_per_host,
            nic_derate=self.cluster.nic_derate))

    def force_replan(self, now: float, *, reason: str = "node_loss",
                     cluster: ClusterSpec | None = None) -> ClusterPlan | None:
        """Mandatory replan: the live plan references hardware that no
        longer exists (or the topology changed under it), so feasibility —
        not benefit — is at stake.  Bypasses the drift check, the policy's
        benefit gate, the cooldown and the oscillation damper, and also the
        max_swaps / consecutive-failure circuit breakers: serving cannot
        continue on the old plan, so deferring is never the right call."""
        if cluster is not None:
            self.cluster = cluster
        if self.policy is not None:
            decision = self.policy.record_mandatory(now, reason)
            self.dataplane.tel.replan_decisions.append(decision.as_dict())
            obs = getattr(self.dataplane, "obs", None)
            if obs is not None:
                obs.on_replan_decision(now, decision.as_dict())
        return self.replan(now, reason=f"{reason}@{now:.3f}s",
                           mandatory=True)

    def replan(self, now: float, *, reason: str | None = None,
               mandatory: bool = False) -> ClusterPlan | None:
        """Unconditional re-solve at the observed mix, then swap_plan.

        A control-loop failure must never take the serving loop down: any
        exception from the solver or the swap (solver timeout with no
        incumbent, invalid plan, missing dispatcher_factory in measured
        mode) is recorded in `failed_replans` and the old plan keeps
        serving.
        """
        rates = self.monitor.rates(now)
        old_mix = dict(self._baseline_mix)
        profiles = dict(self.store.profiles)
        weights = {m: max(rates.get(m, 0.0), 1e-6) for m in profiles}
        # measured source: re-price the fresh runtime BEFORE any carried
        # request is re-admitted/scheduled, so probe()/reserve() agree with
        # the solve from the first post-swap round.  An explicit
        # runtime_setup (e.g. a real deployment's re-calibration closure)
        # supersedes the repricing default — calibration measures the same
        # speeds repricing would only estimate.
        setup = self.runtime_setup or (
            self.store.reprice_runtime
            if self.config.source == "measured" else None)
        obs = getattr(self.dataplane, "obs", None)
        # warm start: the live plan is a feasible point of the new solve
        # whenever the drift was workload-only, so the solver prices the
        # re-solve as a perturbation (template cache + priority columns +
        # objective cutoff) instead of from scratch — keeping the wall the
        # policy's cost EWMA learns honestly small.  But an incumbent that
        # over-allocates the (possibly shrunk) cluster would hand the solver
        # an unattainable objective cutoff, so it is only passed when it
        # still fits the current inventory.
        incumbent = self.dataplane.rt.plan
        if incumbent is not None and not all(
                incumbent.cluster.counts.get(c, 0)
                <= self.cluster.counts.get(c, 0)
                for c in incumbent.cluster.counts):
            incumbent = None
        try:
            plan = self.planner.plan(
                profiles,
                self.store.tables(self.config.source),
                self.cluster,
                objective=self.objective.with_weights(weights),
                incumbent=incumbent,
            )
            if not plan.pipelines:
                # Infeasible at this workload: keep the old plan, but adopt
                # the baseline and count the failure — otherwise the same
                # drift re-runs the full solver every check_interval_s.
                # Exactly one failure per event; the policy's hysteresis
                # state is deliberately left alone (see notify_failure).
                self.failed_replans.append((now, "infeasible: empty plan"))
                self._consecutive_failures += 1
                if obs is not None:
                    obs.on_replan_failure(now, "infeasible: empty plan")
                if self.policy is not None:
                    self.policy.notify_failure(now)
                self.set_baseline(rates)
                return None
            self.dataplane.swap_plan(
                plan, profiles, now,
                dispatcher_factory=self.dispatcher_factory,
                runtime_setup=setup,
                slo_margin=self.objective.slo_margin,
                reason=reason or f"drift@{now:.3f}s",
            )
        except Exception as exc:  # noqa: BLE001 — keep serving the old plan
            # Adopt the observed workload as the new baseline anyway: a
            # deterministic failure (e.g. mis-wired dispatcher_factory) must
            # not re-trip the same drift and re-run the solver every check.
            self.failed_replans.append((now, repr(exc)))
            self._consecutive_failures += 1
            if obs is not None:
                obs.on_replan_failure(now, repr(exc))
            if self.policy is not None:
                self.policy.notify_failure(now)
            self.set_baseline(rates)
            return None
        self._consecutive_failures = 0
        if obs is not None:
            obs.on_replan_success(now, self.planner.last_wall_s,
                                  plan.throughput)
        self.set_baseline(rates)
        # a mandatory (topology-change) swap does not feed the oscillation
        # damper: the mix flip it observes is an artifact of the hardware
        # event, not of workload ping-pong
        if self.policy is not None and not mandatory:
            transients = self.dataplane.tel.swap_transient_s
            self.policy.notify_swap(
                now, old_mix=old_mix, new_mix=dict(self._baseline_mix),
                solver_wall_s=self.planner.last_wall_s,
                transient_s=transients[-1] if transients else 0.0,
            )
        self.events.append(ReplanEvent(
            t_s=now, rates=dict(rates), weights=weights,
            throughput_rps=plan.throughput,
        ))
        return plan
