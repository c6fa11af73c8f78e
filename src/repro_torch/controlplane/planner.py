"""Planner facade: one entry point over every solver backend.

The paper's control plane is one logical planner invoked periodically; this
module gives the repo the same shape.  `Planner.plan(profiles, tables,
cluster, objective)` routes to a pluggable backend —

* ``"enumerate"`` — template enumeration + master ILP (the scalable
  production path, `templates.plan_cluster`);
* ``"milp"``      — the literal Appendix-A.2 MILP (single- or multi-model,
  small sizes; validates the enumerator);
* ``"np"``        — No-Partitioning baseline;
* ``"dart-r"``    — replicated chain-pipeline baseline

— and returns a `ClusterPlan` that has passed `ClusterPlan.validate`, so
every plan entering the data plane satisfies the same invariants regardless
of which solver produced it.  The full `PlanningResult` (template count, LP
upper bound) of the last solve stays available as `Planner.last_result`.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field, replace as _replace

from repro_torch.core.costmodel import LatencyTable
from repro_torch.core.plan import ClusterPlan
from repro_torch.core.types import ClusterSpec, ModelProfile

from .baselines import plan_dart_r, plan_np
from .milp import solve_milp_multi
from .templates import PlanningResult, TemplateCache, plan_cluster


@dataclass(frozen=True)
class Objective:
    """What to optimize and under which knobs (paper section 3 + 5.3).

    `weights` drive the multi-model min-normalized-throughput objective
    (None = uniform); the rest are solver knobs shared by every backend.

    `warm_gap` relaxes the MIP relative-gap termination on warm re-solves
    only (solves where an incumbent plan mapped onto the current problem and
    its objective cutoff is active).  The cutoff guarantees the returned
    plan is >= the incumbent, so the relaxation trades proof effort for
    replan wall time; the reported `lp_upper_bound`/`dual_bound` stays
    honest.  None (the default) keeps cold-solve exactness everywhere.
    """

    weights: dict[str, float] | None = None
    slo_margin: float = 0.4
    max_partitions: int = 3
    top_k: int = 250
    time_limit_s: float = 60.0
    warm_gap: float | None = None

    def with_weights(self, weights: dict[str, float]) -> "Objective":
        return _replace(self, weights=dict(weights))


def _backend_enumerate(profiles, tables, cluster, obj: Objective,
                       incumbent=None, template_cache=None) -> PlanningResult:
    return plan_cluster(
        profiles, tables, cluster, weights=obj.weights,
        slo_margin=obj.slo_margin, max_partitions=obj.max_partitions,
        top_k=obj.top_k, time_limit_s=obj.time_limit_s,
        incumbent=incumbent, template_cache=template_cache,
        warm_gap=obj.warm_gap,
    )


def _backend_milp(profiles, tables, cluster, obj: Objective,
                  incumbent=None, template_cache=None) -> PlanningResult:
    plan = solve_milp_multi(
        profiles, tables, cluster, weights=obj.weights,
        slo_margin=obj.slo_margin, max_partitions=obj.max_partitions,
        time_limit_s=obj.time_limit_s, incumbent=incumbent,
        warm_gap=obj.warm_gap,
    )
    # the honest bound: the MILP dual bound, not the incumbent itself (they
    # differ when the solver stopped at time_limit_s before proving optimality)
    return PlanningResult(plan=plan, n_templates=0,
                          lp_upper_bound=plan.dual_bound)


def _backend_np(profiles, tables, cluster, obj: Objective,
                incumbent=None, template_cache=None) -> PlanningResult:
    return plan_np(profiles, tables, cluster, weights=obj.weights,
                   slo_margin=obj.slo_margin, top_k=obj.top_k,
                   time_limit_s=obj.time_limit_s)


def _backend_dart_r(profiles, tables, cluster, obj: Objective,
                    incumbent=None, template_cache=None) -> PlanningResult:
    return plan_dart_r(profiles, tables, cluster, weights=obj.weights,
                       slo_margin=obj.slo_margin, top_k=obj.top_k,
                       time_limit_s=obj.time_limit_s)


BACKENDS = {
    "enumerate": _backend_enumerate,
    "milp": _backend_milp,
    "np": _backend_np,
    "dart-r": _backend_dart_r,
}


@dataclass
class Planner:
    """One facade over every solver backend; plans come out validated.

    A Planner instance is stateful across solves: it owns a `TemplateCache`
    (enumeration memo keyed on everything enumeration reads — see
    `templates.TemplateCache`) so that drift re-solves skip the dominant
    enumeration cost.  Passing the live plan as `incumbent=` additionally
    seeds the solver with priority columns plus an objective-cutoff
    constraint (`milp` backend: cutoff only).  Both are exactness-
    preserving; `warm_start=False` disables them for A/B measurement."""

    backend: str = "enumerate"
    objective: Objective = field(default_factory=Objective)
    validate: bool = True
    warm_start: bool = True
    last_result: PlanningResult | None = field(default=None, repr=False)
    # facade-level wall time of the last solve (solver + validation): what a
    # re-solve actually costs the control loop, fed to the replan policy's
    # cost EWMA (plan.solver_wall_s is the solver-internal time only)
    last_wall_s: float = 0.0
    template_cache: TemplateCache = field(default_factory=TemplateCache,
                                          repr=False)

    def __post_init__(self) -> None:
        if self.backend not in BACKENDS:
            raise ValueError(
                f"unknown backend {self.backend!r}; pick one of {sorted(BACKENDS)}"
            )

    def plan(
        self,
        profiles: dict[str, ModelProfile],
        tables: dict[str, LatencyTable],
        cluster: ClusterSpec,
        objective: Objective | None = None,
        incumbent: ClusterPlan | None = None,
    ) -> ClusterPlan:
        obj = objective or self.objective
        t0 = time.perf_counter()
        result = BACKENDS[self.backend](
            profiles, tables, cluster, obj,
            incumbent=incumbent if self.warm_start else None,
            template_cache=self.template_cache if self.warm_start else None,
        )
        if self.validate:
            result.plan.validate(profiles, slo_margin=obj.slo_margin)
        self.last_wall_s = time.perf_counter() - t0
        self.last_result = result
        return result.plan
