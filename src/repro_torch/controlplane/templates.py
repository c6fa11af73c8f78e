"""Scalable control plane: template enumeration + master ILP.

The literal Appendix-A.2 MILP (milp.py) carries ~10^4-10^5 binaries at
production sizes.  This module implements the equivalent two-level solve:

 1. Enumerate *pipeline templates*: (partition boundaries, accelerator class
    per partition, unified batch size, vGPU fraction per partition), keeping
    only SLO-feasible, Pareto-undominated ones.  In the full MILP each (l,d)
    selects exactly one (v,b,i,j) tuple, so every full-MILP solution is a
    selection of templates with device counts, and vice versa; the optima
    coincide (cross-checked against milp.solve_milp in tests).

 2. Solve a small master problem: choose integer virtual-device counts
    r_{t,d} and throughputs x_t <= X_{t,d} * r_{t,d}, maximizing total (or
    min-normalized, for multi-model serving) throughput under per-class chip
    budgets.  An LP over all templates selects candidate columns; an exact
    HiGHS ILP over the top-K columns produces the integral plan.

Like the paper (Fig. 14a), runtime is independent of the number of device
*instances* and polynomial in the number of classes.
"""

from __future__ import annotations

import itertools
import time
from dataclasses import dataclass

import numpy as np
from scipy import sparse
from scipy.optimize import Bounds, LinearConstraint, linprog
from scipy.optimize import milp as scipy_milp

from repro_torch.core.costmodel import LatencyTable, transfer_latency
from repro_torch.core.plan import ClusterPlan, PipelinePlan, StagePlan
from repro_torch.core.types import ClusterSpec, ModelProfile


@dataclass(frozen=True)
class Template:
    """A fully-specified pooled pipeline except for pool sizes."""

    model_name: str
    bounds: tuple[int, ...]  # partition boundaries incl. 0 and M
    classes: tuple[str, ...]
    vfracs: tuple[int, ...]
    batch: int
    stage_lat: tuple[float, ...]
    xfer_lat: tuple[float, ...]

    @property
    def depth(self) -> int:
        return len(self.classes)

    @property
    def total_latency(self) -> float:
        return sum(self.stage_lat) + sum(self.xfer_lat)

    def stage_throughput_per_vdev(self, d: int) -> float:
        return self.batch / self.stage_lat[d]

    def chips_per_rps(self) -> dict[str, float]:
        """Physical chips of each class needed per 1 rps of pipeline throughput."""
        cost: dict[str, float] = {}
        for d, cname in enumerate(self.classes):
            per_vdev = self.stage_throughput_per_vdev(d)
            cost[cname] = cost.get(cname, 0.0) + 1.0 / (per_vdev * self.vfracs[d])
        return cost


def enumerate_templates(
    profile: ModelProfile,
    table: LatencyTable,
    cluster: ClusterSpec,
    slo_margin: float = 0.4,
    max_partitions: int = 3,
) -> list[Template]:
    M = profile.n_blocks
    T = profile.slo_s * (1.0 - slo_margin)
    out: list[Template] = []
    for depth in range(1, max_partitions + 1):
        for cut in itertools.combinations(range(1, M), depth - 1):
            bounds = (0,) + cut + (M,)
            for classes in itertools.product(cluster.classes, repeat=depth):
                for b in table.batch_sizes:
                    xfers = tuple(
                        transfer_latency(
                            profile, cluster, classes[d], classes[d + 1],
                            bounds[d + 1], b,
                        )
                        for d in range(depth - 1)
                    )
                    xfer_total = sum(xfers)
                    if xfer_total >= T:
                        continue
                    # per-stage latency options over vfracs, pruned to those
                    # that could still fit the SLO alone
                    opts = []
                    feasible = True
                    for d in range(depth):
                        cand = []
                        for v in table.vfracs:
                            lat = table.partition(
                                bounds[d], bounds[d + 1], classes[d], v, b
                            )
                            if lat + xfer_total < T:
                                cand.append((v, lat))
                        if not cand:
                            feasible = False
                            break
                        opts.append(cand)
                    if not feasible:
                        continue
                    for combo in itertools.product(*opts):
                        vfracs = tuple(v for v, _ in combo)
                        lats = tuple(lat for _, lat in combo)
                        if sum(lats) + xfer_total > T:
                            continue
                        out.append(
                            Template(
                                model_name=profile.model_name,
                                bounds=bounds,
                                classes=classes,
                                vfracs=vfracs,
                                batch=b,
                                stage_lat=lats,
                                xfer_lat=xfers,
                            )
                        )
    return _pareto_prune(out)


def _pareto_prune(templates: list[Template]) -> list[Template]:
    """Drop templates strictly dominated on (per-class chips/rps, latency)."""
    by_key: dict[tuple, list[Template]] = {}
    for t in templates:
        by_key.setdefault((t.bounds, t.classes, t.batch), []).append(t)
    keep: list[Template] = []
    for group in by_key.values():
        frontier: list[Template] = []
        for t in group:
            ct = t.chips_per_rps()
            dominated = False
            for u in group:
                if u is t:
                    continue
                cu = u.chips_per_rps()
                if (
                    all(cu.get(k, 0.0) <= ct.get(k, 0.0) + 1e-12 for k in ct)
                    and u.total_latency <= t.total_latency + 1e-12
                    and (
                        any(cu.get(k, 0.0) < ct.get(k, 0.0) - 1e-12 for k in ct)
                        or u.total_latency < t.total_latency - 1e-12
                    )
                ):
                    dominated = True
                    break
            if not dominated:
                frontier.append(t)
        keep.extend(frontier)
    return keep


# ----------------------------------------------------------------------------
# Warm-start state
# ----------------------------------------------------------------------------


class TemplateCache:
    """Memoizes per-model template enumeration (and the per-class chips/rps
    column matrix) across solves — the warm-start state a `Planner` carries
    between drift re-solves.

    Enumeration is the dominant cost at scale and, like the paper's Fig. 14a
    planner, never reads device COUNTS — only classes, NIC parameters, the
    latency table, the SLO, and the solver knobs.  The key therefore
    excludes counts: a cluster resize or a workload-mix change reuses the
    cached templates wholesale, while any change to what enumeration
    actually reads (re-profiled tables, different margin/partition knobs,
    new classes) misses and re-enumerates.  Entries are frozen Templates
    shared across solves; nothing downstream mutates them."""

    def __init__(self) -> None:
        self._store: dict[tuple, tuple[list[Template], np.ndarray]] = {}
        self.hits = 0
        self.misses = 0

    @staticmethod
    def _key(profile: ModelProfile, table: LatencyTable, cluster: ClusterSpec,
             slo_margin: float, max_partitions: int) -> tuple:
        return (
            profile.model_name,
            profile.n_blocks,
            profile.slo_s,
            profile.boundary_quant_factor,
            tuple(b.out_bytes for b in profile.blocks),
            tuple(cluster.classes),
            cluster.nic_derate,
            table.vfracs,
            table.batch_sizes,
            hash(tuple(sorted(table.lat.items()))),
            slo_margin,
            max_partitions,
        )

    def get(self, profile: ModelProfile, table: LatencyTable,
            cluster: ClusterSpec, slo_margin: float, max_partitions: int,
            ) -> tuple[list[Template], np.ndarray]:
        key = self._key(profile, table, cluster, slo_margin, max_partitions)
        hit = self._store.get(key)
        if hit is None:
            self.misses += 1
            templates = enumerate_templates(
                profile, table, cluster, slo_margin, max_partitions
            )
            hit = self._store[key] = (
                templates, _cost_matrix(templates, cluster.classes)
            )
        else:
            self.hits += 1
        return hit


def _cost_matrix(templates: list[Template], classes: tuple[str, ...]) -> np.ndarray:
    """Per-class chips/rps of each template: the phase-1 LP's columns."""
    cost = np.zeros((len(classes), len(templates)))
    for j, t in enumerate(templates):
        c = t.chips_per_rps()
        for i, cname in enumerate(classes):
            cost[i, j] = c.get(cname, 0.0)
    return cost


# ----------------------------------------------------------------------------
# Master problem
# ----------------------------------------------------------------------------


@dataclass
class PlanningResult:
    plan: ClusterPlan
    n_templates: int
    lp_upper_bound: float
    # warm-start accounting for the solve that produced this result (None =
    # cold API call with no cache/incumbent): template cache hits/misses,
    # how many incumbent pipelines mapped onto current templates, and the
    # objective cutoff injected into the master ILP (None = no cutoff)
    warm: dict | None = None


def plan_cluster(
    profiles: dict[str, ModelProfile],
    tables: dict[str, LatencyTable],
    cluster: ClusterSpec,
    weights: dict[str, float] | None = None,
    slo_margin: float = 0.4,
    max_partitions: int = 3,
    top_k: int = 250,
    time_limit_s: float = 60.0,
    incumbent: ClusterPlan | None = None,
    template_cache: TemplateCache | None = None,
    warm_gap: float | None = None,
) -> PlanningResult:
    """Plan pooled pipelines for one or more models on `cluster`.

    Single model: maximize total throughput.  Multiple models: maximize the
    minimum workload-normalized throughput (paper section 3 Objective).

    Warm start (both optional, both exactness-preserving):
    `template_cache` skips re-enumeration for every model whose inputs are
    unchanged; `incumbent` (the live ClusterPlan being replaced) has its
    pipelines mapped back onto current templates — matched columns are
    force-included at the FRONT of the master ILP's column set and the
    incumbent's re-priced objective enters as a cutoff constraint, pruning
    the branch-and-bound tree below a point known to be feasible.  A stale
    incumbent (re-profiled tables, changed class set) simply fails to match
    and the solve proceeds cold.

    `warm_gap` (only honoured when the incumbent mapped, i.e. the cutoff is
    active) relaxes the master ILP's relative MIP-gap termination for the
    re-solve: at scale branch-and-bound finds near-optimal plans in seconds
    and spends the remaining time budget *proving* the bound, which a drift
    re-solve does not need — the cutoff already guarantees the result is no
    worse than the live plan, and `plan.dual_bound` keeps the honest bound.
    None (the default) keeps the cold path's tight gap: warm solves then
    return the cold optimum exactly whenever the solver closes the gap."""
    t0 = time.perf_counter()
    names = list(profiles)
    for n in names:
        if profiles[n].model_name != n:
            raise ValueError(
                f"profiles key {n!r} != profile.model_name {profiles[n].model_name!r}")
    weights = weights or {n: 1.0 for n in names}
    hits0 = template_cache.hits if template_cache is not None else 0
    miss0 = template_cache.misses if template_cache is not None else 0
    templates: list[Template] = []
    cost_chunks: list[np.ndarray] = []
    for n in names:
        if template_cache is not None:
            tmpl, cost_m = template_cache.get(
                profiles[n], tables[n], cluster, slo_margin, max_partitions
            )
        else:
            tmpl = enumerate_templates(
                profiles[n], tables[n], cluster, slo_margin, max_partitions
            )
            cost_m = _cost_matrix(tmpl, cluster.classes)
        templates.extend(tmpl)
        cost_chunks.append(cost_m)
    warm_info = {
        "template_cache_hits": (template_cache.hits - hits0
                                if template_cache is not None else 0),
        "template_cache_misses": (template_cache.misses - miss0
                                  if template_cache is not None else 0),
        "incumbent_columns": 0,
        "cutoff": None,
    }
    if not templates:
        return PlanningResult(
            plan=ClusterPlan(cluster=cluster, pipelines=[],
                             solver_wall_s=time.perf_counter() - t0),
            n_templates=0,
            lp_upper_bound=0.0,
            warm=warm_info,
        )

    classes = cluster.classes
    # --- Phase 1: LP over all templates (vars = x_t >= 0 rps) ---------------
    nt = len(templates)
    cost = np.concatenate(cost_chunks, axis=1)
    budget = np.array([float(cluster.counts[c]) for c in classes])

    multi = len(names) > 1
    if not multi:
        res = linprog(
            -np.ones(nt), A_ub=cost, b_ub=budget, bounds=(0, None), method="highs"
        )
        lp_ub = -res.fun if res.status == 0 else 0.0
        lp_x = res.x if res.x is not None else np.zeros(nt)
    else:
        # max z s.t. sum_{t in model m} x_t >= z * w_m ; chips within budget
        # vars: [x_1..x_nt, z]
        c_obj = np.zeros(nt + 1)
        c_obj[-1] = -1.0
        A = np.zeros((len(classes) + len(names), nt + 1))
        b = np.zeros(len(classes) + len(names))
        A[: len(classes), :nt] = cost
        b[: len(classes)] = budget
        for mi, n in enumerate(names):
            for j, t in enumerate(templates):
                if t.model_name == n:
                    A[len(classes) + mi, j] = -1.0
            A[len(classes) + mi, -1] = weights[n]
            b[len(classes) + mi] = 0.0
        res = linprog(c_obj, A_ub=A, b_ub=b, bounds=(0, None), method="highs")
        lp_ub = -res.fun if res.status == 0 else 0.0
        lp_x = res.x[:nt] if res.x is not None else np.zeros(nt)

    # --- Incumbent mapping: priority columns + objective cutoff -------------
    # Each incumbent pipeline is looked up among CURRENT templates by its
    # full identity (model, bounds, classes, vfracs, batch).  A full match
    # whose chip counts fit the current budget is a known-feasible point of
    # the master ILP, so its re-priced objective is a valid cutoff; any
    # mismatch (pruned template, fractional chips, over budget after a
    # resize) disables the cutoff rather than risking exactness.
    inc_cols: list[int] = []
    cutoff: float | None = None
    if incumbent is not None and incumbent.pipelines:
        by_ident = {
            (t.model_name, t.bounds, t.classes, t.vfracs, t.batch): j
            for j, t in enumerate(templates)
        }
        matched: dict[int, list[int]] = {}
        ok = True
        for pl in incumbent.pipelines:
            stages = pl.stages
            ident = (
                pl.model_name,
                (stages[0].block_start,) + tuple(s.block_end for s in stages),
                tuple(s.accel_class for s in stages),
                tuple(s.vfrac for s in stages),
                pl.batch_size,
            )
            j = by_ident.get(ident)
            if j is None or any(s.n_vdev % s.vfrac != 0 for s in stages):
                ok = False
                break
            chips = [s.n_vdev // s.vfrac for s in stages]
            prev = matched.get(j)
            matched[j] = chips if prev is None else [
                a + b for a, b in zip(prev, chips)
            ]
        if ok and matched:
            thr = {n: 0.0 for n in names}
            used: dict[str, int] = {}
            for j, chips in matched.items():
                t = templates[j]
                thr[t.model_name] += min(
                    t.stage_throughput_per_vdev(d) * t.vfracs[d] * chips[d]
                    for d in range(t.depth)
                )
                for d in range(t.depth):
                    used[t.classes[d]] = used.get(t.classes[d], 0) + chips[d]
            if all(used[c] <= cluster.counts.get(c, 0) for c in used):
                val = (min(thr[n] / weights[n] for n in names) if multi
                       else sum(thr.values()))
                if val > 0.0:
                    cutoff = val * (1.0 - 1e-9)
                    inc_cols = list(matched)
    warm_info["incumbent_columns"] = len(inc_cols)
    warm_info["cutoff"] = cutoff

    # --- Phase 2: exact integer master over the most promising columns ------
    # LP-ranked, but never drop zero-mass columns while top_k capacity is
    # free: a degenerate LP optimum can put zero mass on the column the
    # *integral* optimum needs (whole-chip granularity), and with nt <= top_k
    # the master ILP over every column is exact — matching the literal MILP.
    # Incumbent columns are pinned at the FRONT of the active set (priority
    # ordering: HiGHS finds the incumbent-supported integral point early,
    # which with the cutoff prunes most of the tree on drift re-solves).
    order = np.argsort(-lp_x)
    inc_set = set(inc_cols)
    active = inc_cols + [
        int(i) for i in order[: min(top_k, nt)] if int(i) not in inc_set
    ]
    # Always include the best single-stage fallback column per (model, class)
    # — highest per-chip throughput — so the integral problem keeps a feasible
    # column for every model/class even when the LP cut dropped them all.
    best_single: dict[tuple[str, str], tuple[float, int]] = {}
    for j, t in enumerate(templates):
        if t.depth != 1:
            continue
        per_chip = t.stage_throughput_per_vdev(0) * t.vfracs[0]
        key = (t.model_name, t.classes[0])
        if key not in best_single or per_chip > best_single[key][0]:
            best_single[key] = (per_chip, j)
    active_set = set(active)
    for _, j in best_single.values():
        if j not in active_set:
            active.append(j)
            active_set.add(j)

    sel = [templates[j] for j in active]
    plan = _solve_master_ilp(
        sel, profiles, cluster, names, weights, multi, time_limit_s,
        cutoff=cutoff,
        mip_rel_gap=warm_gap if cutoff is not None else None,
    )
    plan.solver_wall_s = time.perf_counter() - t0
    return PlanningResult(plan=plan, n_templates=nt, lp_upper_bound=lp_ub,
                          warm=warm_info)


def _solve_master_ilp(
    templates: list[Template],
    profiles: dict[str, ModelProfile],
    cluster: ClusterSpec,
    names: list[str],
    weights: dict[str, float],
    multi: bool,
    time_limit_s: float,
    cutoff: float | None = None,
    mip_rel_gap: float | None = None,
) -> ClusterPlan:
    """Exact ILP over integer *chip* counts c_{t,d} (vdevs = v * c).

    The paper's constraint (23) counts fractional chips (g/v), which would let
    one physical chip host virtual devices of *different* partitions; our
    runtime dedicates a chip to one partition pool (weights resident per
    partition), so the master problem allocates whole chips — physically
    realizable plans at a tiny optimality cost vs the literal form."""
    classes = cluster.classes
    nt = len(templates)
    r_off: list[int] = []  # var offset of r_{t,0}
    nv = 0
    for t in templates:
        r_off.append(nv)
        nv += t.depth
    x_off = nv
    nv += nt
    z_idx = None
    if multi:
        z_idx = nv
        nv += 1

    rows, cols, vals, lbs, ubs = [], [], [], [], []

    def add_row(coef: dict[int, float], lb: float, ub: float) -> None:
        ridx = len(lbs)
        for c, v in coef.items():
            rows.append(ridx)
            cols.append(c)
            vals.append(v)
        lbs.append(lb)
        ubs.append(ub)

    # x_t <= X_{t,d} * v_{t,d} * c_{t,d}   (c = whole chips for stage d)
    for j, t in enumerate(templates):
        for d in range(t.depth):
            add_row(
                {x_off + j: 1.0,
                 r_off[j] + d: -t.stage_throughput_per_vdev(d) * t.vfracs[d]},
                -np.inf,
                0.0,
            )
    # class budgets: sum c <= N_k
    for cname in classes:
        coef: dict[int, float] = {}
        for j, t in enumerate(templates):
            for d in range(t.depth):
                if t.classes[d] == cname:
                    coef[r_off[j] + d] = coef.get(r_off[j] + d, 0.0) + 1.0
        add_row(coef, -np.inf, float(cluster.counts[cname]))
    # multi-model: z <= sum_m x_t / w_m
    if multi:
        for n in names:
            coef = {z_idx: weights[n]}
            for j, t in enumerate(templates):
                if t.model_name == n:
                    coef[x_off + j] = -1.0
            add_row(coef, -np.inf, 0.0)
    # warm-start cutoff: the incumbent's re-priced objective is feasible, so
    # the optimum can only sit at or above it — branch-and-bound may prune
    # everything below without losing exactness
    if cutoff is not None and cutoff > 0.0:
        if multi:
            add_row({z_idx: 1.0}, cutoff, np.inf)
        else:
            add_row({x_off + j: 1.0 for j in range(nt)}, cutoff, np.inf)

    c = np.zeros(nv)
    if multi:
        c[z_idx] = -1.0
        # small tie-break on total throughput
        c[x_off : x_off + nt] = -1e-6
    else:
        c[x_off : x_off + nt] = -1.0

    integrality = np.zeros(nv)
    ub = np.full(nv, np.inf)
    for j, t in enumerate(templates):
        for d in range(t.depth):
            integrality[r_off[j] + d] = 1
            ub[r_off[j] + d] = cluster.counts[t.classes[d]]
    # Every continuous column gets its tightest implied capacity bound.
    # This is a valid strengthening (x_t can never exceed the whole class
    # inventory running its slowest stage) AND a required workaround: the
    # vendored HiGHS in scipy 1.14 can terminate branch-and-bound early with
    # a falsely-closed gap when continuous columns are unbounded above —
    # observed returning 46% below the true optimum on a 149-column
    # multi-model instance (see tests/test_milp.py cross-checks).
    xcap = np.zeros(nt)
    for j, t in enumerate(templates):
        xcap[j] = min(
            t.stage_throughput_per_vdev(d) * t.vfracs[d]
            * cluster.counts[t.classes[d]]
            for d in range(t.depth)
        )
        ub[x_off + j] = xcap[j]
    if multi:
        ub[z_idx] = min(
            sum(xcap[j] for j, t in enumerate(templates) if t.model_name == n)
            / weights[n]
            for n in names
        )

    A = sparse.csr_matrix((vals, (rows, cols)), shape=(len(lbs), nv))
    res = scipy_milp(
        c,
        constraints=LinearConstraint(A, np.array(lbs), np.array(ubs)),
        integrality=integrality,
        bounds=Bounds(np.zeros(nv), ub),
        options={"time_limit": time_limit_s,
                 "mip_rel_gap": mip_rel_gap if mip_rel_gap is not None else 1e-4},
    )
    if res.x is None:
        raise RuntimeError(f"master ILP failed: {res.message}")

    plan = ClusterPlan(cluster=cluster, pipelines=[])
    plan.objective = -res.fun
    dual = getattr(res, "mip_dual_bound", None)
    plan.dual_bound = -dual if dual is not None else plan.objective
    for j, t in enumerate(templates):
        c = [int(round(res.x[r_off[j] + d])) for d in range(t.depth)]
        if min(c) < 1:
            continue
        stages = tuple(
            StagePlan(
                block_start=t.bounds[d],
                block_end=t.bounds[d + 1],
                accel_class=t.classes[d],
                vfrac=t.vfracs[d],
                n_vdev=c[d] * t.vfracs[d],
                latency_s=t.stage_lat[d],
            )
            for d in range(t.depth)
        )
        plan.pipelines.append(
            PipelinePlan(
                model_name=t.model_name,
                batch_size=t.batch,
                stages=stages,
                xfer_latency_s=t.xfer_lat,
            )
        )
    return plan
