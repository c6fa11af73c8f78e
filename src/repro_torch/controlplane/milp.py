"""Literal MILP formulation of PPipe's control plane (paper Appendix A.2).

Decision variables (per the paper, with batch-size unification + virtual
devices, generalized to a model index m for multi-model serving):

    p_{m,l,d,v,b,i,j} in {0,1}  partition d of pipeline l of model m spans
                                blocks [i,j) and runs at batch b on 1/v
                                virtual devices
    g_{m,l,d,v,b,i,j} in Z>=0   number of virtual devices for that partition
                                (whole chips when whole_chips=True)
    x_{m,l}           in R>=0   pipeline throughput (epigraph of min/stages)
    z                 in R>=0   min workload-normalized throughput (multi
                                only): z * w_m <= sum_l x_{m,l}

Constraints (16)-(28) are encoded with the standard linearizations:
  * (18) adjacency + unified batch: marginal equality between consecutive
    partitions for every (b, j);
  * (21)/(22) indicators: p <= g <= U*p with U = N_k * v;
  * (28) min: x <= sum X*g per stage.

Single model maximizes total throughput sum_l x_l; multiple models maximize
z with the enumerator's 1e-6 total-throughput tie-break — the same
min-normalized objective `templates.plan_cluster` solves, so the two
backends cross-check exactly.

One deliberate deviation, noted in DESIGN.md: the paper states sum(p)=1 per
(l,d) yet also reports that unused pipelines get zero GPUs; with g>=p these
cannot both hold, so we use sum(p) <= 1 (a pipeline may be unselected), which
matches the reported solver behaviour.

A second, opt-in deviation: constraint (23) as written counts fractional
chips (g/v), letting one physical chip host virtual devices of different
partitions — which the runtime cannot realize and the enumerator's master
ILP therefore forbids (whole chips per partition pool).  `whole_chips=True`
switches g to whole-chip units so the feasible set matches the enumerator's
exactly; the default stays paper-literal.

Warm start: `incumbent=` accepts the previous ClusterPlan.  scipy's HiGHS
interface exposes no MIP-start, so the incumbent is injected as an
objective cutoff — the incumbent is re-priced under the CURRENT tables and,
when it is still feasible (representable spans/vfracs/batch, SLO under the
new latencies, within the class budgets), the solve adds
`objective >= incumbent * (1 - 1e-9)`.  That prunes the branch-and-bound
tree below the incumbent without excluding any optimal solution (the true
optimum is >= any feasible point), so warm solves stay exact.

This literal model is exponential-ish in block count and is used at small
sizes for validation; `templates.py` is the scalable production path whose
optimum provably coincides (tests cross-check the two).

Solved with scipy's HiGHS MILP solver (Gurobi is unavailable offline; HiGHS
is an exact branch-and-cut solver).
"""

from __future__ import annotations

import itertools
import time
from dataclasses import dataclass

import numpy as np
from scipy import sparse
from scipy.optimize import Bounds, LinearConstraint
from scipy.optimize import milp as scipy_milp

from repro_torch.core.costmodel import LatencyTable, transfer_latency
from repro_torch.core.plan import ClusterPlan, PipelinePlan, StagePlan
from repro_torch.core.types import ClusterSpec, ModelProfile

MAX_BINARIES = 250_000

INF = float("inf")


@dataclass(frozen=True)
class PipelineShape:
    """One enumerated pipeline skeleton: the accelerator class per partition."""

    classes: tuple[str, ...]

    @property
    def depth(self) -> int:
        return len(self.classes)


def enumerate_pipeline_shapes(cluster: ClusterSpec, max_partitions: int) -> list[PipelineShape]:
    shapes = []
    for depth in range(1, max_partitions + 1):
        for combo in itertools.product(cluster.classes, repeat=depth):
            shapes.append(PipelineShape(tuple(combo)))
    return shapes


class _VarPool:
    def __init__(self) -> None:
        self.n = 0
        self.names: list[tuple] = []

    def new(self, key: tuple) -> int:
        idx = self.n
        self.n += 1
        self.names.append(key)
        return idx


def _stage_spans(M: int, depth: int, d: int):
    i_lo = d  # at least one block per earlier partition
    i_hi = M - (depth - d)  # leave one block per later partition
    for i in range(i_lo, i_hi + 1):
        j_lo = i + 1
        j_hi = M - (depth - d - 1)
        for j in range(j_lo, j_hi + 1):
            if d == 0 and i != 0:
                continue
            if d == depth - 1 and j != M:
                continue
            yield i, j


def incumbent_objective(
    incumbent: ClusterPlan,
    profiles: dict[str, ModelProfile],
    tables: dict[str, LatencyTable],
    cluster: ClusterSpec,
    weights: dict[str, float],
    slo_margin: float,
    max_partitions: int,
    whole_chips: bool = False,
) -> float | None:
    """Re-price `incumbent` under the CURRENT tables/cluster and return its
    objective value (total throughput for one model, min workload-normalized
    throughput otherwise), or None when the incumbent is not a feasible
    point of the current formulation — unknown model, stale span/vfrac/batch
    grid, SLO violated at the new latencies, or over the class budgets.

    None simply disables the warm-start cutoff; it is never an error (a
    topology or profile change legitimately invalidates the incumbent)."""
    used: dict[str, float] = {}
    thr: dict[str, float] = {n: 0.0 for n in profiles}
    for pl in incumbent.pipelines:
        n = pl.model_name
        if n not in profiles:
            return None
        profile, table = profiles[n], tables[n]
        M = profile.n_blocks
        T = profile.slo_s * (1.0 - slo_margin)
        stages = pl.stages
        if not stages or len(stages) > max_partitions:
            return None
        if stages[0].block_start != 0 or stages[-1].block_end != M:
            return None
        if pl.batch_size not in table.batch_sizes:
            return None
        total_lat = 0.0
        x = INF
        for d, st in enumerate(stages):
            if d > 0 and st.block_start != stages[d - 1].block_end:
                return None
            if st.accel_class not in cluster.counts:
                return None
            if st.vfrac not in table.vfracs or st.block_end <= st.block_start:
                return None
            if st.n_vdev < 1 or (whole_chips and st.n_vdev % st.vfrac != 0):
                return None
            lat = table.partition(
                st.block_start, st.block_end, st.accel_class, st.vfrac,
                pl.batch_size,
            )
            total_lat += lat
            if d < len(stages) - 1:
                total_lat += transfer_latency(
                    profile, cluster, st.accel_class,
                    stages[d + 1].accel_class, st.block_end, pl.batch_size,
                )
            used[st.accel_class] = used.get(st.accel_class, 0.0) + st.n_vdev / st.vfrac
            x = min(x, st.n_vdev * pl.batch_size / lat)
        if total_lat > T:
            return None
        thr[n] += x
    for cname, amt in used.items():
        if amt > cluster.counts.get(cname, 0) + 1e-9:
            return None
    if len(profiles) == 1:
        return sum(thr.values())
    return min(thr[n] / weights[n] for n in profiles)


def solve_milp(
    profile: ModelProfile,
    table: LatencyTable,
    cluster: ClusterSpec,
    slo_margin: float = 0.4,
    max_partitions: int = 3,
    time_limit_s: float = 120.0,
    *,
    whole_chips: bool = False,
    incumbent: ClusterPlan | None = None,
) -> ClusterPlan:
    """Build and solve the literal Appendix-A.2 MILP for one model."""
    return solve_milp_multi(
        {profile.model_name: profile},
        {profile.model_name: table},
        cluster,
        slo_margin=slo_margin,
        max_partitions=max_partitions,
        time_limit_s=time_limit_s,
        whole_chips=whole_chips,
        incumbent=incumbent,
    )


def solve_milp_multi(
    profiles: dict[str, ModelProfile],
    tables: dict[str, LatencyTable],
    cluster: ClusterSpec,
    weights: dict[str, float] | None = None,
    slo_margin: float = 0.4,
    max_partitions: int = 3,
    time_limit_s: float = 120.0,
    *,
    whole_chips: bool = False,
    incumbent: ClusterPlan | None = None,
    warm_gap: float | None = None,
) -> ClusterPlan:
    """Literal MILP over one or more models.

    Single model: maximize total throughput.  Multiple models: maximize the
    minimum workload-normalized throughput min_m sum_l x_{m,l} / w_m — the
    same objective (including the 1e-6 total-throughput tie-break) as
    `templates.plan_cluster`.

    `warm_gap` relaxes the MIP relative-gap termination, but only when the
    incumbent's objective cutoff is active: the cutoff already guarantees the
    returned plan is >= the incumbent, so the gap relaxation trades proof
    effort (not solution quality below the incumbent) for wall time.  None
    (the default) keeps the cold path's tight 1e-6 gap."""
    t0 = time.perf_counter()
    names = list(profiles)
    for n in names:
        if profiles[n].model_name != n:
            raise ValueError(
                f"profiles key {n!r} != profile.model_name {profiles[n].model_name!r}")
    weights = weights or {n: 1.0 for n in names}
    multi = len(names) > 1
    shapes = enumerate_pipeline_shapes(cluster, max_partitions)

    vp = _VarPool()
    p_idx: dict[tuple, int] = {}
    g_idx: dict[tuple, int] = {}
    x_idx: dict[tuple[int, int], int] = {}
    # (mi, l, d) -> [(mi, l, d, v, b, i, j), ...] so constraint assembly never
    # rescans the full variable pool (the single-model version's full scans
    # turn quadratic with a model index on top)
    keys_ld: dict[tuple[int, int, int], list[tuple]] = {}

    for mi, n in enumerate(names):
        M = profiles[n].n_blocks
        table = tables[n]
        for l, shape in enumerate(shapes):
            for d in range(shape.depth):
                lst = keys_ld[(mi, l, d)] = []
                for v in table.vfracs:
                    for b in table.batch_sizes:
                        for i, j in _stage_spans(M, shape.depth, d):
                            k = (mi, l, d, v, b, i, j)
                            p_idx[k] = vp.new(("p",) + k)
                            lst.append(k)
    n_p = vp.n
    if n_p > MAX_BINARIES:
        raise ValueError(
            f"literal MILP too large ({n_p} binaries); use templates.plan_cluster "
            "(this is exactly the paper's C1 — pre-partition to fewer blocks)"
        )
    for k in list(p_idx):
        g_idx[k] = vp.new(("g",) + k)
    for mi in range(len(names)):
        for l in range(len(shapes)):
            x_idx[(mi, l)] = vp.new(("x", mi, l))
    z_var = vp.new(("z",)) if multi else None
    nvar = vp.n

    rows, cols, vals, lbs, ubs = [], [], [], [], []

    def add_row(coef: dict[int, float], lb: float, ub: float) -> None:
        r = len(lbs)
        for c, v in coef.items():
            rows.append(r)
            cols.append(c)
            vals.append(v)
        lbs.append(lb)
        ubs.append(ub)

    for mi, n in enumerate(names):
        profile, table = profiles[n], tables[n]
        M = profile.n_blocks
        T = profile.slo_s * (1.0 - slo_margin)

        def xfer(shape: PipelineShape, d: int, j: int, b: int) -> float:
            return transfer_latency(
                profile, cluster, shape.classes[d], shape.classes[d + 1], j, b
            )

        for l, shape in enumerate(shapes):
            depth = shape.depth
            # (16) sum p <= 1 per (m, l, d)
            for d in range(depth):
                add_row({p_idx[k]: 1.0 for k in keys_ld[(mi, l, d)]}, 0.0, 1.0)
            # (18) adjacency + batch unification: marginals over (b, boundary j)
            for d in range(depth - 1):
                for b in table.batch_sizes:
                    for j in range(1, M):
                        coef: dict[int, float] = {}
                        for k in keys_ld[(mi, l, d)]:
                            if k[4] == b and k[6] == j:
                                var = p_idx[k]
                                coef[var] = coef.get(var, 0.0) + 1.0
                        for k in keys_ld[(mi, l, d + 1)]:
                            if k[4] == b and k[5] == j:
                                var = p_idx[k]
                                coef[var] = coef.get(var, 0.0) - 1.0
                        if coef:
                            add_row(coef, 0.0, 0.0)
            # (27) SLO: sum_d (C + Y) p <= T
            coef = {}
            for d in range(depth):
                for k in keys_ld[(mi, l, d)]:
                    _, _, _, v, b, i, j = k
                    lat = table.partition(i, j, shape.classes[d], v, b)
                    if d < depth - 1:
                        lat += xfer(shape, d, j, b)
                    coef[p_idx[k]] = lat
            add_row(coef, -np.inf, T)
            # (21)/(22): p <= g <= U p.  g counts virtual devices in the
            # paper-literal form, whole chips when whole_chips=True.
            for d in range(depth):
                N_k = cluster.counts[shape.classes[d]]
                for k in keys_ld[(mi, l, d)]:
                    _, _, _, v, b, i, j = k
                    gvar, pvar = g_idx[k], p_idx[k]
                    U = N_k if whole_chips else N_k * v
                    add_row({gvar: 1.0, pvar: -float(U)}, -np.inf, 0.0)
                    add_row({gvar: 1.0, pvar: -1.0}, 0.0, np.inf)
            # (28) epigraph: x <= sum X g per stage d (a whole chip hosts v
            # virtual devices, hence the extra factor v in whole-chip units)
            for d in range(depth):
                coef = {x_idx[(mi, l)]: 1.0}
                for k in keys_ld[(mi, l, d)]:
                    _, _, _, v, b, i, j = k
                    lat = table.partition(i, j, shape.classes[d], v, b)
                    per_g = (v * b / lat) if whole_chips else (b / lat)
                    coef[g_idx[k]] = -per_g
                add_row(coef, -np.inf, 0.0)

    # (23) class budgets (fractional chips g/v in the paper-literal form,
    # whole chips when whole_chips=True)
    for cname, count in cluster.counts.items():
        coef = {}
        for (_mi, l, d), keys in keys_ld.items():
            if shapes[l].classes[d] == cname:
                for k in keys:
                    coef[g_idx[k]] = 1.0 if whole_chips else 1.0 / k[3]
        add_row(coef, -np.inf, float(count))

    # multi-model: z * w_m <= sum_l x_{m,l}
    if multi:
        for mi, n in enumerate(names):
            coef = {z_var: weights[n]}
            for l in range(len(shapes)):
                coef[x_idx[(mi, l)]] = -1.0
            add_row(coef, -np.inf, 0.0)

    # warm start (objective cutoff): the re-priced incumbent, when still
    # feasible, lower-bounds the objective without excluding any optimum
    inc_val = None
    cutoff_active = False
    if incumbent is not None:
        inc_val = incumbent_objective(
            incumbent, profiles, tables, cluster, weights, slo_margin,
            max_partitions, whole_chips,
        )
        if inc_val is not None and inc_val > 0.0:
            cut = inc_val * (1.0 - 1e-9)
            if multi:
                add_row({z_var: 1.0}, cut, np.inf)
            else:
                add_row({x_idx[k]: 1.0 for k in x_idx}, cut, np.inf)
            cutoff_active = True

    A = sparse.csr_matrix((vals, (rows, cols)), shape=(len(lbs), nvar))
    c = np.zeros(nvar)
    if multi:
        c[z_var] = -1.0
        for var in x_idx.values():
            c[var] = -1e-6  # same total-throughput tie-break as the enumerator
    else:
        for var in x_idx.values():
            c[var] = -1.0  # maximize sum x_l

    integrality = np.zeros(nvar)
    lb = np.zeros(nvar)
    ub = np.full(nvar, np.inf)
    for var in p_idx.values():
        integrality[var] = 1
        ub[var] = 1.0
    for k, var in g_idx.items():
        mi, l, d, v, b, i, j = k
        integrality[var] = 1
        N_k = cluster.counts[shapes[l].classes[d]]
        ub[var] = N_k if whole_chips else N_k * v
    # Tightest implied capacity bound on every continuous column.  Valid
    # strengthening (x is capped by the slowest stage at full class
    # inventory) AND a required workaround: scipy 1.14's vendored HiGHS can
    # terminate branch-and-bound early with a falsely-closed gap when
    # continuous columns are unbounded above (same defect plugged in
    # templates._solve_master_ilp; see tests/test_milp.py cross-checks).
    xcap: dict[tuple[int, int], float] = {}
    for mi, n in enumerate(names):
        table = tables[n]
        for l, shape in enumerate(shapes):
            cap = INF
            for d in range(shape.depth):
                N_k = cluster.counts[shape.classes[d]]
                best = 0.0
                for k in keys_ld[(mi, l, d)]:
                    _, _, _, v, b, i, j = k
                    lat = table.partition(i, j, shape.classes[d], v, b)
                    # N_k whole chips of v vdevs each, in either unit system
                    per = N_k * v * b / lat
                    if per > best:
                        best = per
                cap = min(cap, best)
            xcap[(mi, l)] = cap
            ub[x_idx[(mi, l)]] = cap
    if multi:
        ub[z_var] = min(
            sum(xcap[(mi, l)] for l in range(len(shapes))) / weights[n]
            for mi, n in enumerate(names)
        )

    res = scipy_milp(
        c,
        constraints=LinearConstraint(A, np.array(lbs), np.array(ubs)),
        integrality=integrality,
        bounds=Bounds(lb, ub),
        options={
            "time_limit": time_limit_s,
            "mip_rel_gap": warm_gap if (warm_gap is not None and cutoff_active)
            else 1e-6,
        },
    )
    if res.x is None:
        raise RuntimeError(f"MILP solve failed: {res.message}")

    plan = _extract_plan(
        res.x, shapes, names, keys_ld, p_idx, g_idx, profiles, tables,
        cluster, whole_chips,
    )
    plan.solver_wall_s = time.perf_counter() - t0
    # single model: -res.fun is total throughput.  multi: -res.fun is
    # z + 1e-6 * total throughput — the enumerator's exact convention, so
    # objectives compare across backends verbatim.
    plan.objective = -res.fun
    # maximization encoded as min(-obj): the dual bound on the minimized
    # objective is a lower bound there, i.e. an upper bound on the maximum
    dual = getattr(res, "mip_dual_bound", None)
    plan.dual_bound = -dual if dual is not None else plan.objective
    return plan


def _extract_plan(
    x, shapes, names, keys_ld, p_idx, g_idx, profiles, tables, cluster,
    whole_chips,
) -> ClusterPlan:
    pipelines = []
    for mi, n in enumerate(names):
        profile, table = profiles[n], tables[n]
        for l, shape in enumerate(shapes):
            stages = []
            batch = None
            ok = True
            for d in range(shape.depth):
                sel = [
                    k for k in keys_ld[(mi, l, d)]
                    if x[p_idx[k]] > 0.5 and x[g_idx[k]] > 0.5
                ]
                if not sel:
                    ok = False
                    break
                k = sel[0]
                _, _, _, v, b, i, j = k
                batch = b
                g = int(round(x[g_idx[k]]))
                stages.append(
                    StagePlan(
                        block_start=i,
                        block_end=j,
                        accel_class=shape.classes[d],
                        vfrac=v,
                        n_vdev=g * v if whole_chips else g,
                        latency_s=table.partition(i, j, shape.classes[d], v, b),
                    )
                )
            if not ok or not stages:
                continue
            xfers = tuple(
                transfer_latency(
                    profile, cluster, shape.classes[d], shape.classes[d + 1],
                    stages[d].block_end, batch,
                )
                for d in range(len(stages) - 1)
            )
            pipelines.append(
                PipelinePlan(
                    model_name=n,
                    batch_size=batch,
                    stages=tuple(stages),
                    xfer_latency_s=xfers,
                )
            )
    return ClusterPlan(cluster=cluster, pipelines=pipelines)
