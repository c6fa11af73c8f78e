"""Baseline planners reproduced from the paper (section 7.1).

* NP     — No-Partitioning: whole models placed on either class, allocation by
           PPipe's MILP restricted to single-partition pipelines.  Represents
           the non-pipelined heterogeneous-serving line of work.
* DART-r — replicated two-stage chain pipelines pairing one low-class with one
           high-class chip (vfrac=1), leftover chips serve whole models.
"""

from __future__ import annotations

import itertools
import time

from repro_torch.core.costmodel import LatencyTable, transfer_latency
from repro_torch.core.plan import ClusterPlan, PipelinePlan, StagePlan
from repro_torch.core.types import ClusterSpec, ModelProfile

from .templates import PlanningResult, plan_cluster


def plan_np(
    profiles: dict[str, ModelProfile],
    tables: dict[str, LatencyTable],
    cluster: ClusterSpec,
    weights: dict[str, float] | None = None,
    slo_margin: float = 0.4,
    top_k: int = 250,
    time_limit_s: float = 60.0,
) -> PlanningResult:
    """NP baseline: PPipe's planner with partitioning disabled."""
    return plan_cluster(
        profiles, tables, cluster, weights=weights, slo_margin=slo_margin,
        max_partitions=1, top_k=top_k, time_limit_s=time_limit_s,
    )


def plan_dart_r(
    profiles: dict[str, ModelProfile],
    tables: dict[str, LatencyTable],
    cluster: ClusterSpec,
    weights: dict[str, float] | None = None,
    slo_margin: float = 0.4,
    top_k: int = 250,
    time_limit_s: float = 60.0,
) -> PlanningResult:
    """DART-r baseline: chain pipelines replicated over (low, high) chip pairs.

    For each model (weighted round-robin share of pairs), pick the SLO-feasible
    2-stage split with one chip per stage (either class order) that maximizes
    pair throughput; chain pipelines have no pooling, so each replica is a
    pipeline whose pools have exactly one member.  Leftover chips of the
    larger class run whole models (NP-style).
    """
    t0 = time.perf_counter()
    names = list(profiles)
    weights = weights or {n: 1.0 for n in names}
    classes = sorted(cluster.classes, key=lambda c: cluster.accel(c).peak_flops)
    if len(classes) < 2:
        return plan_np(profiles, tables, cluster, weights, slo_margin,
                       top_k=top_k, time_limit_s=time_limit_s)
    lo_all = classes[:-1]
    hi = classes[-1]

    plan = ClusterPlan(cluster=cluster, pipelines=[])
    remaining = dict(cluster.counts)

    def best_pair_template(name: str, lo: str):
        profile, table = profiles[name], tables[name]
        T = profile.slo_s * (1.0 - slo_margin)
        M = profile.n_blocks
        best = None
        for cut in range(1, M):
            for order in ((lo, hi), (hi, lo)):
                for b in table.batch_sizes:
                    lat0 = table.partition(0, cut, order[0], 1, b)
                    lat1 = table.partition(cut, M, order[1], 1, b)
                    x = transfer_latency(profile, cluster, order[0], order[1], cut, b)
                    if lat0 + lat1 + x > T:
                        continue
                    thr = b / max(lat0, lat1)
                    if best is None or thr > best[0]:
                        best = (thr, cut, order, b, (lat0, lat1), (x,))
        return best

    # pair low-class chips with high-class chips, round-robin across models
    for lo in lo_all:
        n_pairs = min(remaining[lo], remaining[hi])
        if n_pairs <= 0:
            continue
        share = _weighted_shares(names, weights, n_pairs)
        for name, cnt in share.items():
            if cnt <= 0:
                continue
            best = best_pair_template(name, lo)
            if best is None:
                continue
            _, cut, order, b, lats, xf = best
            M = profiles[name].n_blocks
            for _ in range(cnt):
                stages = (
                    StagePlan(0, cut, order[0], 1, 1, lats[0]),
                    StagePlan(cut, M, order[1], 1, 1, lats[1]),
                )
                plan.pipelines.append(
                    PipelinePlan(model_name=name, batch_size=b, stages=stages,
                                 xfer_latency_s=xf)
                )
                remaining[order[0]] -= 1
                remaining[order[1]] -= 1

    # leftovers: NP on the remaining inventory
    leftover_cluster = ClusterSpec(
        counts={k: v for k, v in remaining.items() if v > 0},
        chips_per_host=cluster.chips_per_host,
        nic_derate=cluster.nic_derate,
    )
    if leftover_cluster.counts:
        np_res = plan_np(profiles, tables, leftover_cluster, weights, slo_margin,
                         top_k=top_k, time_limit_s=time_limit_s)
        plan.pipelines.extend(np_res.plan.pipelines)

    plan.solver_wall_s = time.perf_counter() - t0
    plan.objective = plan.throughput
    # greedy construction proves nothing beyond what it built
    plan.dual_bound = plan.objective
    return PlanningResult(plan=plan, n_templates=0, lp_upper_bound=plan.throughput)


def _weighted_shares(names: list[str], weights: dict[str, float], total: int) -> dict[str, int]:
    wsum = sum(weights[n] for n in names)
    share = {n: int(total * weights[n] / wsum) for n in names}
    leftover = total - sum(share.values())
    for n in itertools.islice(itertools.cycle(names), leftover):
        share[n] += 1
    return share
