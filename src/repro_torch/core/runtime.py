"""Instantiate a ClusterPlan into runtime resources (nodes, chips, vdevs).

Chips are dedicated to one partition pool (the paper loads one partition's
weights per virtual GPU); each chip allocated to a stage with vGPU fraction
1/v exposes v virtual devices.  Hosts group `chips_per_host` chips behind one
NIC — the source of network contention D3.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

from . import costmodel
from .plan import ClusterPlan
from .reservation import (
    NodeRes,
    PipelineRuntime,
    StageRuntime,
    VDevRes,
    validate_bisection,
)
from .types import ClusterSpec, ModelProfile


@dataclass
class ClusterRuntime:
    cluster: ClusterSpec
    plan: ClusterPlan
    nodes: list[NodeRes] = field(default_factory=list)
    vdevs: list[VDevRes] = field(default_factory=list)
    pipelines: list[PipelineRuntime] = field(default_factory=list)
    _last_gc: float = 0.0

    def pipelines_of(self, model_name: str) -> list[PipelineRuntime]:
        return [p for p in self.pipelines if p.model_name == model_name]

    def gc(self, now: float) -> None:
        for v in self.vdevs:
            v.timeline.gc(now)
        for n in self.nodes:
            n.uplink.gc(now)
            n.downlink.gc(now)

    def maybe_gc(self, now: float, interval_s: float = 1.0) -> bool:
        """Amortized timeline GC: run `gc(now)` at most every `interval_s`
        virtual seconds.  The shared cadence knob of the simulator's and the
        DataPlane's drive loops — GC only drops intervals fully in the past,
        which no future-facing probe can see, so cadence is decision-neutral
        and purely a probe-cost/GC-cost trade (the regression test in
        tests/test_sched_equivalence.py keeps probe cost flat in trace
        length).  A `now` behind the watermark means the virtual clock
        restarted (the runtime is being reused for a fresh serve): reset
        rather than silently never GC'ing again."""
        if now - self._last_gc > interval_s or now < self._last_gc:
            self.gc(now)
            self._last_gc = now
            return True
        return False

    def timeline_intervals(self) -> int:
        """Booked intervals across every resource timeline — the quantity GC
        bounds, and what probe cost scales with."""
        total = 0
        for v in self.vdevs:
            total += len(v.timeline.starts)
        for n in self.nodes:
            total += len(n.uplink.starts) + len(n.downlink.starts)
        return total


def build_runtime(
    plan: ClusterPlan,
    profiles: dict[str, ModelProfile],
    cluster: ClusterSpec | None = None,
) -> ClusterRuntime:
    cluster = cluster or plan.cluster
    rt = ClusterRuntime(cluster=cluster, plan=plan)

    # chip allocator per class; chips fill hosts of `chips_per_host`
    next_chip = {c: 0 for c in cluster.classes}
    nodes_by_key: dict[tuple[str, int], NodeRes] = {}

    def alloc_chip(cname: str) -> tuple[int, NodeRes]:
        cid = next_chip[cname]
        if cid >= cluster.counts[cname]:
            raise ValueError(f"plan over-allocates class {cname}")
        next_chip[cname] = cid + 1
        host = cid // cluster.chips_per_host
        key = (cname, host)
        if key not in nodes_by_key:
            node = NodeRes(
                node_id=len(rt.nodes),
                accel_class=cname,
                nic_bw=cluster.effective_nic_bw(cname),
                host_id=host,
            )
            nodes_by_key[key] = node
            rt.nodes.append(node)
        return cid, nodes_by_key[key]

    for pid, pp in enumerate(plan.pipelines):
        profile = profiles[pp.model_name]
        stages: list[StageRuntime] = []
        for d, sp in enumerate(pp.stages):
            vdevs: list[VDevRes] = []
            n_chips = math.ceil(sp.n_vdev / sp.vfrac)
            slots = 0
            for _ in range(n_chips):
                cid, node = alloc_chip(sp.accel_class)
                for _ in range(sp.vfrac):
                    if slots >= sp.n_vdev:
                        break
                    vd = VDevRes(
                        vdev_id=len(rt.vdevs),
                        node=node,
                        chip_id=cid,
                        accel_class=sp.accel_class,
                        vfrac=sp.vfrac,
                    )
                    rt.vdevs.append(vd)
                    vdevs.append(vd)
                    slots += 1
            accel = cluster.accel(sp.accel_class)
            lat_by_b = {
                b: costmodel.partition_latency(
                    profile.blocks, sp.block_start, sp.block_end, accel, sp.vfrac, b
                )
                for b in range(1, pp.batch_size + 1)
            }
            in_bytes = (
                profile.boundary_bytes(sp.block_start, 1) if d > 0 else 0.0
            )
            stages.append(
                StageRuntime(
                    vdevs=vdevs, latency_by_batch=lat_by_b, in_bytes_per_req=in_bytes
                )
            )
        pruntime = PipelineRuntime(
            pipeline_id=pid,
            model_name=pp.model_name,
            unified_batch=pp.batch_size,
            stages=stages,
        )
        validate_bisection(pruntime)
        rt.pipelines.append(pruntime)
    return rt


def busy_by_class(rt: ClusterRuntime) -> dict[str, float]:
    """Accumulated chip-busy seconds per accelerator class (vdev busy time
    scaled by its chip fraction).  Horizon-independent, so a plan epoch's
    contribution can be frozen when the epoch is garbage-collected and summed
    with later epochs at finalize without loss."""
    # synthetic runtimes (cluster=None, e.g. the equivalence suite's) still
    # accumulate per class — they just have no declared class inventory
    classes = rt.cluster.classes if rt.cluster is not None else ()
    busy: dict[str, float] = {c: 0.0 for c in classes}
    for v in rt.vdevs:
        busy[v.accel_class] = busy.get(v.accel_class, 0.0) + v.busy_s / v.vfrac
    return busy


def utilization_by_class(rt: ClusterRuntime, horizon_s: float) -> dict[str, float]:
    """Temporal chip utilization per accelerator class (paper Fig. 8)."""
    busy = busy_by_class(rt)
    return {
        c: busy[c] / (rt.cluster.counts[c] * horizon_s) if rt.cluster.counts[c] else 0.0
        for c in rt.cluster.classes
    }
