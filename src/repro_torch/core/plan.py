"""Plan dataclasses: the output of the MILP control plane.

A ClusterPlan is a set of pooled pipelines.  Each pipeline partitions a model
into stages; each stage is bound to a pool of virtual devices of one
accelerator class and runs at the pipeline's unified batch size (paper
section 5.3 batch-size unification).
"""

from __future__ import annotations

from dataclasses import dataclass, field

from .types import ClusterSpec, ModelProfile


@dataclass(frozen=True)
class StagePlan:
    block_start: int
    block_end: int  # exclusive
    accel_class: str
    vfrac: int  # virtual device = 1/vfrac of a chip
    n_vdev: int  # pool size in virtual devices
    latency_s: float  # batched inference latency of this partition

    @property
    def n_chips(self) -> float:
        return self.n_vdev / self.vfrac

    def throughput(self, batch: int) -> float:
        return self.n_vdev * batch / self.latency_s


@dataclass(frozen=True)
class PipelinePlan:
    model_name: str
    batch_size: int  # unified batch size (section 5.3)
    stages: tuple[StagePlan, ...]
    xfer_latency_s: tuple[float, ...]  # between consecutive stages (len = n-1)

    @property
    def n_stages(self) -> int:
        return len(self.stages)

    @property
    def total_latency_s(self) -> float:
        return sum(s.latency_s for s in self.stages) + sum(self.xfer_latency_s)

    @property
    def throughput(self) -> float:
        """Pipeline throughput = min over stage throughputs (paper eq. 14/28)."""
        return min(s.throughput(self.batch_size) for s in self.stages)

    def chips_used(self) -> dict[str, float]:
        used: dict[str, float] = {}
        for s in self.stages:
            used[s.accel_class] = used.get(s.accel_class, 0.0) + s.n_chips
        return used


@dataclass
class ClusterPlan:
    cluster: ClusterSpec
    pipelines: list[PipelinePlan] = field(default_factory=list)
    solver_wall_s: float = 0.0
    objective: float = 0.0
    # best known bound on the objective: the MILP/master-ILP dual bound for
    # solver-built plans (tight only when optimality was proven), or the
    # objective itself for construction-based planners (DART-r)
    dual_bound: float = 0.0

    @property
    def throughput(self) -> float:
        return sum(p.throughput for p in self.pipelines)

    def throughput_of(self, model_name: str) -> float:
        return sum(p.throughput for p in self.pipelines if p.model_name == model_name)

    def chips_used(self) -> dict[str, float]:
        used: dict[str, float] = {c: 0.0 for c in self.cluster.classes}
        for p in self.pipelines:
            for cname, n in p.chips_used().items():
                used[cname] = used.get(cname, 0.0) + n
        return used

    def validate(self, profiles: dict[str, ModelProfile], slo_margin: float = 0.0) -> None:
        """Invariants every plan must satisfy (tested property-style):

        1. partitions tile [0, n_blocks) contiguously;
        2. per-class chip usage within inventory;
        3. pipeline latency within the (margin-deflated) SLO;
        4. positive throughput, pool sizes >= 1;
        5. exactly one transfer latency per stage boundary (n_stages - 1);
        6. stage and transfer latencies non-negative.
        """
        for p in self.pipelines:
            prof = profiles[p.model_name]
            if len(p.xfer_latency_s) != p.n_stages - 1:
                raise ValueError(
                    f"{p.model_name}: {len(p.xfer_latency_s)} transfer latencies "
                    f"for {p.n_stages} stages (expected n_stages - 1)"
                )
            if any(x < 0.0 for x in p.xfer_latency_s):
                raise ValueError(f"negative transfer latency in {p}")
            expect = 0
            for s in p.stages:
                if s.block_start != expect or s.block_end <= s.block_start:
                    raise ValueError(f"non-contiguous partition in {p}")
                expect = s.block_end
                if s.n_vdev < 1 or s.vfrac not in (1, 2, 3, 4):
                    raise ValueError(f"bad pool in {s}")
                if s.latency_s < 0.0:
                    raise ValueError(f"negative stage latency in {s}")
            if expect != prof.n_blocks:
                raise ValueError(f"pipeline does not cover all blocks: {p}")
            limit = prof.slo_s * (1.0 - slo_margin) + 1e-9
            if p.total_latency_s > limit:
                raise ValueError(
                    f"pipeline latency {p.total_latency_s:.4f}s exceeds "
                    f"SLO budget {limit:.4f}s for {p.model_name}"
                )
        for cname, used in self.chips_used().items():
            if used > self.cluster.counts.get(cname, 0) + 1e-6:
                raise ValueError(
                    f"class {cname} over-allocated: {used} > {self.cluster.counts.get(cname, 0)}"
                )

    def summary(self) -> str:
        lines = [
            f"ClusterPlan: {len(self.pipelines)} pipeline(s), "
            f"throughput={self.throughput:.1f} rps, solver={self.solver_wall_s * 1e3:.1f} ms"
        ]
        for i, p in enumerate(self.pipelines):
            lines.append(
                f"  pipeline[{i}] {p.model_name} bs={p.batch_size} "
                f"lat={p.total_latency_s * 1e3:.2f}ms thr={p.throughput:.1f} rps"
            )
            for d, s in enumerate(p.stages):
                lines.append(
                    f"    stage[{d}] blocks[{s.block_start}:{s.block_end}) "
                    f"{s.accel_class} x{s.n_vdev} vdev(1/{s.vfrac}) "
                    f"lat={s.latency_s * 1e3:.2f}ms thr={s.throughput(p.batch_size):.1f} rps"
                )
        used = self.chips_used()
        lines.append(f"  chips used: {used}")
        return "\n".join(lines)
