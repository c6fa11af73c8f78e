"""ProfileStore: the control plane's view of *how fast stages actually run*.

The paper's planner consumes offline-profiled per-layer latency tables
(section 5.1).  This repo's analytic stand-in is `costmodel.build_latency_table`
(the roofline).  Once the data plane has executed for real, two measured
signals exist:

* `dataplane.calibrate_runtime` overwrites `StageRuntime.latency_by_batch`
  with measured wall seconds (the offline profiler, for real);
* `FeedbackController` folds online drift into `StageRuntime.lat_scale`
  (section 5.4 feedback correction).

`ProfileStore.ingest(runtime)` harvests both: for every planned stage it
compares the stage's *current* priced latency (calibration x lat_scale)
against the analytic partition latency and records the ratio per
(model, class, vfrac, batch).  `measured_table()` then re-prices the dense
analytic table through those ratios (exact key, then coarser fallbacks), so a
re-solve plans at observed speed.  With no observations — or when every
`lat_scale` is exactly 1.0 on an uncalibrated runtime — the measured table is
float-identical to the analytic one, which keeps re-planning deterministic
and lets tests assert parity.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from repro_torch.core import costmodel as cm
from repro_torch.core.costmodel import LatencyTable
from repro_torch.core.reservation import validate_bisection
from repro_torch.core.runtime import ClusterRuntime
from repro_torch.core.types import ClusterSpec, ModelProfile


@dataclass
class ProfileStore:
    """Per-model profiles + analytic tables + measured speed ratios."""

    cluster: ClusterSpec
    vfracs: tuple[int, ...] = cm.VFRACS
    batch_sizes: tuple[int, ...] = cm.BATCH_SIZES
    profiles: dict[str, ModelProfile] = field(default_factory=dict)
    # (model, class, vfrac, batch) -> measured/analytic latency ratio
    scales: dict[tuple[str, str, int, int], float] = field(default_factory=dict)
    _analytic: dict[str, LatencyTable] = field(default_factory=dict)

    # ------------------------------------------------------------- profiles
    def add(self, profile: ModelProfile, table: LatencyTable | None = None) -> None:
        self.profiles[profile.model_name] = profile
        if table is not None:
            self._analytic[profile.model_name] = table
        else:
            self._analytic.pop(profile.model_name, None)

    def analytic_table(self, name: str) -> LatencyTable:
        tbl = self._analytic.get(name)
        if tbl is None:
            tbl = self._analytic[name] = cm.build_latency_table(
                self.profiles[name], self.cluster,
                vfracs=self.vfracs, batch_sizes=self.batch_sizes,
            )
        return tbl

    # ------------------------------------------------------------ ingestion
    def ingest(self, runtime: ClusterRuntime) -> int:
        """Harvest measured stage speeds from a live/calibrated runtime.

        Covers both measurement paths: `calibrate_runtime` (latency_by_batch
        rewritten with wall seconds) and `FeedbackController` (lat_scale
        EWMA).  Returns the number of (model, class, v, b) ratios recorded.
        Deterministic: same runtime state -> same ratios, last write wins.
        """
        n = 0
        for pid, prt in enumerate(runtime.pipelines):
            pp = runtime.plan.pipelines[pid]
            tbl = self.analytic_table(prt.model_name)
            for si, stage in enumerate(prt.stages):
                sp = pp.stages[si]
                if sp.vfrac not in tbl.vfracs or sp.accel_class not in tbl.classes:
                    continue
                for b in sorted(stage.latency_by_batch):
                    if b not in tbl.batch_sizes:
                        continue
                    analytic = tbl.partition(
                        sp.block_start, sp.block_end, sp.accel_class, sp.vfrac, b
                    )
                    if analytic <= 0.0:
                        continue
                    observed = stage.latency(b)  # calibration x lat_scale
                    key = (prt.model_name, sp.accel_class, sp.vfrac, b)
                    self.scales[key] = observed / analytic
                    n += 1
        return n

    # ---------------------------------------------------------------- tables
    def _fallback_means(self, model: str) -> tuple[dict, dict]:
        """One pass over `scales`: mean ratio per (cls, v) and per cls."""
        by_cv: dict[tuple[str, int], list[float]] = {}
        by_c: dict[str, list[float]] = {}
        for (m, c, v, _), r in sorted(self.scales.items()):
            if m != model:
                continue
            by_cv.setdefault((c, v), []).append(r)
            by_c.setdefault(c, []).append(r)
        return (
            {k: sum(rs) / len(rs) for k, rs in by_cv.items()},
            {k: sum(rs) / len(rs) for k, rs in by_c.items()},
        )

    def scale_for(self, model: str, cls: str, v: int, b: int,
                  means: tuple[dict, dict] | None = None) -> float:
        """Measured/analytic ratio with coarser fallbacks: exact (cls, v, b),
        then mean over batches at (cls, v), then mean over the class, else 1.

        Bulk callers pass precomputed `means` (from `_fallback_means`) so the
        one-pass aggregation is not repeated per table entry.
        """
        exact = self.scales.get((model, cls, v, b))
        if exact is not None:
            return exact
        cv_mean, c_mean = means if means is not None else self._fallback_means(model)
        got = cv_mean.get((cls, v))
        if got is not None:
            return got
        return c_mean.get(cls, 1.0)

    def measured_table(self, name: str) -> LatencyTable:
        """The analytic table re-priced at observed speed (paper 5.1 tables
        rebuilt from real profiling instead of the roofline).

        Fallback means are computed once per call, not per entry — dense
        tables have O(blocks * classes * vfracs * batches) entries and this
        runs on the re-planning path.
        """
        base = self.analytic_table(name)
        means = self._fallback_means(name)
        lat = {
            (k, cls, v, b): t * self.scale_for(name, cls, v, b, means)
            for (k, cls, v, b), t in base.lat.items()
        }
        return LatencyTable(
            profile=base.profile, classes=base.classes, vfracs=base.vfracs,
            batch_sizes=base.batch_sizes, lat=lat,
        )

    def reprice_runtime(self, runtime: ClusterRuntime) -> None:
        """Re-price a freshly built (analytic) runtime at measured speed.

        `build_runtime` populates `StageRuntime.latency_by_batch` from the
        analytic cost model; after a re-solve against `tables("measured")`
        the installed runtime must probe/reserve at the same measured speed
        the plan was priced with, so scale every entry through the recorded
        ratios (same fallback policy as `measured_table`).
        """
        for pid, prt in enumerate(runtime.pipelines):
            pp = runtime.plan.pipelines[pid]
            means = self._fallback_means(prt.model_name)
            for si, stage in enumerate(prt.stages):
                sp = pp.stages[si]
                stage.latency_by_batch = {
                    b: t * self.scale_for(prt.model_name, sp.accel_class,
                                          sp.vfrac, b, means)
                    for b, t in stage.latency_by_batch.items()
                }
            # measured ratios vary per batch size and can break the table
            # monotonicity the scheduler's bisection relies on: re-validate
            validate_bisection(prt)

    def request_cost_by_class(self, name: str,
                              source: str = "analytic") -> dict[str, float]:
        """Chip-seconds one request of `name` consumes on EACH accelerator
        class: the per-class exchange rates of the replan gate's capacity
        pools.

        Full-model latency on the class, priced whole-chip (v = min vfracs,
        i.e. the coarsest split) at the largest profiled batch, amortized per
        request.  Estimates only (partitioning/SLO/interference structure is
        ignored), but per-class: a model that is 4x slower on the lite class
        costs 4x more of that pool, which is exactly the heterogeneity the
        scalar `request_cost` exchange rate erases.  Runs on the control
        loop's per-check path, so the measured variant re-prices just the
        needed partitions through `scale_for` instead of materializing the
        dense measured table (block-uniform per (class, v, b) key, so the
        result is identical).
        """
        tbl = self.analytic_table(name)
        b = max(tbl.batch_sizes)
        v = min(tbl.vfracs)
        n = tbl.profile.n_blocks
        if source == "measured":
            means = self._fallback_means(name)
            lat = {cls: tbl.partition(0, n, cls, v, b)
                   * self.scale_for(name, cls, v, b, means)
                   for cls in tbl.classes}
        elif source == "analytic":
            lat = {cls: tbl.partition(0, n, cls, v, b) for cls in tbl.classes}
        else:
            raise ValueError(f"source must be analytic|measured, got {source!r}")
        return {cls: t / (v * b) for cls, t in lat.items()}

    def request_cost(self, name: str, source: str = "analytic") -> float:
        """Chip-seconds one request of `name` consumes, as a single scalar
        exchange rate: the best case over classes of
        `request_cost_by_class`.  Kept for the fungible-capacity estimator
        (`replan.estimate_benefit_scalar`) and callers that want one number;
        the policy gate itself prices per-class pools.
        """
        return min(self.request_cost_by_class(name, source).values())

    def table(self, name: str, source: str = "analytic") -> LatencyTable:
        if source == "analytic":
            return self.analytic_table(name)
        if source == "measured":
            return self.measured_table(name)
        raise ValueError(f"source must be analytic|measured, got {source!r}")

    def tables(self, source: str = "analytic") -> dict[str, LatencyTable]:
        return {n: self.table(n, source) for n in self.profiles}
