"""Declarative observability knobs (`ServeConfig.obs`).

Pure data, like the rest of `repro_torch.api`'s config surface: validation and a
lossless dict round-trip, nothing that touches the data plane.  The levels:

* ``"off"`` — no Observer is created at all.  The data plane's hooks are
  gated by ``if self.obs is not None`` (the same structural pattern the old
  ``exec_log`` used), so the off path is decision-identical and near-zero
  cost on the optimized hot path.
* ``"aggregate"`` — rolling-window metrics (`WindowedMetrics`) plus the
  control-plane decision journal (drift estimates, replan verdicts, plan
  swaps).  No per-request/per-stage events.
* ``"trace"`` — everything: per-request span events (arrive/queue/exec/
  transfer/complete/drop), per-batch dispatch and execution events, and
  Perfetto `trace_event` export.  `span_sampling` bounds the per-request
  event volume; batch/stage events are bounded by dispatch count and are
  always recorded at this level.
"""

from __future__ import annotations

from dataclasses import dataclass

LEVELS = ("off", "aggregate", "trace")


@dataclass(frozen=True)
class ObsConfig:
    """Observability section of a ServeConfig."""

    level: str = "off"  # off | aggregate | trace
    window_s: float = 0.5  # rolling-metrics window width (virtual seconds)
    # fraction of requests that get per-request trace events (deterministic
    # in req_id, so twin runs sample identical request sets); 1.0 = all
    span_sampling: float = 1.0

    def validate(self) -> "ObsConfig":
        if self.level not in LEVELS:
            raise ValueError(
                f"obs.level must be one of {LEVELS}, got {self.level!r}")
        if not self.window_s > 0:
            raise ValueError(f"obs.window_s must be > 0, got {self.window_s}")
        if not 0.0 <= self.span_sampling <= 1.0:
            raise ValueError("obs.span_sampling must be in [0, 1], got "
                             f"{self.span_sampling}")
        return self
