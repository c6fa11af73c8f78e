"""Declarative arrival-source configuration (``ServeConfig.stream``).

One `SourceConfig` describes one seed-deterministic arrival process the
session can serve open-loop via `Session.serve()`.  Pure data, like the rest
of `repro_torch.api.config`: validation plus a lossless dict round-trip, nothing
here touches numpy or the data plane — `repro_torch.stream.sources.build_source`
is what turns a config into a live generator.

Kinds map one-to-one onto the `repro_torch.stream.sources` classes:

=============  ============================================================
kind           knobs (beyond rate_rps / model / slo_s / seed)
=============  ============================================================
poisson        —
diurnal        period_s, amplitude (0..1), phase_s — sinusoidal rate curve
flash          diurnal knobs + flash_mult, flash_s, mean_flash_interval_s
               (multiplicative flash-crowd overlay on the diurnal curve)
multi_camera   cameras: nested SourceConfigs, one per camera/tenant feed
               (per-camera req-id striping keeps ids globally unique)
=============  ============================================================

`TraceSource` deliberately has no config kind: it wraps live `Request`
objects (the run/serve parity anchor), which do not belong in a JSON blob.
"""

from __future__ import annotations

from dataclasses import dataclass, field

SOURCE_KINDS = ("poisson", "diurnal", "flash", "multi_camera")


@dataclass(frozen=True)
class SourceConfig:
    """One arrival process, declaratively (see module docstring)."""

    kind: str = "poisson"
    rate_rps: float = 10.0  # long-run mean rate (diurnal/flash renormalize)
    model: str | None = None  # None = the session's first configured model
    slo_s: float | None = None  # None = the model's profiled SLO
    seed: int = 0
    # diurnal rate curve: rate(t) = rate_rps * (1 + amplitude * sin(...))
    period_s: float = 60.0
    amplitude: float = 0.5
    phase_s: float = 0.0
    # flash-crowd overlay (kind="flash")
    flash_mult: float = 4.0
    flash_s: float = 2.0
    mean_flash_interval_s: float = 20.0
    # nested per-camera feeds (kind="multi_camera")
    cameras: tuple["SourceConfig", ...] = field(default_factory=tuple)

    def validate(self) -> "SourceConfig":
        if self.kind not in SOURCE_KINDS:
            raise ValueError(
                f"unknown source kind {self.kind!r}; known: {SOURCE_KINDS}")
        if self.kind == "multi_camera":
            if not self.cameras:
                raise ValueError("multi_camera source needs >= 1 camera")
            for cam in self.cameras:
                if not isinstance(cam, SourceConfig):
                    raise ValueError("cameras entries must be SourceConfig, "
                                     f"got {type(cam).__name__}")
                if cam.kind == "multi_camera":
                    raise ValueError("multi_camera sources do not nest")
                cam.validate()
            return self
        if self.cameras:
            raise ValueError(f"cameras only applies to kind='multi_camera', "
                             f"not {self.kind!r}")
        if not self.rate_rps > 0:
            raise ValueError(f"rate_rps must be > 0, got {self.rate_rps}")
        if self.slo_s is not None and not self.slo_s > 0:
            raise ValueError(f"slo_s must be > 0, got {self.slo_s}")
        if self.kind in ("diurnal", "flash"):
            if not self.period_s > 0:
                raise ValueError(f"period_s must be > 0, got {self.period_s}")
            if not 0.0 <= self.amplitude < 1.0:
                raise ValueError(
                    f"amplitude must be in [0, 1), got {self.amplitude}")
        if self.kind == "flash":
            if not self.flash_mult >= 1.0:
                raise ValueError(
                    f"flash_mult must be >= 1, got {self.flash_mult}")
            if not self.flash_s > 0:
                raise ValueError(f"flash_s must be > 0, got {self.flash_s}")
            if not self.mean_flash_interval_s > 0:
                raise ValueError("mean_flash_interval_s must be > 0, got "
                                 f"{self.mean_flash_interval_s}")
        return self

    @classmethod
    def from_dict(cls, data: dict) -> "SourceConfig":
        """Inverse of the generic dataclass encoding (recursive cameras)."""
        d = dict(data)
        cameras = tuple(cls.from_dict(c) for c in d.pop("cameras", ()) or ())
        return cls(cameras=cameras, **d).validate()
