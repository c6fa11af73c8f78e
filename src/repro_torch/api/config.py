"""Declarative serving configuration: what to serve, on what, under which knobs.

`ModelSpec` describes one model the deployment serves (architecture, request
shape, SLO, pre-partitioning granularity); `ServeConfig` describes the whole
deployment (cluster inventory, planner backend + `Objective`, feedback mode,
admission policy, re-planning cadence/governance, executor knobs).  Both are
plain validated dataclasses with a lossless dict round-trip
(`to_dict`/`from_dict`), so a serving run is reproducible from a JSON blob —
the one non-serializable escape hatch is `ServeConfig.token_fn`, which is
deliberately excluded and must be re-attached in code.

The configs are pure data: nothing here touches torch, solvers or the data
plane.  `Session.from_config` (session.py) is what turns one into a running
system.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Callable

from repro_torch.controlplane.planner import BACKENDS, Objective
from repro_torch.controlplane.replan import PolicyConfig, ReplanConfig
from repro_torch.core import costmodel as cm
from repro_torch.core.types import ACCEL_CLASSES, ClusterSpec
from repro_torch.dataplane.queues import AdmissionPolicy
from repro_torch.faults import FaultConfig
from repro_torch.obs import ObsConfig
from repro_torch.stream.config import SourceConfig


class ConfigError(ValueError):
    """A ServeConfig/ModelSpec failed validation."""


@dataclass(frozen=True)
class ModelSpec:
    """One model of the deployment, declaratively.

    `arch` names a registered architecture (`repro_torch.configs.ARCH_IDS`);
    `reduced` optionally shrinks it via `ModelConfig.reduced(**reduced)` —
    the real-execution path runs the (reduced) model, the analytic path
    only prices it.  The SLO is `slo_scale` x the batch-1 full-model latency
    on the cluster's fastest class (paper section 7.1, following AlpaServe)
    unless an absolute `slo_s` is given.  `weight` feeds the multi-model
    min-normalized-throughput objective.
    """

    arch: str
    slo_scale: float = 5.0
    slo_s: float | None = None  # absolute SLO override (seconds)
    seq_len: int = 256  # request shape used for profiling
    n_blocks: int = 10  # pre-partitioning granularity (paper section 5.2)
    reduced: dict | None = None  # kwargs for ModelConfig.reduced()
    weight: float = 1.0  # objective weight (min-normalized throughput)

    def validate(self) -> None:
        from repro_torch.configs import ARCH_IDS

        if self.arch not in ARCH_IDS:
            raise ConfigError(f"unknown arch {self.arch!r}; known: {ARCH_IDS}")
        if self.slo_s is None and self.slo_scale <= 0:
            raise ConfigError(f"slo_scale must be > 0, got {self.slo_scale}")
        if self.slo_s is not None and self.slo_s <= 0:
            raise ConfigError(f"slo_s must be > 0, got {self.slo_s}")
        if self.seq_len < 1:
            raise ConfigError(f"seq_len must be >= 1, got {self.seq_len}")
        if self.n_blocks < 2:
            raise ConfigError(f"n_blocks must be >= 2, got {self.n_blocks}")
        if self.weight <= 0:
            raise ConfigError(f"weight must be > 0, got {self.weight}")
        if self.reduced is not None and not isinstance(self.reduced, dict):
            raise ConfigError("reduced must be a dict of ModelConfig.reduced "
                              f"overrides, got {type(self.reduced).__name__}")


@dataclass(frozen=True)
class ServeConfig:
    """The whole deployment, declaratively (cluster, models, control knobs).

    One ServeConfig = one reproducible serving run: `Session.from_config`
    consumes it, and `to_dict()`/`from_dict()` round-trip it for storage.

    * control plane — `backend` picks the Planner solver, `objective` its
      knobs, `source` which ProfileStore tables price solves (analytic
      roofline vs measured speed);
    * data plane — `admission` (None = default SLO-aware policy),
      `feedback` ("planned" | "measured"; measured requires
      `deploy(mode="real")`), `gc_interval_s` the timeline-GC cadence;
    * re-planning — `replan` (cadence) + `replan_policy` (cost/benefit
      gate; None = ungated), consumed by `Session.enable_replanning()`;
    * real execution — `serve_seq_len`/`token_fn` shape the token batches,
      `max_inflight` bounds dispatcher overlap, `calibrate` forces (or
      suppresses) the offline profiling pass at deploy (None = calibrate
      exactly when feedback is "measured").
    """

    cluster: ClusterSpec
    models: tuple[ModelSpec, ...]
    backend: str = "enumerate"
    objective: Objective = field(default_factory=Objective)
    source: str = "analytic"  # ProfileStore tables pricing plan()/swap()
    feedback: str = "planned"
    admission: AdmissionPolicy | None = None
    replan: ReplanConfig = field(default_factory=ReplanConfig)
    replan_policy: PolicyConfig | None = None
    gc_interval_s: float = 1.0
    # observability (repro_torch.obs): level off|aggregate|trace, rolling-window
    # width, span sampling rate — off means no Observer is created at all
    obs: ObsConfig = field(default_factory=ObsConfig)
    # open-loop arrival process (repro_torch.stream) for Session.serve() when no
    # explicit Source is passed; None means serve() requires one.  ("source"
    # above predates this and names the ProfileStore pricing tables.)
    stream: SourceConfig | None = None
    # deterministic fault injection (repro_torch.faults) for Session.deploy();
    # None means no injector is attached — the fault path stays inert
    faults: FaultConfig | None = None
    # latency-table axes (ProfileStore): defaults are the paper's grids
    vfracs: tuple[int, ...] = cm.VFRACS
    batch_sizes: tuple[int, ...] = cm.BATCH_SIZES
    # real-execution knobs
    serve_seq_len: int = 32
    max_inflight: int = 4
    quantize_boundary: bool = True
    calibrate: bool | None = None
    seed: int = 0  # PRNG seed for parameter init
    # dummy-token factory (n, seq_len) -> array; NOT serialized (code only)
    token_fn: Callable | None = field(default=None, compare=False)

    # ------------------------------------------------------------ validation
    def validate(self) -> "ServeConfig":
        if not isinstance(self.cluster, ClusterSpec):
            raise ConfigError("cluster must be a ClusterSpec, got "
                              f"{type(self.cluster).__name__}")
        if not self.cluster.counts:
            raise ConfigError("cluster has no accelerator classes")
        for cls_name, count in self.cluster.counts.items():
            if cls_name not in ACCEL_CLASSES:
                raise ConfigError(f"unknown accelerator class {cls_name!r}; "
                                  f"known: {sorted(ACCEL_CLASSES)}")
            if count < 1:
                raise ConfigError(f"class {cls_name!r} has count {count}")
        if not self.models:
            raise ConfigError("ServeConfig.models is empty")
        seen: set[str] = set()
        for spec in self.models:
            if not isinstance(spec, ModelSpec):
                raise ConfigError("models entries must be ModelSpec, got "
                                  f"{type(spec).__name__}")
            spec.validate()
            if spec.arch in seen:
                raise ConfigError(f"duplicate model arch {spec.arch!r}")
            seen.add(spec.arch)
        if self.backend not in BACKENDS:
            raise ConfigError(f"unknown planner backend {self.backend!r}; "
                              f"pick one of {sorted(BACKENDS)}")
        if self.source not in ("analytic", "measured"):
            raise ConfigError(
                f"source must be analytic|measured, got {self.source!r}")
        if self.feedback not in ("planned", "measured"):
            raise ConfigError(
                f"feedback must be planned|measured, got {self.feedback!r}")
        if self.gc_interval_s <= 0:
            raise ConfigError(
                f"gc_interval_s must be > 0, got {self.gc_interval_s}")
        if not isinstance(self.obs, ObsConfig):
            raise ConfigError("obs must be an ObsConfig, got "
                              f"{type(self.obs).__name__}")
        try:
            self.obs.validate()
        except ValueError as exc:
            raise ConfigError(str(exc)) from exc
        if self.stream is not None:
            if not isinstance(self.stream, SourceConfig):
                raise ConfigError("stream must be a SourceConfig, got "
                                  f"{type(self.stream).__name__}")
            try:
                self.stream.validate()
            except ValueError as exc:
                raise ConfigError(str(exc)) from exc
        if self.faults is not None:
            if not isinstance(self.faults, FaultConfig):
                raise ConfigError("faults must be a FaultConfig, got "
                                  f"{type(self.faults).__name__}")
            try:
                self.faults.validate()
            except ValueError as exc:
                raise ConfigError(str(exc)) from exc
        if not self.vfracs or any(v < 1 for v in self.vfracs):
            raise ConfigError(f"invalid vfracs {self.vfracs!r}")
        if not self.batch_sizes or any(b < 1 for b in self.batch_sizes):
            raise ConfigError(f"invalid batch_sizes {self.batch_sizes!r}")
        if self.serve_seq_len < 1:
            raise ConfigError(
                f"serve_seq_len must be >= 1, got {self.serve_seq_len}")
        if self.max_inflight < 1:
            raise ConfigError(
                f"max_inflight must be >= 1, got {self.max_inflight}")
        return self

    # --------------------------------------------------------- serialization
    def to_dict(self) -> dict:
        """Lossless JSON-able encoding (except `token_fn`, which is code)."""

        def enc(obj):
            if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
                return {f.name: enc(getattr(obj, f.name))
                        for f in dataclasses.fields(obj)}
            if isinstance(obj, (list, tuple)):
                return [enc(x) for x in obj]
            if isinstance(obj, dict):
                return {k: enc(v) for k, v in obj.items()}
            return obj

        out = {f.name: enc(getattr(self, f.name))
               for f in dataclasses.fields(self) if f.name != "token_fn"}
        return out

    @classmethod
    def from_dict(cls, data: dict, token_fn: Callable | None = None
                  ) -> "ServeConfig":
        """Inverse of `to_dict` (validated); `token_fn` is re-attached here
        because code does not survive serialization."""
        d = dict(data)
        d.pop("token_fn", None)
        admission = d.pop("admission", None)
        replan_policy = d.pop("replan_policy", None)
        # optional for backward compat with pre-obs configs (defaults = off)
        obs = d.pop("obs", None)
        stream = d.pop("stream", None)
        faults = d.pop("faults", None)
        try:
            cfg = cls(
                cluster=ClusterSpec(**d.pop("cluster")),
                models=tuple(ModelSpec(**m) for m in d.pop("models")),
                objective=Objective(**d.pop("objective")),
                admission=(AdmissionPolicy(**admission)
                           if admission is not None else None),
                replan=ReplanConfig(**d.pop("replan")),
                replan_policy=(PolicyConfig(**replan_policy)
                               if replan_policy is not None else None),
                obs=(ObsConfig(**obs) if obs is not None else ObsConfig()),
                stream=(SourceConfig.from_dict(stream)
                        if stream is not None else None),
                faults=(FaultConfig.from_dict(faults)
                        if faults is not None else None),
                vfracs=tuple(d.pop("vfracs")),
                batch_sizes=tuple(d.pop("batch_sizes")),
                token_fn=token_fn,
                **d,
            )
        except ConfigError:
            raise
        except (TypeError, KeyError, ValueError) as exc:
            # unknown keys (TypeError), missing required sections (KeyError
            # from the pops above) and invalid nested values (ValueError,
            # e.g. a bad stream/admission section) all surface as ConfigError
            raise ConfigError(f"malformed ServeConfig dict: {exc!r}") from exc
        return cfg.validate()
