"""`Session`: the one supported way to run PPipe end to end.

A Session walks the explicit lifecycle the paper's serving system implies —

    Session.from_config(cfg)
        .profile()              # ProfileStore: analytic (or measured) tables
        .plan()                 # Planner facade -> validated ClusterPlan
        .deploy(mode="sim")     # ClusterRuntime (+ executors/dispatcher in
                                #   "real" mode) + DataPlane
        .run(trace) -> Report   # or submit(req) -> RequestHandle + drain()
        .swap(new_plan)         # managed hot-swap, warmed executors
        .report() -> Report

— replacing the hand-wired profile -> latency-table -> `Planner.plan` ->
`build_runtime` -> `build_executors` -> `calibrate_runtime` ->
`PoolDispatcher` -> `DataPlane` -> `ReplanLoop` chain every example and
benchmark used to re-implement.

Two properties the facade adds over the raw parts:

* **Warmed plan swaps** — `swap()` (and `prepare_swap()`, the overlapped
  variant) builds and warms the stage executors of any block range the
  live epoch does not already serve BEFORE the live `DataPlane.swap_plan`
  runs, reusing cached executors for unchanged ranges; the swap wall a
  caller observes excludes the warm entirely.  `prepare_swap()` warms on a
  background thread, on a CUDA stream of its own, while the old plan keeps
  serving, so a re-partitioning swap costs the same as a same-ranges
  refresh at install time.  (The reference compiles with XLA here; eager
  PyTorch compiles nothing, so warming is real launches at every batch
  bucket, which also settles the allocator's pools.)
* **Exact parity with the raw parts** — `run(trace)` drives the identical
  `DataPlane.serve` the hand-wired path drives, with identical defaults, so
  telemetry is float-identical to pre-facade code (tests/test_api.py pins
  this for the reference, tests/test_torch_api.py for the port against it).

Real mode runs on CUDA unless the session is given another device
(`Session(config, device="cpu")`, as the CPU tests do): parameters come
from `torch.Generator(device).manual_seed(config.seed)`.
"""

from __future__ import annotations

import contextlib
import threading
import time
from dataclasses import dataclass, field

import torch

from repro_torch.controlplane.planner import Objective, Planner
from repro_torch.controlplane.profiles import ProfileStore
from repro_torch.controlplane.replan import ReplanLoop, ReplanPolicy
from repro_torch.core import blocks, costmodel as cm
from repro_torch.core.plan import ClusterPlan
from repro_torch.core.runtime import ClusterRuntime, build_runtime
from repro_torch.core.types import ClusterSpec, ModelProfile, Request, RequestOutcome, replace
from repro_torch.dataplane.metrics import Telemetry
from repro_torch.dataplane.plane import DataPlane
from repro_torch.obs import Observer

from .config import ConfigError, ModelSpec, ServeConfig


class LifecycleError(RuntimeError):
    """A Session method was called out of lifecycle order."""


# ---------------------------------------------------------------------------
# Profiling helpers (the analytic offline profiler, shared with benchmarks)
# ---------------------------------------------------------------------------


def profile_model(spec: ModelSpec, cluster: ClusterSpec) -> ModelProfile:
    """Profile one ModelSpec on a cluster: analytic layer costs ->
    pre-partitioned blocks -> SLO pinned at `slo_scale` x the batch-1
    full-model latency on the fastest class (paper section 7.1)."""
    from repro_torch.configs import get_config
    from repro_torch.models.model_zoo import layer_costs

    cfg = get_config(spec.arch)
    if spec.reduced:
        cfg = cfg.reduced(**spec.reduced)
    costs = layer_costs(cfg, spec.seq_len)
    fastest = max((cluster.accel(c) for c in cluster.classes),
                  key=lambda a: a.peak_flops)
    prof = blocks.build_profile(cfg.name, costs, slo_s=1.0,
                                n_blocks=spec.n_blocks, accel=fastest)
    if spec.slo_s is not None:
        slo = spec.slo_s
    else:
        slo = spec.slo_scale * sum(
            cm.block_latency(b, fastest, 1, 1) for b in prof.blocks)
    return replace(prof, slo_s=slo)


def build_profile_store(cluster: ClusterSpec, specs, vfracs=cm.VFRACS,
                        batch_sizes=cm.BATCH_SIZES) -> ProfileStore:
    """ProfileStore over `specs` with analytic tables on the given axes —
    the profiling step of the lifecycle as a standalone helper (what
    `benchmarks.common.make_setup` now routes through)."""
    store = ProfileStore(cluster, vfracs=tuple(vfracs),
                         batch_sizes=tuple(batch_sizes))
    for spec in specs:
        store.add(profile_model(spec, cluster))
    return store


# ---------------------------------------------------------------------------
# Handles and reports
# ---------------------------------------------------------------------------


@dataclass
class RequestHandle:
    """Future-like view of one submitted request.

    Resolves when the session serves it (`drain()`/`run()`); `result()`
    drains on demand.  `outcome.completion_s is None` means dropped.
    """

    request: Request
    _session: Session = field(repr=False)
    outcome: RequestOutcome | None = None

    @property
    def done(self) -> bool:
        return self.outcome is not None

    @property
    def deadline_s(self) -> float:
        return self.request.deadline_s

    @property
    def ok(self) -> bool:
        """Completed within SLO (False while pending or after a drop)."""
        return self.outcome is not None and self.outcome.ok

    @property
    def latency_s(self) -> float | None:
        """Arrival-to-completion virtual seconds; None if pending/dropped."""
        if self.outcome is None or self.outcome.completion_s is None:
            return None
        return self.outcome.completion_s - self.request.arrival_s

    def result(self) -> RequestOutcome:
        """The request's outcome, draining the session if still pending."""
        if self.outcome is None:
            self._session.drain()
        if self.outcome is None:  # not part of any served trace
            raise LifecycleError(
                f"request {self.request.req_id} was never served")
        return self.outcome


@dataclass(frozen=True)
class SwapRecord:
    """One managed plan swap: where the time went and what was reused."""

    t_s: float  # virtual time of the install
    reason: str
    swap_wall_s: float  # live swap_plan wall — the warm excluded
    # wall spent waiting on the executors' warm (the reference's name: it
    # compiles there; the port's eager executors compile nothing)
    compile_wall_s: float
    new_ranges: tuple = ()  # (model, block_start, block_end) built fresh
    reused_executors: int = 0  # stage executors served from the cache
    prepared: bool = False  # warmed ahead of time (prepare_swap)

    def as_dict(self) -> dict:
        return {
            "t_s": self.t_s,
            "reason": self.reason,
            "swap_wall_s": self.swap_wall_s,
            "compile_wall_s": self.compile_wall_s,
            "new_ranges": [list(r) for r in self.new_ranges],
            "reused_executors": self.reused_executors,
            "prepared": self.prepared,
        }


@dataclass
class Report:
    """Rollup of one session's serving so far: the live Telemetry plus the
    records of explicit `Session.swap()` calls.  Thin by design —
    `telemetry` is the full object (float-identical to the hand-wired
    path), the properties are the numbers every caller wants.  Swaps
    installed by an attached ReplanLoop do not produce SwapRecords (they
    bypass `Session.swap`); their trail is `telemetry.swap_log` /
    `telemetry.replan_decisions` / `telemetry.plan_swaps`.

    When the session observes (``ServeConfig.obs.level != "off"``), `obs`
    carries the live `repro_torch.obs.Observer`: `timeseries()` is the rolling-
    window series, `export_trace(path)` the Perfetto trace_event JSON."""

    telemetry: Telemetry
    swaps: tuple[SwapRecord, ...] = ()
    obs: Observer | None = None

    @property
    def attainment(self) -> float:
        return self.telemetry.attainment

    @property
    def goodput_rps(self) -> float:
        return self.telemetry.goodput_rps

    @property
    def served(self) -> int:
        return self.telemetry.served

    @property
    def dropped(self) -> int:
        return self.telemetry.dropped

    @property
    def utilization(self) -> dict:
        return dict(self.telemetry.utilization)

    @property
    def plan_swaps(self) -> int:
        return self.telemetry.plan_swaps

    def timeseries(self) -> dict:
        """Per-window metric series (`repro_torch.obs.WindowedMetrics.series`);
        empty dict when the session serves with observability off."""
        return self.obs.timeseries() if self.obs is not None else {}

    def export_trace(self, path) -> None:
        """Write the Perfetto trace_event JSON to `path` (trace level only
        yields request/stage spans; raises when observability is off)."""
        if self.obs is None:
            raise LifecycleError(
                "export_trace() needs ServeConfig.obs.level != 'off'")
        self.obs.export_perfetto(path)

    def as_dict(self) -> dict:
        out = {**self.telemetry.snapshot(),
               "managed_swaps": [s.as_dict() for s in self.swaps]}
        if self.obs is not None:
            out["timeseries"] = self.timeseries()
        return out

    def summary(self) -> str:
        s = self.telemetry.summary()
        if self.swaps:
            s += f"; managed swaps {len(self.swaps)}"
        return s


class _PreparedSwap:
    """Background warm of a plan's missing stage executors."""

    def __init__(self, session: Session, plan: ClusterPlan) -> None:
        self.plan = plan
        self.new_ranges: tuple = ()
        self.reused: int = 0
        self.warm_wall_s: float = 0.0
        self.error: BaseException | None = None

        def work() -> None:
            t0 = time.perf_counter()
            try:
                self.new_ranges, self.reused = session._warm_executors(plan)
            except BaseException as exc:  # re-raised at swap() time
                self.error = exc
            finally:
                self.warm_wall_s = time.perf_counter() - t0

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def ready(self) -> bool:
        return not self._thread.is_alive()

    def wait(self) -> _PreparedSwap:
        self._thread.join()
        if self.error is not None:
            raise self.error
        return self


# ---------------------------------------------------------------------------
# The Session facade
# ---------------------------------------------------------------------------


_NEW, _PROFILED, _PLANNED, _DEPLOYED, _CLOSED = (
    "new", "profiled", "planned", "deployed", "closed")


class Session:
    """One serving deployment, from declarative config to drained report.

    Lifecycle: ``new -> profiled -> planned -> deployed -> closed``.
    `plan()` auto-profiles and `deploy()` auto-plans (each earlier step runs
    at most once), but serving calls (`submit`/`run`/`swap`/
    `enable_replanning`) strictly require a deployed session, and
    `deploy()` on a deployed session raises — swapping plans is `swap()`'s
    job, not a second deploy.
    """

    def __init__(self, config: ServeConfig, *,
                 store: ProfileStore | None = None,
                 device: torch.device | str | None = None) -> None:
        self.config = config.validate()
        # where real mode runs: CUDA unless the caller names another device
        self.device = torch.device("cuda" if device is None else device)
        self._planner = Planner(backend=config.backend,
                                objective=config.objective)
        # a caller-provided store shares profiling across sessions (the
        # benchmark sweep pattern); profile() tops it up as needed
        self._store = store
        self._plan: ClusterPlan | None = None
        self._dp: DataPlane | None = None
        self._observer: Observer | None = None
        self._mode: str | None = None
        self._replan_loop: ReplanLoop | None = None
        self._state = _NEW
        self._vnow = 0.0
        self.swaps: list[SwapRecord] = []
        # request handles: open (unresolved) by req_id + outcome cursor
        self._open: dict[int, RequestHandle] = {}
        self._pending: list[Request] = []
        self._resolved_upto = 0
        # real-execution state: per-model configs/params + the executor
        # cache keyed (model, block_start, block_end) that swap() reuses
        self._cfgs: dict[str, object] = {}
        self._lbms: dict[str, list] = {}
        self._params: dict[str, dict] = {}
        self._exec_cache: dict[tuple[str, int, int], object] = {}
        self._build_lock = threading.Lock()
        self._prepared: _PreparedSwap | None = None
        self._generator: torch.Generator | None = None
        self._injector = None  # FaultInjector when config.faults is set

    # ------------------------------------------------------------- plumbing
    @classmethod
    def from_config(cls, config: ServeConfig, *,
                    store: ProfileStore | None = None,
                    device: torch.device | str | None = None) -> Session:
        return cls(config, store=store, device=device)

    def __enter__(self) -> Session:
        return self

    def __exit__(self, *exc) -> None:
        self.shutdown()

    def _forbid_closed(self, op: str) -> None:
        if self._state == _CLOSED:
            raise LifecycleError(f"{op}() on a closed session")

    def _require_deployed(self, op: str) -> None:
        self._forbid_closed(op)
        if self._state != _DEPLOYED:
            raise LifecycleError(
                f"{op}() requires a deployed session (state={self._state!r});"
                " call deploy() first")

    @property
    def state(self) -> str:
        return self._state

    @property
    def store(self) -> ProfileStore:
        if self._store is None:
            raise LifecycleError("profile() has not run yet")
        return self._store

    @property
    def cluster_plan(self) -> ClusterPlan:
        if self._plan is None:
            raise LifecycleError("plan() has not run yet")
        return self._plan

    @property
    def runtime(self) -> ClusterRuntime:
        self._require_deployed("runtime")
        return self._dp.rt

    @property
    def dataplane(self) -> DataPlane:
        self._require_deployed("dataplane")
        return self._dp

    @property
    def telemetry(self) -> Telemetry:
        self._require_deployed("telemetry")
        return self._dp.tel

    # ------------------------------------------------------------ lifecycle
    def profile(self) -> ProfileStore:
        """Build (or top up) the ProfileStore: one ModelProfile + analytic
        latency table per ModelSpec.  Idempotent."""
        self._forbid_closed("profile")
        cfg = self.config
        if self._store is None:
            self._store = ProfileStore(cfg.cluster,
                                       vfracs=tuple(cfg.vfracs),
                                       batch_sizes=tuple(cfg.batch_sizes))
        for spec in cfg.models:
            from repro_torch.configs import get_config

            mcfg = get_config(spec.arch)
            if spec.reduced:
                mcfg = mcfg.reduced(**spec.reduced)
            if mcfg.name not in self._store.profiles:
                self._store.add(profile_model(spec, cfg.cluster))
            self._cfgs[mcfg.name] = mcfg
        if self._state == _NEW:
            self._state = _PROFILED
        return self._store

    def _weights(self, objective: Objective) -> Objective:
        if objective.weights is not None:
            return objective
        return objective.with_weights(
            {self._cfgs[s.arch].name if s.arch in self._cfgs else s.arch:
             s.weight for s in self.config.models})

    def solve(self, backend: str | None = None,
              objective: Objective | None = None) -> ClusterPlan:
        """Pure solve through the Planner facade (no install): profiles if
        needed, prices from `config.source` tables.  `backend`/`objective`
        override the config for baselines and what-if exploration."""
        self._forbid_closed("solve")
        store = self.profile()
        obj = self._weights(objective or self.config.objective)
        planner = (self._planner if backend in (None, self.config.backend)
                   else Planner(backend=backend, objective=obj))
        return planner.plan(dict(store.profiles),
                            store.tables(self.config.source),
                            self.config.cluster, objective=obj)

    def plan(self, objective: Objective | None = None) -> ClusterPlan:
        """Solve with the configured backend and adopt the result as the
        plan `deploy()` will install.  Re-callable until deployed (the last
        plan wins); after deploy, install new plans via `swap()`."""
        self._forbid_closed("plan")
        if self._state == _DEPLOYED:
            raise LifecycleError("plan() after deploy(); use swap() to "
                                 "install a new plan on a live session")
        self._plan = self.solve(objective=objective)
        self._state = _PLANNED
        return self._plan

    def use_plan(self, plan: ClusterPlan, slo_margin: float = 0.0
                 ) -> ClusterPlan:
        """Adopt an externally built plan (validated) instead of solving —
        the hook for hand-pinned partitionings and plan replay."""
        self._forbid_closed("use_plan")
        if self._state == _DEPLOYED:
            raise LifecycleError("use_plan() after deploy(); use swap()")
        store = self.profile()
        plan.validate(dict(store.profiles), slo_margin=slo_margin)
        self._plan = plan
        self._state = _PLANNED
        return plan

    def deploy(self, mode: str = "sim") -> Session:
        """Materialize the plan: ClusterRuntime + DataPlane; in "real" mode
        additionally stage executors on the session's device (parameters
        from a generator seeded with `config.seed`), a PoolDispatcher, and
        (for measured feedback / `config.calibrate`) the offline calibration
        pass.  One deploy per session; plan changes after deploy go through
        `swap()`."""
        self._forbid_closed("deploy")
        if self._state == _DEPLOYED:
            raise LifecycleError(
                "deploy() called twice; use swap() to install a new plan")
        if mode not in ("sim", "real"):
            raise ConfigError(f"mode must be sim|real, got {mode!r}")
        cfg = self.config
        if mode == "sim" and cfg.feedback == "measured":
            raise LifecycleError(
                'feedback="measured" requires deploy(mode="real")')
        if self._plan is None:
            self.plan()
        profiles = dict(self.store.profiles)
        runtime = build_runtime(self._plan, profiles)
        dispatcher = None
        if mode == "real":
            from repro_torch.dataplane.dispatcher import PoolDispatcher
            from repro_torch.dataplane.plane import calibrate_runtime

            self._generator = torch.Generator(self.device).manual_seed(cfg.seed)
            executors = self._executors_for(self._plan)
            if self.device.type == "cuda":
                # capture every stage's graphs before anything runs them
                # (the reference compiles at first call instead)
                self._warm_executors(self._plan)
            if self._should_calibrate():
                calibrate_runtime(runtime, executors, cfg.serve_seq_len,
                                  token_fn=cfg.token_fn)
            dispatcher = PoolDispatcher.from_runtime(
                runtime, executors, max_inflight=cfg.max_inflight)
        # level "off" means no Observer object at all: every data-plane
        # hook stays a single `is not None` check (decision-identical path)
        self._observer = (Observer(cfg.obs)
                          if cfg.obs.level != "off" else None)
        self._dp = DataPlane(
            runtime,
            dispatcher=dispatcher,
            policy=cfg.admission,
            feedback=cfg.feedback if mode == "real" else "planned",
            seq_len=cfg.serve_seq_len,
            token_fn=cfg.token_fn,
            gc_interval_s=cfg.gc_interval_s,
            observer=self._observer,
        )
        self._dp.arrival_hooks.append(self._observe_arrival)
        self._mode = mode
        self._state = _DEPLOYED
        if cfg.faults is not None:
            from repro_torch.faults import FaultInjector

            # planned membership events (node_join/node_drain) route through
            # Session.resize; abrupt ones the injector applies to the plane
            self._injector = FaultInjector.from_config(
                cfg.faults, on_resize=self._on_fault_resize).attach(self._dp)
        return self

    def shutdown(self) -> None:
        """Close the session: block on in-flight real batches and fold
        their measurements into telemetry.  Idempotent; every lifecycle
        call after this raises."""
        if self._state == _CLOSED:
            return
        if self._dp is not None:
            self._dp._harvest_measurements()
        self._state = _CLOSED

    # -------------------------------------------------------------- serving
    def _observe_arrival(self, req: Request, now: float) -> None:
        if now > self._vnow:
            self._vnow = now

    def on_arrival(self, hook) -> None:
        """Register `hook(request, now)` on the arrival stream (fired after
        admission) — the seam scenario scripts use to trigger mid-trace
        actions such as `swap()`."""
        self._require_deployed("on_arrival")
        self._dp.arrival_hooks.append(hook)

    def submit(self, req: Request) -> RequestHandle:
        """Enqueue one request; returns its future-like handle.  Requests
        accumulate until `drain()`/`run()` serves them (the data plane runs
        on a virtual clock, so serving is batch-replayed, not threaded).

        The session serves ONE monotonic virtual clock: across successive
        drains, arrivals must not restart behind the horizon already
        served — the deployed runtime keeps its reservations, so a
        t=0-again trace would queue behind ghosts of the previous one.
        `drain()` rejects that loudly; offset the new trace's arrivals or
        use a fresh Session per independent replay."""
        self._require_deployed("submit")
        if req.req_id in self._open:
            raise ConfigError(f"duplicate pending req_id {req.req_id}")
        handle = RequestHandle(request=req, _session=self)
        self._open[req.req_id] = handle
        self._pending.append(req)
        return handle

    def drain(self) -> Report:
        """Serve every pending submission to completion and resolve their
        handles; returns the rolled-up report.  Raises LifecycleError if
        the pending arrivals restart behind the served horizon (see
        `submit` — one session, one monotonic virtual clock)."""
        self._require_deployed("drain")
        if self._pending:
            first = min(r.arrival_s for r in self._pending)
            served_until = self._dp.tel.horizon_s
            if served_until > 0.0 and first < served_until - 1e-9:
                raise LifecycleError(
                    f"pending arrivals start at t={first:.6f}s, behind the "
                    f"horizon this session already served "
                    f"({served_until:.6f}s); the deployed runtime keeps its "
                    "reservations, so the trace would spuriously queue "
                    "behind the previous one — offset the arrivals or "
                    "replay on a fresh Session")
            reqs, self._pending = self._pending, []
            self._dp.serve(reqs)
            self._resolve_outcomes()
        return self.report()

    def run(self, trace) -> Report:
        """Serve a whole arrival trace (the scenario-script entry point):
        submit every request, drain, report.  Telemetry is float-identical
        to driving `DataPlane.serve(trace)` by hand on the same deployment."""
        self._require_deployed("run")
        for req in trace:
            self.submit(req)
        return self.drain()

    def build_source(self, scfg=None):
        """Materialize a `SourceConfig` (default: ``config.stream``) against
        this session's profiled models: unset per-source SLOs resolve to the
        profiled `slo_s`, an unset model to the first configured model."""
        self._forbid_closed("build_source")
        from repro_torch.stream import build_source

        scfg = scfg if scfg is not None else self.config.stream
        if scfg is None:
            raise LifecycleError(
                "build_source() needs a SourceConfig (argument or "
                "ServeConfig.stream)")
        store = self.profile()
        slos = {name: prof.slo_s for name, prof in store.profiles.items()}
        return build_source(scfg, slos,
                            default_model=next(iter(self._cfgs), None))

    def serve(self, source=None, horizon_s: float | None = None) -> Report:
        """Open-loop serving: pull arrivals from `source` (a `repro_torch.stream`
        Source; default: one built from ``config.stream``) incrementally
        through the data plane until `horizon_s` virtual seconds of arrivals
        have been admitted (arrivals at/after the horizon are never
        admitted; admitted work drains to completion), then report.

        `horizon_s=None` is allowed only for a `TraceSource` (finite by
        construction) — an unbounded generator would serve forever.  The
        parity anchor: ``serve(TraceSource(trace))`` is bit-for-bit
        identical to ``run(trace)`` on an identically configured session.

        Like `run`/`drain`, serving shares the session's single monotonic
        virtual clock: a second serve whose arrivals restart behind the
        horizon already served is rejected loudly."""
        self._require_deployed("serve")
        if self._pending:
            raise LifecycleError(
                "serve() with submit()ed requests pending; drain() them "
                "first — one virtual clock cannot interleave a stream with "
                "a batch replay")
        if source is None:
            source = self.build_source()
        from repro_torch.stream import TraceSource

        if horizon_s is None and not isinstance(source, TraceSource):
            raise LifecycleError(
                "serve() needs horizon_s for a potentially unbounded "
                f"source ({type(source).__name__}); only TraceSource is "
                "finite by construction")
        arrivals = source.arrivals()
        served_until = self._dp.tel.horizon_s
        if served_until > 0.0:
            first = next(arrivals, None)
            if first is not None:
                if first.arrival_s < served_until - 1e-9:
                    raise LifecycleError(
                        f"source arrivals start at t={first.arrival_s:.6f}s, "
                        f"behind the horizon this session already served "
                        f"({served_until:.6f}s); offset the source or serve "
                        "on a fresh Session")
                import itertools

                arrivals = itertools.chain((first,), arrivals)
        self._dp.serve_stream(arrivals, horizon_s=horizon_s)
        self._resolve_outcomes()
        return self.report()

    def _resolve_outcomes(self) -> None:
        outcomes = self._dp.tel.outcomes
        for i in range(self._resolved_upto, len(outcomes)):
            handle = self._open.pop(outcomes[i].req_id, None)
            if handle is not None:
                handle.outcome = outcomes[i]
        self._resolved_upto = len(outcomes)

    def report(self) -> Report:
        """Current rollup: SLO attainment, goodput, utilization, drops,
        swap records — live (callable mid-lifecycle and after drain)."""
        self._require_deployed("report")
        return Report(telemetry=self._dp.tel, swaps=tuple(self.swaps),
                      obs=self._observer)

    # ------------------------------------------------------------ executors
    def _layer_block_map(self, model: str) -> list:
        lbm = self._lbms.get(model)
        if lbm is None:
            from repro_torch.serving.engine import layer_block_map_from_profile

            prof = self.store.profiles[model]
            lbm = layer_block_map_from_profile(prof, self._cfgs[model].n_layers)
            self._lbms[model] = lbm
        return lbm

    def _model_params(self, model: str) -> dict:
        params = self._params.get(model)
        if params is None:
            from repro_torch.models.model_zoo import build_model

            params = build_model(self._cfgs[model]).init(self._generator)
            self._params[model] = params
        return params

    def _build_ranges(self, model: str, ranges: list[tuple[int, int]]) -> None:
        """Build stage executors for a model's missing block ranges in ONE
        split_stages pass (the model graph is constructed once, parameters
        are shared), caching each under (model, b0, b1)."""
        from repro_torch.serving.engine import StageExecutor, split_stages

        with self._build_lock:
            todo = sorted({r for r in ranges
                           if (model, *r) not in self._exec_cache})
            if not todo:
                return
            _, fns = split_stages(self._cfgs[model], todo,
                                  self._layer_block_map(model))
            params = self._model_params(model)
            for (b0, b1), fn in zip(todo, fns):
                self._exec_cache[(model, b0, b1)] = StageExecutor(
                    stage_fn=fn, params=params,
                    quantize_boundary=self.config.quantize_boundary)

    def _executors_for(self, plan: ClusterPlan) -> dict:
        """{pipeline_id: [StageExecutor per stage]} for a plan, from the
        shared range cache.  Missing ranges are built (batched per model);
        building runs nothing on the device, `_warm_executors` is what
        runs each new executor once off the serving path."""
        missing: dict[str, list[tuple[int, int]]] = {}
        for pp in plan.pipelines:
            for s in pp.stages:
                if (pp.model_name, s.block_start, s.block_end) not in self._exec_cache:
                    missing.setdefault(pp.model_name, []).append(
                        (s.block_start, s.block_end))
        for model, ranges in missing.items():
            self._build_ranges(model, ranges)
        return {
            pid: [self._exec_cache[(pp.model_name, s.block_start, s.block_end)]
                  for s in pp.stages]
            for pid, pp in enumerate(plan.pipelines)
        }

    def missing_ranges(self, plan: ClusterPlan) -> list[tuple[str, int, int]]:
        """Block ranges `plan` needs that no cached executor covers yet —
        what a swap to this plan would have to build and warm."""
        needed = {(pp.model_name, s.block_start, s.block_end)
                  for pp in plan.pipelines for s in pp.stages}
        return sorted(k for k in needed if k not in self._exec_cache)

    def _warm_executors(self, plan: ClusterPlan) -> tuple[tuple, int]:
        """Build + warm every executor `plan` needs; returns (freshly built
        ranges, reused executor count).  Warming runs each affected
        pipeline chain at every power-of-two batch bucket up to its unified
        batch, so the first batches served meet warm allocator pools and
        built kernels.

        On CUDA the warm runs on a stream of its own, ordered after what
        this thread queued before it, and the host waits only for that
        stream: `prepare_swap` calls this from a background thread while
        the dispatcher serves on the serving thread's stream, and the warm
        must neither queue behind that work nor touch its timing events.
        Parameters are shared read-only between the two.  There each stage
        runs eagerly at each bucket and is then captured at that shape as a
        CUDA graph (`StageExecutor.capture`, the counterpart of the
        reference's jit compile); a pipeline whose executors were all built
        before is warmed again if one of them lacks a bucket's graph (the
        epoch GC releases the graphs of executors no plan serves with)."""
        from repro_torch.dataplane.plane import _default_tokens

        missing = tuple(self.missing_ranges(plan))
        execs_by_pid = self._executors_for(plan)
        device = self.device
        token_fn = self.config.token_fn or (
            lambda n, seq_len: _default_tokens(n, seq_len, device))
        fresh = set(missing)
        total = 0
        stream = (torch.cuda.Stream(device) if device.type == "cuda"
                  else None)
        if stream is not None:
            # order the warm after whatever this thread queued so far (a
            # new model's parameter initialisation in _executors_for)
            stream.wait_stream(torch.cuda.current_stream(device))
        for pid, pp in enumerate(plan.pipelines):
            keys = [(pp.model_name, s.block_start, s.block_end)
                    for s in pp.stages]
            total += len(keys)
            # warm every batch bucket serving can produce: the default
            # token_fn pads dispatched batches to the next power of two
            # (plane._default_tokens), so pow2 buckets up to the unified
            # batch cover every stage shape.  A custom token_fn is fed the
            # same bucket sizes it will see live.
            buckets = [1]
            while buckets[-1] < pp.batch_size:
                buckets.append(buckets[-1] * 2)
            execs = execs_by_pid[pid]
            if not fresh.intersection(keys) and not (
                    stream is not None and any(
                        not set(buckets) <= {k[0][0] for k in ex.graphs}
                        for ex in execs)):
                continue  # fully cached pipeline: nothing to warm
            with torch.inference_mode(), (torch.cuda.stream(stream)
                                          if stream is not None
                                          else contextlib.nullcontext()):
                for b in buckets:
                    carry = token_fn(b, self.config.serve_seq_len)
                    for si, ex in enumerate(execs):
                        if si > 0:
                            carry = ex.transfer(carry)
                        if stream is None:
                            carry = ex(carry)
                            continue
                        out = ex.stage_fn(ex.params, carry)
                        ex.capture(carry)
                        carry = out
            if stream is not None:
                stream.synchronize()
        return missing, total - len(missing)

    # ------------------------------------------------------------- hot swap
    def _dispatcher_factory(self, new_rt: ClusterRuntime):
        """The factory `DataPlane.swap_plan` calls before its point of no
        return.  Builds and warms whatever the plan needs that the cache
        lacks (a no-op when `swap()`/`prepare_swap()` already did it), so
        even ReplanLoop-driven swaps — which call swap_plan directly — never
        leave that work for the serving path."""
        from repro_torch.dataplane.dispatcher import PoolDispatcher

        self._warm_executors(new_rt.plan)
        return PoolDispatcher.from_runtime(
            new_rt, self._executors_for(new_rt.plan),
            max_inflight=self.config.max_inflight)

    def _runtime_setup(self):
        """The `runtime_setup` hook swap_plan runs on the new runtime before
        any carried request is re-admitted: re-calibrate at measured speed
        (real calibrated deployments) or re-price through the ProfileStore's
        measured ratios (`config.source == "measured"`)."""
        cfg = self.config
        if self._mode == "real" and self._should_calibrate():
            def setup(rt: ClusterRuntime) -> None:
                from repro_torch.dataplane.plane import calibrate_runtime

                calibrate_runtime(rt, self._executors_for(rt.plan),
                                  cfg.serve_seq_len, token_fn=cfg.token_fn)

            return setup
        if cfg.source == "measured":
            return self.store.reprice_runtime
        return None

    def _should_calibrate(self) -> bool:
        cfg = self.config
        return (cfg.feedback == "measured" if cfg.calibrate is None
                else cfg.calibrate)

    def prepare_swap(self, plan: ClusterPlan) -> _PreparedSwap:
        """Start building and warming `plan`'s missing stage executors on a
        background thread while the current plan keeps serving.  The next
        `swap(plan)` waits for readiness (usually instant) and installs —
        re-partitioning swaps stop paying the warm inside the swap."""
        self._require_deployed("prepare_swap")
        if self._mode != "real":
            raise LifecycleError("prepare_swap() only applies to real "
                                 "deployments (sim swaps build nothing)")
        self._prepared = _PreparedSwap(self, plan)
        return self._prepared

    def swap(self, plan: ClusterPlan | None = None, *, now: float | None = None,
             reason: str | None = None, objective: Objective | None = None,
             slo_margin: float | None = None) -> SwapRecord:
        """Install a new plan on the live session without dropping in-flight
        work (drain-and-swap, `DataPlane.swap_plan` semantics).

        `plan=None` re-solves through the Planner at the configured source
        first.  In real mode, stage executors for block ranges the session
        has not built yet are built and warmed BEFORE the live swap — via
        the pending `prepare_swap()` result when one matches, else inline —
        and executors for unchanged ranges are reused, so `swap_wall_s` in
        the returned record never includes the warm.  `now` defaults to
        the latest observed virtual arrival time (pass it explicitly from
        an `on_arrival` hook for exact placement)."""
        self._require_deployed("swap")
        profiles = dict(self.store.profiles)
        solved = plan is None
        obj = self._weights(objective or self.config.objective)
        if solved:
            plan = self.solve(objective=objective)
        if slo_margin is None:
            # solver plans are re-validated at the margin they were solved
            # for; externally pinned plans default to the lenient bound
            slo_margin = obj.slo_margin if solved else 0.0
        now = self._vnow if now is None else now
        prepared = False
        new_ranges: tuple = ()
        reused = 0
        t0 = time.perf_counter()
        if self._mode == "real":
            pre, self._prepared = self._prepared, None
            if pre is not None and pre.plan is plan:
                pre.wait()
                new_ranges, reused, prepared = pre.new_ranges, pre.reused, True
            else:
                new_ranges, reused = self._warm_executors(plan)
        warm_wall = time.perf_counter() - t0
        t1 = time.perf_counter()
        self._dp.swap_plan(
            plan, profiles, now,
            dispatcher_factory=(self._dispatcher_factory
                                if self._mode == "real" else None),
            runtime_setup=self._runtime_setup(),
            slo_margin=slo_margin,
            reason=reason or ("replan" if solved else "managed-swap"),
        )
        rec = SwapRecord(
            t_s=now,
            reason=reason or ("replan" if solved else "managed-swap"),
            swap_wall_s=time.perf_counter() - t1,
            compile_wall_s=warm_wall,
            new_ranges=new_ranges,
            reused_executors=reused,
            prepared=prepared,
        )
        self.swaps.append(rec)
        self._plan = plan
        return rec

    # ------------------------------------------------------ elastic resize
    def _on_fault_resize(self, ev, now: float) -> None:
        """FaultInjector callback for planned membership events: translate a
        node_join/node_drain FaultEvent into a per-class chip delta."""
        cph = self.config.cluster.chips_per_host
        delta = ev.count * cph * (1 if ev.kind == "node_join" else -1)
        self.resize({ev.accel_class: delta}, now=now, reason=ev.kind)

    def resize(self, cluster_delta: dict[str, int], *,
               now: float | None = None, reason: str = "resize"
               ) -> SwapRecord:
        """Planned elastic resize: apply a per-class chip-count delta to the
        live cluster, re-solve on the new inventory (warm-started from the
        incumbent plan when it still fits), and install via the managed
        drain-and-swap path.

        Scale-down is graceful by construction: the swap retires departing
        pools through the epoch lifecycle, so in-flight batches finish on
        the old runtime and queued requests re-admit to the new one — zero
        in-flight loss (contrast `DataPlane.fail_host`, the abrupt path).
        The session's frozen config is replaced with the resized cluster so
        later solves/replans plan against the new inventory."""
        self._require_deployed("resize")
        cfg = self.config
        counts = dict(cfg.cluster.counts)
        for cname, delta in cluster_delta.items():
            n = counts.get(cname, 0) + delta
            if n > 0:
                counts[cname] = n
            else:
                counts.pop(cname, None)
        if not counts:
            raise ConfigError(
                f"resize {cluster_delta} removes every accelerator class")
        new_cluster = ClusterSpec(counts=counts,
                                  chips_per_host=cfg.cluster.chips_per_host,
                                  nic_derate=cfg.cluster.nic_derate)
        now = self._vnow if now is None else now
        if self._observer is not None:
            self._observer.on_resize_start(now, dict(cfg.cluster.counts),
                                           dict(counts), reason)
        store = self.store
        obj = self._weights(cfg.objective)
        # the live plan warm-starts the re-solve only when it still fits the
        # resized inventory — an over-allocating incumbent would hand the
        # solver an unattainable objective cutoff
        incumbent = self._plan
        if incumbent is not None and not all(
                incumbent.cluster.counts.get(c, 0) <= counts.get(c, 0)
                for c in incumbent.cluster.counts):
            incumbent = None
        plan = self._planner.plan(dict(store.profiles),
                                  store.tables(cfg.source), new_cluster,
                                  objective=obj, incumbent=incumbent)
        if not plan.pipelines:
            raise LifecycleError(
                f"resize to {counts} is infeasible: the solver found no "
                "feasible plan — the old plan keeps serving")
        # adopt the new inventory before the install so an attached replan
        # loop (and any later solve) prices against it
        self.config = replace(cfg, cluster=new_cluster).validate()
        if self._replan_loop is not None:
            self._replan_loop.cluster = new_cluster
        rec = self.swap(plan=plan, now=now, reason=f"{reason}@{now:.3f}s",
                        slo_margin=obj.slo_margin)
        self._dp.tel.resizes += 1
        if self._observer is not None:
            swaps = self._dp.obs.journal.select("plan.swap")
            carried = swaps[-1]["carried"] if swaps else 0
            self._observer.on_resize_complete(
                now, dict(counts), carried, self._planner.last_wall_s)
        return rec

    # ------------------------------------------------------- managed replan
    def enable_replanning(self, baseline_rates: dict[str, float] | None = None
                          ) -> ReplanLoop:
        """Attach the slow control loop (`ReplanLoop` + optional
        `ReplanPolicy` gate from the config) to the live data plane, with
        the dispatcher factory / runtime-setup closures auto-wired.  Drift
        past the internal trip thresholds re-solves through the Planner and
        installs via the same drain-and-swap path `swap()` uses."""
        self._require_deployed("enable_replanning")
        cfg = self.config
        loop = ReplanLoop(
            planner=self._planner,
            store=self.store,
            cluster=cfg.cluster,
            dataplane=self._dp,
            config=cfg.replan,
            objective=self._weights(cfg.objective),
            dispatcher_factory=(self._dispatcher_factory
                                if self._mode == "real" else None),
            # calibrated real deployments re-calibrate every loop-installed
            # runtime (supersedes the loop's measured-source repricing
            # default; a sim session leaves None so that default applies)
            runtime_setup=(self._runtime_setup()
                           if self._mode == "real" and self._should_calibrate()
                           else None),
            policy=(ReplanPolicy(cfg.replan_policy)
                    if cfg.replan_policy is not None else None),
        ).attach()
        if baseline_rates is not None:
            loop.set_baseline(baseline_rates)
        self._replan_loop = loop
        return loop
