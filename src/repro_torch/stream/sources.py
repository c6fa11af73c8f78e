"""Unbounded, seed-deterministic arrival streams (ROADMAP item 1).

A `Source` produces an arrival process *lazily* — `Session.serve(source)` /
`DataPlane.serve_stream` pull one request at a time, so hours of virtual
time never materialize as a giant trace list.  Every generator here is
deterministic per seed AND per `arrivals()` call: iterating twice (or in two
processes) yields bit-identical streams, which is what lets a benchmark
serve the *same* workload through a static and a re-planned session.

Generators:

* `PoissonSource`     — homogeneous Poisson at `rate_rps`.
* `DiurnalSource`     — inhomogeneous Poisson under a sinusoidal rate curve
  (the diurnal load shape of production camera fleets), via Lewis-Shedler
  thinning against the curve's peak rate.
* `FlashCrowdSource`  — the diurnal curve with a multiplicative flash-crowd
  overlay: Poisson-spaced flash windows of `flash_mult` x rate.
* `MultiCameraSource` — deterministic heap-merge of per-camera/per-model
  child sources (ties broken by camera index), the per-tenant mix generator.
* `TraceSource`       — wraps a finite trace; yields exactly `sorted(trace)`
  (the stable sort `DataPlane.serve` applies), making it the run/serve
  parity anchor: `Session.run(trace)` == `Session.serve(TraceSource(trace))`
  bit for bit.

`build_source` turns a declarative `SourceConfig` into a live source,
resolving model names/SLOs and striping req-ids across cameras.
"""

from __future__ import annotations

import heapq
import itertools
from typing import Iterator

import numpy as np

from repro_torch.core.types import Request

from .config import SourceConfig


class Source:
    """An arrival process: `arrivals()` yields `Request`s in non-decreasing
    `arrival_s` order, possibly forever.  Each call returns a fresh,
    identical iterator (seed-determinism is part of the contract)."""

    def arrivals(self) -> Iterator[Request]:
        raise NotImplementedError

    # ------------------------------------------------------- finite views
    def take(self, n: int) -> list[Request]:
        """The first `n` arrivals (fewer if the source is finite)."""
        return list(itertools.islice(self.arrivals(), n))

    def until(self, horizon_s: float) -> list[Request]:
        """Every arrival strictly before `horizon_s` (the half-open
        [0, horizon) convention `repro_torch.data.requests` generators use)."""
        out: list[Request] = []
        for req in self.arrivals():
            if req.arrival_s >= horizon_s:
                break
            out.append(req)
        return out


class TraceSource(Source):
    """A finite trace as a Source — the run/serve parity anchor."""

    def __init__(self, trace) -> None:
        # the same stable sort DataPlane.serve applies: equal arrival times
        # keep their trace order (Request compares on arrival_s only)
        self.trace = sorted(trace)

    def arrivals(self) -> Iterator[Request]:
        return iter(self.trace)


class _ThinnedSource(Source):
    """Shared Lewis-Shedler thinning driver: subclasses provide a rate
    curve `rate(t) <= rate_max` and the driver turns a homogeneous
    Poisson(rate_max) candidate stream into the inhomogeneous process by
    accepting each candidate with probability rate(t)/rate_max."""

    def __init__(self, rate_rps: float, slo_s: float,
                 model_name: str = "model", seed: int = 0,
                 start_id: int = 0, id_stride: int = 1) -> None:
        if not rate_rps > 0:
            raise ValueError(f"rate_rps must be > 0, got {rate_rps}")
        if not slo_s > 0:
            raise ValueError(f"slo_s must be > 0, got {slo_s}")
        if id_stride < 1:
            raise ValueError(f"id_stride must be >= 1, got {id_stride}")
        self.rate_rps = float(rate_rps)
        self.slo_s = float(slo_s)
        self.model_name = model_name
        self.seed = seed
        self.start_id = start_id
        self.id_stride = id_stride

    # subclass surface ----------------------------------------------------
    def _make_rate(self, rng: np.random.Generator):
        """Return (rate(t) callable, rate_max).  `rng` is a dedicated
        stream for any schedule randomness (flash windows), so the rate
        curve stays independent of how many candidates thinning draws."""
        raise NotImplementedError

    # ---------------------------------------------------------------------
    def arrivals(self) -> Iterator[Request]:
        rng = np.random.default_rng(self.seed)
        rate, rate_max = self._make_rate(np.random.default_rng(self.seed + 1))
        inv = 1.0 / rate_max
        t = 0.0
        i = 0
        while True:
            t += rng.exponential(inv)
            if rng.random() * rate_max <= rate(t):
                yield Request(
                    arrival_s=t,
                    req_id=self.start_id + i * self.id_stride,
                    model_name=self.model_name,
                    deadline_s=t + self.slo_s,
                )
                i += 1


class PoissonSource(_ThinnedSource):
    """Homogeneous Poisson arrivals at `rate_rps`, unbounded."""

    def _make_rate(self, rng: np.random.Generator):
        r = self.rate_rps
        return (lambda t: r), r


class DiurnalSource(_ThinnedSource):
    """Sinusoidal rate curve over virtual time:

        rate(t) = rate_rps * (1 + amplitude * sin(2 pi (t + phase_s) / period_s))

    The long-run mean stays `rate_rps`; `amplitude` in [0, 1) keeps the
    curve positive.  Two sources with phases half a period apart model the
    out-of-phase day/night mix the replan loop should track."""

    def __init__(self, rate_rps: float, slo_s: float, period_s: float = 60.0,
                 amplitude: float = 0.5, phase_s: float = 0.0,
                 **kw) -> None:
        super().__init__(rate_rps, slo_s, **kw)
        if not period_s > 0:
            raise ValueError(f"period_s must be > 0, got {period_s}")
        if not 0.0 <= amplitude < 1.0:
            raise ValueError(f"amplitude must be in [0, 1), got {amplitude}")
        self.period_s = float(period_s)
        self.amplitude = float(amplitude)
        self.phase_s = float(phase_s)

    def _make_rate(self, rng: np.random.Generator):
        base, amp = self.rate_rps, self.amplitude
        w = 2.0 * np.pi / self.period_s
        ph = self.phase_s

        def rate(t: float) -> float:
            return base * (1.0 + amp * np.sin(w * (t + ph)))

        return rate, base * (1.0 + amp)


class FlashCrowdSource(DiurnalSource):
    """Diurnal curve + flash-crowd overlay: Poisson-spaced flash windows
    (mean gap `mean_flash_interval_s`, fixed width `flash_s`) multiply the
    instantaneous rate by `flash_mult`.  The flash schedule draws from a
    dedicated RNG stream, so it is a fixed function of the seed no matter
    how many candidate arrivals thinning consumes.  `amplitude=0` gives a
    flat base rate with flashes only (the pure burst overlay)."""

    def __init__(self, rate_rps: float, slo_s: float, flash_mult: float = 4.0,
                 flash_s: float = 2.0, mean_flash_interval_s: float = 20.0,
                 **kw) -> None:
        super().__init__(rate_rps, slo_s, **kw)
        if not flash_mult >= 1.0:
            raise ValueError(f"flash_mult must be >= 1, got {flash_mult}")
        if not flash_s > 0:
            raise ValueError(f"flash_s must be > 0, got {flash_s}")
        if not mean_flash_interval_s > 0:
            raise ValueError("mean_flash_interval_s must be > 0, got "
                             f"{mean_flash_interval_s}")
        self.flash_mult = float(flash_mult)
        self.flash_s = float(flash_s)
        self.mean_flash_interval_s = float(mean_flash_interval_s)

    def _make_rate(self, rng: np.random.Generator):
        diurnal, diurnal_max = super()._make_rate(rng)
        mult, width, gap = (self.flash_mult, self.flash_s,
                            self.mean_flash_interval_s)
        # lazily extended, non-overlapping flash windows: each flash starts
        # an Exp(gap) after the previous one ENDS, so windows never merge
        state = {"start": rng.exponential(gap), }
        state["end"] = state["start"] + width

        def rate(t: float) -> float:
            while t >= state["end"]:
                state["start"] = state["end"] + rng.exponential(gap)
                state["end"] = state["start"] + width
            m = mult if t >= state["start"] else 1.0
            return diurnal(t) * m

        return rate, diurnal_max * mult


class MultiCameraSource(Source):
    """Deterministic merge of per-camera child sources (ties broken by
    camera index, so the merged order is a pure function of the children).

    Req-id uniqueness across cameras is the *caller's* contract — give each
    child a distinct `start_id`/`id_stride` (camera i of n: start_id=i,
    id_stride=n), which is exactly what `build_source` wires up."""

    def __init__(self, cameras) -> None:
        self.cameras = tuple(cameras)
        if not self.cameras:
            raise ValueError("MultiCameraSource needs >= 1 camera")

    def arrivals(self) -> Iterator[Request]:
        iters = [cam.arrivals() for cam in self.cameras]
        heap: list[tuple[float, int, Request]] = []
        for ci, it in enumerate(iters):
            req = next(it, None)
            if req is not None:
                heap.append((req.arrival_s, ci, req))
        heapq.heapify(heap)
        while heap:
            _, ci, req = heapq.heappop(heap)
            yield req
            nxt = next(iters[ci], None)
            if nxt is not None:
                heapq.heappush(heap, (nxt.arrival_s, ci, nxt))


def build_source(cfg: SourceConfig, slos: dict[str, float],
                 default_model: str | None = None,
                 start_id: int = 0, id_stride: int = 1) -> Source:
    """Materialize a declarative `SourceConfig` as a live Source.

    `slos` maps model name -> profiled SLO seconds (used when the config
    leaves `slo_s` unset); `default_model` fills a config's unset `model`.
    `start_id`/`id_stride` stripe req-ids — `multi_camera` recursion widens
    the stride by the camera count so ids stay globally unique.
    """
    cfg.validate()
    if cfg.kind == "multi_camera":
        n = len(cfg.cameras)
        return MultiCameraSource(
            build_source(cam, slos, default_model,
                         start_id=start_id + i * id_stride,
                         id_stride=id_stride * n)
            for i, cam in enumerate(cfg.cameras)
        )
    model = cfg.model if cfg.model is not None else default_model
    if model is None:
        raise ValueError(f"source kind {cfg.kind!r} has no model and no "
                         "default was provided")
    slo = cfg.slo_s if cfg.slo_s is not None else slos.get(model)
    if slo is None:
        raise ValueError(f"no SLO known for model {model!r}: set "
                         "SourceConfig.slo_s or profile the model first")
    common = dict(slo_s=slo, model_name=model, seed=cfg.seed,
                  start_id=start_id, id_stride=id_stride)
    if cfg.kind == "poisson":
        return PoissonSource(cfg.rate_rps, **common)
    if cfg.kind == "diurnal":
        return DiurnalSource(cfg.rate_rps, period_s=cfg.period_s,
                             amplitude=cfg.amplitude, phase_s=cfg.phase_s,
                             **common)
    # kind == "flash" (validate() already rejected anything else)
    return FlashCrowdSource(cfg.rate_rps, period_s=cfg.period_s,
                            amplitude=cfg.amplitude, phase_s=cfg.phase_s,
                            flash_mult=cfg.flash_mult, flash_s=cfg.flash_s,
                            mean_flash_interval_s=cfg.mean_flash_interval_s,
                            **common)
