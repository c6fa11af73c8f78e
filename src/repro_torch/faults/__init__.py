"""Deterministic, seed-replayable fault injection for serving and training.

The fleet-churn model (DESIGN.md §13): clusters grow, shrink, and lose
nodes while serving.  Every capacity change is one of five event kinds:

* ``node_join``    — planned: a host of some class joins (graceful resize).
* ``node_drain``   — planned: a host leaves after draining in-flight work.
* ``node_loss``    — abrupt: spot preemption; the host vanishes mid-batch.
* ``chip_slowdown``— a chip becomes a straggler (duration multiplier).
* ``exec_fault``   — the next stage submission fails transiently.

A :class:`FaultSchedule` is an ordered, validated list of
:class:`FaultEvent`; :class:`FaultInjector` replays one against a live
``DataPlane`` (planned events are delegated to a resize callback, usually
``Session.resize``) and answers transient-fault queries from its own seeded
RNG — so a run is bit-replayable from ``(schedule, seed)`` alone.

:class:`FailureInjector` is the training-loop step-fault injector that used
to live in ``repro.training.elastic``; it moved here so serving and training
share one deterministic-schedule core (elastic re-exports it).  This module
must stay import-light (no torch): it is imported by ``repro_torch.api.config``.
"""

from __future__ import annotations

import bisect
import random
from dataclasses import dataclass, fields
from typing import Any

FAULT_KINDS = ("node_join", "node_drain", "node_loss", "chip_slowdown",
               "exec_fault")
_HOST_KINDS = ("node_join", "node_drain", "node_loss")


@dataclass(frozen=True)
class FaultEvent:
    """One scheduled fault.  ``t_s`` is virtual serving time.

    ``accel_class``/``host_id`` locate host events (``host_id`` defaults to
    the highest live host of the class — tail-stable renumbering, see
    DESIGN.md §13).  ``chip_id`` locates a ``chip_slowdown`` (None = every
    chip of the class), ``factor`` is its duration multiplier, and ``count``
    is how many hosts join/drain or how many consecutive submissions an
    ``exec_fault`` poisons."""

    t_s: float
    kind: str
    accel_class: str | None = None
    host_id: int | None = None
    chip_id: int | None = None
    factor: float = 1.0
    count: int = 1

    def validate(self) -> "FaultEvent":
        if self.kind not in FAULT_KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; "
                             f"expected one of {FAULT_KINDS}")
        if self.t_s < 0.0:
            raise ValueError(f"fault t_s must be >= 0, got {self.t_s}")
        if self.kind in _HOST_KINDS and self.accel_class is None:
            raise ValueError(f"{self.kind} event needs accel_class")
        if self.kind == "chip_slowdown":
            if self.accel_class is None:
                raise ValueError("chip_slowdown event needs accel_class")
            if self.factor < 1.0:
                raise ValueError(f"chip_slowdown factor must be >= 1.0, "
                                 f"got {self.factor}")
        if self.count < 1:
            raise ValueError(f"fault count must be >= 1, got {self.count}")
        return self

    def as_dict(self) -> dict:
        out = {}
        for f in fields(self):
            v = getattr(self, f.name)
            if v is not None:
                out[f.name] = v
        return out

    @classmethod
    def from_dict(cls, data) -> "FaultEvent":
        return cls(**dict(data)).validate()


class FaultSchedule:
    """Time-ordered fault events with a consumption cursor.

    ``due(now)`` returns (and consumes) every not-yet-delivered event with
    ``t_s <= now`` — the injector polls it from the data-plane arrival hook,
    so delivery order is deterministic for a deterministic arrival stream."""

    __slots__ = ("events", "_next")

    def __init__(self, events=()):
        self.events: list[FaultEvent] = sorted(
            (e.validate() for e in events), key=lambda e: e.t_s)
        self._next = 0

    def add(self, event: FaultEvent) -> None:
        event.validate()
        keys = [e.t_s for e in self.events]
        i = bisect.bisect_right(keys, event.t_s)
        if i < self._next:
            raise ValueError(f"cannot add fault at t={event.t_s} before the "
                             f"consumed prefix")
        self.events.insert(i, event)

    def due(self, now: float) -> list[FaultEvent]:
        out = []
        while self._next < len(self.events) and \
                self.events[self._next].t_s <= now:
            out.append(self.events[self._next])
            self._next += 1
        return out

    @property
    def remaining(self) -> int:
        return len(self.events) - self._next

    def reset(self) -> None:
        self._next = 0

    def __len__(self) -> int:
        return len(self.events)

    @classmethod
    def from_seed(cls, seed: int, horizon_s: float, counts: dict[str, int],
                  *, chips_per_host: int = 4, n_events: int = 3,
                  kinds=("node_loss", "chip_slowdown", "exec_fault")
                  ) -> "FaultSchedule":
        """Random-but-replayable schedule for property tests and soaks.

        Host events target the tail host of a class that has more than one,
        so the surviving chip numbering is stable (DESIGN.md §13); classes
        with a single host only receive slowdowns/exec faults."""
        rng = random.Random(seed)
        multi = [c for c, n in counts.items() if n > chips_per_host]
        events = []
        for _ in range(n_events):
            t = round(rng.uniform(0.1, 0.9) * horizon_s, 3)
            kind = rng.choice([k for k in kinds
                               if k not in _HOST_KINDS or multi])
            if kind in _HOST_KINDS:
                cname = rng.choice(multi)
                host = counts[cname] // chips_per_host - 1
                events.append(FaultEvent(t, kind, accel_class=cname,
                                         host_id=host))
            elif kind == "chip_slowdown":
                cname = rng.choice(sorted(counts))
                events.append(FaultEvent(
                    t, kind, accel_class=cname,
                    chip_id=rng.randrange(counts[cname]),
                    factor=round(rng.uniform(1.5, 4.0), 3)))
            else:
                events.append(FaultEvent(t, "exec_fault",
                                         count=rng.randint(1, 3)))
        return cls(events)


@dataclass(frozen=True)
class FaultConfig:
    """Declarative fault-injection section of ``ServeConfig``.

    Dict-round-trips like ``SourceConfig``: ``FaultConfig.from_dict(
    cfg.to_dict()["faults"])`` rebuilds it exactly."""

    seed: int = 0
    exec_fault_rate: float = 0.0
    max_retries: int = 2
    schedule: tuple[FaultEvent, ...] = ()

    def validate(self) -> "FaultConfig":
        if not 0.0 <= self.exec_fault_rate <= 1.0:
            raise ValueError(f"exec_fault_rate must be in [0, 1], "
                             f"got {self.exec_fault_rate}")
        if self.max_retries < 0:
            raise ValueError(f"max_retries must be >= 0, "
                             f"got {self.max_retries}")
        for ev in self.schedule:
            ev.validate()
        return self

    def to_dict(self) -> dict:
        return {"seed": self.seed, "exec_fault_rate": self.exec_fault_rate,
                "max_retries": self.max_retries,
                "schedule": [ev.as_dict() for ev in self.schedule]}

    @classmethod
    def from_dict(cls, data) -> "FaultConfig":
        d = dict(data)
        sched = d.pop("schedule", ())
        return cls(schedule=tuple(FaultEvent.from_dict(ev) for ev in sched),
                   **d).validate()


class FaultInjector:
    """Replays a :class:`FaultSchedule` against a live ``DataPlane``.

    ``attach(plane)`` registers an arrival hook that polls the schedule at
    each virtual arrival; abrupt events (``node_loss``, ``chip_slowdown``,
    ``exec_fault``) are applied to the plane directly, planned membership
    events (``node_join``/``node_drain``) are delegated to ``on_resize``
    (wired to ``Session.resize`` by the facade).  Transient-fault queries
    (``exec_fault_due``) draw from a private seeded RNG so the whole run is
    replayable from the constructor arguments."""

    def __init__(self, schedule: FaultSchedule | None = None, *,
                 seed: int = 0, exec_fault_rate: float = 0.0,
                 max_retries: int = 2, on_resize=None):
        self.schedule = schedule if schedule is not None else FaultSchedule()
        self.seed = seed
        self.exec_fault_rate = exec_fault_rate
        self.max_retries = max_retries
        self.on_resize = on_resize
        self.injected: list[FaultEvent] = []
        self._rng = random.Random(seed)
        self._forced_exec_faults = 0
        self._plane: Any = None  # a live DataPlane after attach()

    @classmethod
    def from_config(cls, cfg: FaultConfig, *, on_resize=None
                    ) -> "FaultInjector":
        return cls(FaultSchedule(cfg.schedule), seed=cfg.seed,
                   exec_fault_rate=cfg.exec_fault_rate,
                   max_retries=cfg.max_retries, on_resize=on_resize)

    def attach(self, plane) -> "FaultInjector":
        self._plane = plane
        plane.faults = self
        plane.arrival_hooks.append(self._on_arrival)
        return self

    def _on_arrival(self, req, now: float) -> None:
        self.poll(now)

    def poll(self, now: float) -> list[FaultEvent]:
        """Deliver every due event; returns what was applied."""
        applied = self.schedule.due(now)
        for ev in applied:
            self.apply(ev, now)
        return applied

    def apply(self, ev: FaultEvent, now: float) -> None:
        plane = self._plane
        if plane is None:
            raise RuntimeError("FaultInjector.apply before attach()")
        self.injected.append(ev)
        if plane.obs is not None:
            plane.obs.on_fault(now, ev.kind, ev.as_dict())
        plane.tel.faults_injected += 1
        if ev.kind == "node_loss":
            plane.fail_host(ev.accel_class, ev.host_id, now)
        elif ev.kind == "chip_slowdown":
            plane.set_chip_slowdown(ev.accel_class, ev.chip_id, ev.factor)
        elif ev.kind == "exec_fault":
            self._forced_exec_faults += ev.count
        else:  # node_join / node_drain — planned membership change
            if self.on_resize is not None:
                self.on_resize(ev, now)

    def exec_fault_due(self) -> bool:
        """Consulted once per dispatch: should this submission fail?"""
        if self._forced_exec_faults > 0:
            self._forced_exec_faults -= 1
            return True
        return (self.exec_fault_rate > 0.0
                and self._rng.random() < self.exec_fault_rate)


class FailureInjector:
    """Deterministic failure schedule for tests: fail at given steps."""

    def __init__(self, fail_at: set[int] | None = None):
        self.fail_at = fail_at or set()
        self.failures: list[int] = []

    def check(self, step: int) -> None:
        if step in self.fail_at:
            self.fail_at.discard(step)
            self.failures.append(step)
            raise RuntimeError(f"injected node failure at step {step}")


__all__ = ["FAULT_KINDS", "FaultEvent", "FaultSchedule", "FaultConfig",
           "FaultInjector", "FailureInjector"]
