"""The decision journal: one strict-JSON event stream for the whole plane.

Everything that used to be scattered — `Telemetry.replan_decisions`,
`swap_log`, the ad-hoc `DataPlane.exec_log` tuples, `DispatchRecord`s — lands
here as flat dicts with a shared envelope: ``{"t_s": <virtual seconds>,
"kind": <dotted event name>, ...payload}``.

The event kinds and their required payload fields are declared once, in
`repro_torch.obs.schema` (`SCHEMA`: kind → :class:`~repro_torch.obs.schema.EventSchema`).
Emitters reference the schema's kind constants and consumers are
cross-checked against the same table by the static invariant linter
(`repro.analysis`, JRN rules) — see that module's docstring for the full
contract.

Values are strict-JSON by construction: tuples become lists at record time
and `to_json()` runs with ``allow_nan=False``, so a NaN/inf sneaking into an
event fails loudly here rather than in a downstream consumer.
"""

from __future__ import annotations

import json
from typing import Callable

SCHEMA_VERSION = 1


def _jsonable(v):
    if isinstance(v, tuple):
        return [_jsonable(x) for x in v]
    if isinstance(v, list):
        return [_jsonable(x) for x in v]
    if isinstance(v, dict):
        return {k: _jsonable(x) for k, x in v.items()}
    return v


class DecisionJournal:
    """Append-only, time-ordered (by recording order) event list.

    An owner that buffers events off the hot path (the `Observer`) installs
    a `_flusher` callback; every read of `events` drains that buffer first,
    so consumers always see the materialized stream without the serving
    path ever paying for dict construction.
    """

    __slots__ = ("_events", "_flusher")

    def __init__(self) -> None:
        self._events: list[dict] = []
        # set by Observer; must append to _events
        self._flusher: Callable[[], None] | None = None

    @property
    def events(self) -> list[dict]:
        if self._flusher is not None:
            self._flusher()
        return self._events

    def record(self, t_s: float, kind: str, **payload) -> None:
        ev = {"t_s": t_s, "kind": kind}
        for k, v in payload.items():
            ev[k] = _jsonable(v)
        self.events.append(ev)

    def select(self, kind: str | None = None, prefix: str | None = None
               ) -> list[dict]:
        """Events of one `kind`, or every kind under a dotted `prefix`
        (e.g. ``prefix="replan"`` matches replan.decision/failure/success)."""
        if kind is not None:
            return [e for e in self.events if e["kind"] == kind]
        if prefix is not None:
            dot = prefix + "."
            return [e for e in self.events if e["kind"].startswith(dot)]
        return list(self.events)

    def __len__(self) -> int:
        return len(self.events)

    def to_json(self) -> str:
        """Strict JSON (rejects NaN/inf) of the full stream + schema tag."""
        return json.dumps(
            {"schema_version": SCHEMA_VERSION, "events": self.events},
            allow_nan=False)
