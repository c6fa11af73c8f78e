"""Per-model request queues with SLO-aware admission control.

The queue is the data plane's front door (DESIGN.md section 3).  Four drop
mechanisms exist, each counted separately so telemetry can attribute loss:

* **admission reject** — a request whose deadline cannot be met even by an
  unloaded pipeline (arrival + best-case batch-1 latency > deadline) is
  refused at arrival; queueing it would only waste probe calls.
* **overflow shed** — when a depth bound is set (`max_depth`, or the
  `high_watermark` under streaming backpressure), arrivals beyond it shed
  queued work whose *position-aware* feasibility bound already dooms it
  (see `completion_lb_s`); `max_depth` overflow with no doomed candidate
  falls back to head-shedding in deadline order — under backlog the
  earliest deadlines are the ones that will be missed (classic EDF
  overload behaviour).
* **backpressure reject** — when the high watermark is hit and *no* queued
  request is provably doomed, the incoming request itself is refused at the
  door.  This caps depth at the watermark without ever shedding a request
  the feasibility probe says could still make its SLO (the invariant the
  streaming tests pin).
* **expiry prune** — before each scheduling round, queued requests whose
  deadline has become unreachable are dropped without paying for a probe.

Watermarks carry hysteresis: once depth exceeds `high_watermark` the queue
is in backpressure (`bp_active`) until depth drains to `low_watermark`
(default high//2) — the `admit.shed`/`admit.resume` edge the data plane
journals (through `repro.obs` in the reference package).

Queues are kept ordered by deadline (EDF) and expose the deque interface
(`append` / `popleft` / `[0]` / `len`) that Algorithm 1
(`core.scheduler.ReservationScheduler`) manipulates, so the simulator's
scheduler runs unmodified on top of them.
"""

from __future__ import annotations

import bisect
from dataclasses import dataclass

from repro_torch.core.types import Request


@dataclass(frozen=True)
class AdmissionPolicy:
    """Knobs for ModelQueue admission/drop behaviour."""

    max_depth: int | None = None  # per-model queue bound; None = unbounded
    feasibility_check: bool = True  # reject hopeless requests at arrival
    prune_expired: bool = True  # drop unreachable deadlines pre-scheduling
    edf_order: bool = True  # False = plain FIFO (the simulator's order)
    slack_eps_s: float = 1e-9
    # streaming backpressure watermarks (None = no watermark behaviour).
    # Depth above `high_watermark` sheds provably-doomed queued work or,
    # failing that, rejects the incoming request at the door; backpressure
    # stays active (bp_active, for journaling) until depth drains to
    # `low_watermark` (default: high_watermark // 2).
    high_watermark: int | None = None
    low_watermark: int | None = None

    def __post_init__(self) -> None:
        if self.high_watermark is not None and self.high_watermark < 1:
            raise ValueError(
                f"high_watermark must be >= 1, got {self.high_watermark}")
        if self.low_watermark is not None:
            if self.high_watermark is None:
                raise ValueError("low_watermark requires high_watermark")
            if not 0 <= self.low_watermark <= self.high_watermark:
                raise ValueError(
                    f"low_watermark must be in [0, high_watermark], got "
                    f"{self.low_watermark} > {self.high_watermark}")

    @property
    def resume_depth(self) -> int | None:
        """The depth at which backpressure releases (hysteresis floor)."""
        if self.high_watermark is None:
            return None
        if self.low_watermark is not None:
            return self.low_watermark
        return self.high_watermark // 2

    @classmethod
    def permissive(cls) -> "AdmissionPolicy":
        """Pass-through policy: no admission, no drops, FIFO order — the
        queue behaves exactly like the simulator's deque, making data-plane
        outcomes bit-identical to the simulator's (the parity test).  EDF
        order is a data-plane improvement over the simulator and only
        coincides with FIFO when every request of a model shares one SLO.
        One exception survives even here: requests for a model no pipeline
        serves are rejected (with an outcome) rather than swallowed."""
        return cls(max_depth=None, feasibility_check=False,
                   prune_expired=False, edf_order=False)


class ModelQueue:
    """Deadline-ordered (EDF; FIFO if `policy.edf_order` is off) request
    queue for one model."""

    __slots__ = ("model_name", "policy", "min_service_s", "capacity_hint",
                 "_deadlines", "_reqs", "admitted", "rejected", "shed",
                 "expired", "backpressure_rejected", "bp_active",
                 "last_shed_audit")

    def __init__(self, model_name: str, policy: AdmissionPolicy,
                 min_service_s: float = 0.0, capacity_hint: int = 1) -> None:
        self.model_name = model_name
        self.policy = policy
        # unloaded best-case latency of the fastest pipeline at batch 1:
        # the feasibility bound used for admission and expiry.
        self.min_service_s = min_service_s
        # optimistic requests cleared per min_service quantum (pool batch
        # capacity of the model's pipelines) — the position-aware feasibility
        # bound's denominator; >= 1
        self.capacity_hint = max(1, capacity_hint)
        self._deadlines: list[float] = []
        self._reqs: list[Request] = []
        self.admitted = 0
        self.rejected = 0
        self.shed = 0
        self.expired = 0
        self.backpressure_rejected = 0
        # True from the moment depth first exceeds the high watermark until
        # it drains to the resume depth (hysteresis) — the journaled edge
        self.bp_active = False
        # audit trail of the most recent doomed-shed sweep:
        # (req_id, survivor_position, completion_lb_s, deadline_s) per shed
        # request — overwritten each sweep so memory stays bounded; the
        # never-shed-a-feasible-request invariant test replays these bounds
        self.last_shed_audit: list[tuple[int, int, float, float]] = []

    # ---------------------------------------------------- deque interface
    # (what Algorithm 1 in core.scheduler uses — keep in sync with deque)
    def append(self, req: Request) -> None:
        if self.policy.edf_order:
            i = bisect.bisect_right(self._deadlines, req.deadline_s)
        else:
            i = len(self._deadlines)
        self._deadlines.insert(i, req.deadline_s)
        self._reqs.insert(i, req)

    def popleft(self) -> Request:
        self._deadlines.pop(0)
        return self._reqs.pop(0)

    def __len__(self) -> int:
        return len(self._reqs)

    def __getitem__(self, i: int) -> Request:
        return self._reqs[i]

    # ------------------------------------------------- feasibility bounds
    def completion_lb_s(self, pos: int, now: float) -> float:
        """Optimistic completion lower bound for the request at queue
        position `pos` (0-based): every earlier request clears in waves of
        `capacity_hint` at the fastest pipeline's unloaded batch-1 latency.
        Deliberately loose (real service is slower), so `bound > deadline`
        proves a request is doomed — the only license to shed it."""
        waves = pos // self.capacity_hint
        return now + self.min_service_s * (1 + waves)

    def _shed_doomed(self, now: float) -> list[Request]:
        """Shed every queued request whose position-aware bound already
        misses its deadline.  Positions count *survivors* only — each shed
        promotes everything behind it, which can only lower later bounds,
        so the sweep never sheds a request a feasible schedule could save."""
        eps = self.policy.slack_eps_s
        audit: list[tuple[int, int, float, float]] = []
        keep_d: list[float] = []
        keep_r: list[Request] = []
        dropped: list[Request] = []
        pos = 0
        for d, r in zip(self._deadlines, self._reqs):
            bound = self.completion_lb_s(pos, now)
            if bound > d + eps:
                dropped.append(r)
                audit.append((r.req_id, pos, bound, d))
                self.shed += 1
            else:
                keep_d.append(d)
                keep_r.append(r)
                pos += 1
        self._deadlines = keep_d
        self._reqs = keep_r
        self.last_shed_audit = audit
        return dropped

    def maybe_resume(self) -> bool:
        """Release backpressure once depth drains to the resume depth.
        Returns True exactly on the releasing transition."""
        rd = self.policy.resume_depth
        if self.bp_active and rd is not None and len(self._reqs) <= rd:
            self.bp_active = False
            return True
        return False

    # ------------------------------------------------------ admission path
    def offer(self, req: Request, now: float) -> tuple[str | None, list[Request]]:
        """Admission-controlled enqueue.

        Returns (cause, shed): `cause` is None when `req` entered the queue,
        else the drop cause ("admission_reject" for an infeasible deadline,
        "backpressure_reject" for a watermark door-reject); `shed` lists any
        queued requests shed to respect depth bounds.
        """
        p = self.policy
        if p.feasibility_check and now + self.min_service_s > req.deadline_s + p.slack_eps_s:
            self.rejected += 1
            return "admission_reject", []
        self.append(req)
        self.admitted += 1
        dropped: list[Request] = []
        if p.max_depth is not None:
            while len(self._reqs) > p.max_depth:
                dropped.append(self.popleft())  # earliest deadline goes first
                self.shed += 1
        if p.high_watermark is not None and len(self._reqs) > p.high_watermark:
            self.bp_active = True
            dropped.extend(self._shed_doomed(now))
            if len(self._reqs) > p.high_watermark:
                # nothing queued is provably doomed: refuse the arrival at
                # the door instead of shedding feasible work.  Depth exceeds
                # the watermark by at most 1 (one offer at a time), so the
                # removal always restores depth <= high_watermark.
                self._remove(req)
                self.admitted -= 1
                self.backpressure_rejected += 1
                return "backpressure_reject", dropped
        return None, dropped

    def _remove(self, req: Request) -> None:
        """Remove `req` (by identity) — the watermark door-reject path."""
        for i in range(len(self._reqs) - 1, -1, -1):
            if self._reqs[i] is req:
                del self._reqs[i]
                del self._deadlines[i]
                return

    def take_all(self) -> list[Request]:
        """Drain the queue (in queue order) without touching drop counters.
        Used by plan hot-swap to carry pending requests to the new plan's
        queues — these requests are neither dropped nor re-admitted."""
        out, self._reqs, self._deadlines = self._reqs, [], []
        return out

    def prune(self, now: float) -> list[Request]:
        """Drop, in deadline order, every head whose deadline is unreachable."""
        if not self.policy.prune_expired:
            return []
        out: list[Request] = []
        eps = self.policy.slack_eps_s
        while self._reqs and now + self.min_service_s > self._deadlines[0] + eps:
            out.append(self.popleft())
            self.expired += 1
        return out


class QueueSet:
    """All per-model queues of one data plane + aggregate counters."""

    def __init__(self, min_service_s: dict[str, float],
                 policy: AdmissionPolicy | None = None,
                 capacity_hint: dict[str, int] | None = None) -> None:
        self.policy = policy or AdmissionPolicy()
        # the models some pipeline actually serves; anything else is
        # unconditionally rejected at offer() time
        self.served = frozenset(min_service_s)
        caps = capacity_hint or {}
        self.by_model: dict[str, ModelQueue] = {
            m: ModelQueue(m, self.policy, s, caps.get(m, 1))
            for m, s in min_service_s.items()
        }

    def queue(self, model: str) -> ModelQueue:
        q = self.by_model.get(model)
        if q is None:
            q = self.by_model[model] = ModelQueue(model, self.policy)
        return q

    def offer(self, req: Request, now: float) -> tuple[str | None, list[Request]]:
        if req.model_name not in self.served:
            # No pipeline serves this model (unknown model, or one dropped by
            # a plan hot-swap): rejected unconditionally — even under the
            # permissive policy — because it would otherwise sit in a queue
            # no scheduler ever services and silently lose its outcome.
            self.queue(req.model_name).rejected += 1
            return "admission_reject", []
        return self.by_model[req.model_name].offer(req, now)

    def prune(self, model: str, now: float) -> list[Request]:
        return self.queue(model).prune(now)

    def take_all(self) -> list[Request]:
        """Drain every queue (plan hot-swap hand-off); counters untouched."""
        out: list[Request] = []
        for q in self.by_model.values():
            out.extend(q.take_all())
        return out

    def pending(self, model: str) -> int:
        return len(self.by_model.get(model, ()))

    def total_pending(self) -> int:
        """Queued requests across every model — the queue-depth gauge the
        observability layer samples."""
        return sum(len(q) for q in self.by_model.values())

    def _total(self, attr: str) -> int:
        return sum(getattr(q, attr) for q in self.by_model.values())

    @property
    def admitted(self) -> int:
        return self._total("admitted")

    @property
    def rejected(self) -> int:
        return self._total("rejected")

    @property
    def shed(self) -> int:
        return self._total("shed")

    @property
    def expired(self) -> int:
        return self._total("expired")

    @property
    def backpressure_rejected(self) -> int:
        return self._total("backpressure_rejected")
