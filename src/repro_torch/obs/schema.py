"""The journal event-kind registry: the single source of truth for every
decision-journal event the system emits.

One :class:`EventSchema` per kind: the dotted kind string plus the payload
fields every event of that kind must carry (beyond the shared
``{"t_s": <virtual seconds>, "kind": <dotted name>}`` envelope).  ``open``
kinds may attach extra, dynamically-keyed payload (the replan decision dict,
the FaultEvent payload); closed kinds must carry *exactly* the declared set.

Emitters (`observer.py`) reference the module-level kind constants — never a
free string literal — and consumers (`spans.py`, `bench_e2e_load.py`'s
`_journal_integrity`, tests) compare against the same dotted names.  The
static invariant linter (`repro.analysis`, rule family JRN) cross-checks
both sides against this table at lint time, so an emitter/auditor drift
fails the CI gate instead of silently passing:

* every emit site (a dict literal with a ``"kind"`` key) must name its kind
  via one of these constants, and its literal payload keys must match the
  declared field set;
* every consumer comparison (``ev["kind"] == ...``, ``journal.select(...)``,
  ``.startswith(...)`` prefixes) must reference a declared kind;
* field accesses under a kind guard must be declared for that kind.

This module is deliberately import-light (dataclasses only): it is imported
by `observer.py` on the serving path and parsed as *data* (via `ast`) by the
linter, which never imports target code.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class EventSchema:
    """Declared shape of one journal event kind."""

    kind: str
    required: tuple[str, ...]  # payload fields beyond the t_s/kind envelope
    open: bool = False  # True: extra dynamically-keyed payload is allowed


# --------------------------------------------------------------------------
# Kind constants — the one spelling of each dotted event name.
# --------------------------------------------------------------------------

# data plane: request lifecycle
REQ_ARRIVE = "req.arrive"
REQ_DROP = "req.drop"
REQ_COMPLETE = "req.complete"

# data plane: batch execution
BATCH_DISPATCH = "batch.dispatch"
EXEC_STAGE = "exec.stage"
EXEC_XFER = "exec.xfer"
BATCH_WALL = "batch.wall"

# control plane: swaps / drift / re-planning
PLAN_SWAP = "plan.swap"
DRIFT_ESTIMATE = "drift.estimate"
REPLAN_DECISION = "replan.decision"
REPLAN_FAILURE = "replan.failure"
REPLAN_SUCCESS = "replan.success"

# admission backpressure edges
ADMIT_SHED = "admit.shed"
ADMIT_RESUME = "admit.resume"

# elastic clusters / fault injection
FAULT_INJECT = "fault.inject"
POOL_DRAIN = "pool.drain"
RESIZE_START = "resize.start"
RESIZE_COMPLETE = "resize.complete"
RETRY_ATTEMPT = "retry.attempt"
RETRY_EXHAUSTED = "retry.exhausted"


SCHEMA: dict[str, EventSchema] = {
    # req.drop cause: admission_reject | backpressure_reject | overflow_shed
    # | expired | scheduler | exec_failure | node_loss
    REQ_ARRIVE: EventSchema(REQ_ARRIVE, ("req_id", "model", "deadline_s")),
    REQ_DROP: EventSchema(REQ_DROP, ("req_id", "cause")),
    REQ_COMPLETE: EventSchema(REQ_COMPLETE, ("req_id", "batch_id", "ok")),
    BATCH_DISPATCH: EventSchema(
        BATCH_DISPATCH,
        ("batch_id", "epoch", "pipeline_id", "batch_size", "req_ids",
         "queue_depth", "planned_finish_s")),
    EXEC_STAGE: EventSchema(
        EXEC_STAGE,
        ("batch_id", "epoch", "pipeline_id", "stage_idx", "accel_class",
         "chip_id", "vdev_id", "start_s", "dur_s", "batch_size")),
    # ul/dl are [accel_class, host_id] NIC endpoints
    EXEC_XFER: EventSchema(
        EXEC_XFER, ("batch_id", "epoch", "ul", "dl", "start_s", "dur_s")),
    # real execution only; t_s is the *wall* submit time
    BATCH_WALL: EventSchema(
        BATCH_WALL,
        ("batch_id", "epoch", "pipeline_id", "wall_s", "stage_wall_s")),
    PLAN_SWAP: EventSchema(
        PLAN_SWAP,
        ("epoch_from", "epoch_to", "reason", "transient_s", "carried")),
    DRIFT_ESTIMATE: EventSchema(
        DRIFT_ESTIMATE, ("rate_rel", "mix_tv", "tripped")),
    # payload is the whole ReplanPolicy decision dict (accepted, reason,
    # benefit/cost inputs) — dynamically keyed by construction
    REPLAN_DECISION: EventSchema(REPLAN_DECISION, (), open=True),
    REPLAN_FAILURE: EventSchema(REPLAN_FAILURE, ("error",)),
    REPLAN_SUCCESS: EventSchema(
        REPLAN_SUCCESS, ("solver_wall_s", "throughput_rps")),
    ADMIT_SHED: EventSchema(
        ADMIT_SHED,
        ("model", "queue_depth", "shed_total",
         "backpressure_rejected_total")),
    ADMIT_RESUME: EventSchema(ADMIT_RESUME, ("model", "queue_depth")),
    # fault_kind: node_join | node_drain | node_loss | chip_slowdown |
    # exec_fault; the rest of the payload is the FaultEvent's field dict
    FAULT_INJECT: EventSchema(FAULT_INJECT, ("fault_kind",), open=True),
    POOL_DRAIN: EventSchema(
        POOL_DRAIN,
        ("accel_class", "host_id", "inflight_failed", "readmitted",
         "dropped")),
    RESIZE_START: EventSchema(
        RESIZE_START, ("old_counts", "new_counts", "reason")),
    RESIZE_COMPLETE: EventSchema(
        RESIZE_COMPLETE, ("new_counts", "carried", "solver_wall_s")),
    RETRY_ATTEMPT: EventSchema(
        RETRY_ATTEMPT,
        ("batch_id", "pipeline_id", "n_requests", "readmitted")),
    RETRY_EXHAUSTED: EventSchema(RETRY_EXHAUSTED, ("req_id", "attempts")),
}

# Dotted prefixes consumers may select on (journal.select(prefix=...),
# ev["kind"].startswith("req.")): the first components of declared kinds.
KIND_PREFIXES: frozenset[str] = frozenset(
    k.split(".", 1)[0] for k in SCHEMA)

__all__ = ["EventSchema", "SCHEMA", "KIND_PREFIXES"] + [
    n for n in dir() if n.isupper() and isinstance(globals().get(n), str)
    and not n.startswith("_") and n not in ("SCHEMA",)
]
