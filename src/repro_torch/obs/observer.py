"""The `Observer` facade the data/control planes call into.

One Observer per DataPlane (created by `Session.deploy` when
``ServeConfig.obs.level != "off"``; when off, ``DataPlane.obs`` stays None
and every hook site is a single ``is not None`` check — the same structural
gating the old `exec_log` used, so the off path is decision-identical and
near-zero cost).

The Observer owns the two live collectors:

* `journal` — the strict-JSON `DecisionJournal` (control-plane events at
  "aggregate" level and up; per-request/batch/stage events at "trace");
* `windows` — `WindowedMetrics` on the virtual clock ("aggregate" and up).

Hot-path hooks (arrival/drop/dispatch/stage/xfer/complete) only append one
compact tuple to an internal buffer — no dict building, no window bucketing
on the scheduling path.  `_flush()` (run by `finalize`, i.e. once per serve
round, and before any export) replays the buffer in order into the windows
and the journal's event dicts; control-plane events enter the same buffer
as pre-built dicts so the journal stays globally ordered.  This batched
deferral is what keeps traced-mode overhead inside the e2e bench's budget.

Span trees and the Perfetto export are *derived* from the journal at export
time (spans.py) — no duplicate live bookkeeping.  Per-request events honour
``span_sampling`` deterministically in ``req_id`` (Knuth multiplicative
hash, no RNG), so twin runs trace identical request sets; per-batch events
(dispatch/stage/xfer) are bounded by dispatch count and are always recorded
at "trace" level.
"""

from __future__ import annotations

from .config import ObsConfig
from .journal import DecisionJournal, _jsonable
from .schema import (ADMIT_RESUME, ADMIT_SHED, BATCH_DISPATCH, BATCH_WALL,
                     DRIFT_ESTIMATE, EXEC_STAGE, EXEC_XFER, FAULT_INJECT,
                     PLAN_SWAP, POOL_DRAIN, REPLAN_DECISION, REPLAN_FAILURE,
                     REPLAN_SUCCESS, REQ_ARRIVE, REQ_COMPLETE, REQ_DROP,
                     RESIZE_COMPLETE, RESIZE_START, RETRY_ATTEMPT,
                     RETRY_EXHAUSTED)
from .windows import WindowedMetrics

_HASH = 2654435761  # Knuth multiplicative hash (2^32 / phi)

# Buffer opcodes (first tuple element) for the deferred hot-path records.
# Public: the data plane's hot sites push pre-encoded tuples straight into
# `Observer.push` with these tags, skipping a Python method call per event.
(OP_ARRIVE, OP_DROP, OP_DISPATCH, OP_STAGE, OP_XFER, OP_COMPLETE,
 OP_BATCH_WALL) = range(7)


class Observer:
    """Collects windowed metrics + the decision journal for one plane."""

    def __init__(self, config: ObsConfig | None = None) -> None:
        self.config = (config or ObsConfig(level="aggregate")).validate()
        self.journal = DecisionJournal()
        self.windows = WindowedMetrics(self.config.window_s)
        self._trace = self.config.level == "trace"
        rate = self.config.span_sampling
        self._sample_all = rate >= 1.0
        self._sample_none = rate <= 0.0
        self._threshold = int(rate * 2**32)
        self.horizon_s = 0.0
        self.cluster_counts: dict[str, int] | None = None
        # deferred records: opcode tuples from the hot hooks, dicts from the
        # control-plane hooks (same buffer, so journal order is preserved);
        # any read of journal.events drains the buffer first
        self._buf: list = []
        self.push = self._buf.append
        self.journal._flusher = self._flush

    def _sampled(self, req_id: int) -> bool:
        if self._sample_all:
            return True
        if self._sample_none:
            return False
        return (req_id * _HASH) & 0xFFFFFFFF < self._threshold

    # --------------------------------------------------- data-plane hooks
    # (hot path: one tuple append each; materialized by _flush)
    def on_arrival(self, req, t: float) -> None:
        self.push((OP_ARRIVE, t, req))

    def on_drop(self, req, t: float, cause: str) -> None:
        self.push((OP_DROP, t, req, cause))

    def on_dispatch(self, t: float, batch_id: int, epoch: int,
                    pipeline_id: int, requests, queue_depth: int,
                    inflight: int, planned_finish_s: float,
                    total_depth: int | None = None) -> None:
        self.push((OP_DISPATCH, t, batch_id, epoch, pipeline_id, requests,
                   queue_depth, inflight, planned_finish_s, total_depth))

    def on_stage(self, batch_id: int, epoch: int, pipeline_id: int,
                 stage_idx: int, accel_class: str, chip_id: int,
                 vdev_id: int, start: float, dur: float,
                 batch_size: int) -> None:
        self.push((OP_STAGE, batch_id, epoch, pipeline_id, stage_idx,
                   accel_class, chip_id, vdev_id, start, dur, batch_size))

    def on_xfer(self, batch_id: int, epoch: int, ul_key, dl_key,
                start: float, dur: float) -> None:
        self.push((OP_XFER, batch_id, epoch, ul_key, dl_key, start, dur))

    def on_complete(self, req, t: float, batch_id: int) -> None:
        self.push((OP_COMPLETE, t, req, batch_id))

    def on_batch_wall(self, done) -> None:
        """Wall-clock side of a real-execution batch (`CompletedBatch`) —
        recorded on the *wall* axis, complementing the virtual-clock spans."""
        self.push((OP_BATCH_WALL, done))

    # ------------------------------------------------- control-plane hooks
    # (infrequent: build the journal dict now, buffer it for ordering)
    def on_swap(self, t: float, epoch_from: int, epoch_to: int, reason: str,
                transient_s: float, carried: int) -> None:
        self.push({"t_s": t, "kind": PLAN_SWAP, "epoch_from": epoch_from,
                   "epoch_to": epoch_to, "reason": reason,
                   "transient_s": transient_s, "carried": carried})

    def on_drift(self, t: float, rate_rel: float, mix_tv: float,
                 tripped: bool) -> None:
        self.push({"t_s": t, "kind": DRIFT_ESTIMATE, "rate_rel": rate_rel,
                   "mix_tv": mix_tv, "tripped": bool(tripped)})

    def on_replan_decision(self, t: float, decision: dict) -> None:
        ev = {"t_s": t, "kind": REPLAN_DECISION}
        for k, v in decision.items():
            ev[k] = _jsonable(v)
        self.push(ev)

    def on_replan_failure(self, t: float, error: str) -> None:
        self.push({"t_s": t, "kind": REPLAN_FAILURE, "error": error})

    def on_replan_success(self, t: float, solver_wall_s: float,
                          throughput_rps: float) -> None:
        self.push({"t_s": t, "kind": REPLAN_SUCCESS,
                   "solver_wall_s": solver_wall_s,
                   "throughput_rps": throughput_rps})

    def on_admit_shed(self, t: float, model: str, depth: int,
                      shed_total: int, rejected_total: int) -> None:
        """A model's queue entered backpressure (depth crossed the high
        watermark): doomed queued work is being shed / arrivals door-rejected
        until depth drains to the resume watermark."""
        self.push({"t_s": t, "kind": ADMIT_SHED, "model": model,
                   "queue_depth": depth, "shed_total": shed_total,
                   "backpressure_rejected_total": rejected_total})

    def on_admit_resume(self, t: float, model: str, depth: int) -> None:
        """The model's queue drained to the resume watermark: backpressure
        released, admission back to normal."""
        self.push({"t_s": t, "kind": ADMIT_RESUME, "model": model,
                   "queue_depth": depth})

    # ------------------------------------------- elastic / fault-path hooks
    def on_fault(self, t: float, fault_kind: str, event: dict) -> None:
        """A scheduled fault event was delivered (repro_torch.faults)."""
        ev = {"t_s": t, "kind": FAULT_INJECT, "fault_kind": fault_kind}
        for k, v in event.items():
            if k not in ("t_s", "kind"):
                ev[k] = _jsonable(v)
        self.push(ev)

    def on_pool_drain(self, t: float, accel_class: str, host_id: int,
                      inflight_failed: int, readmitted: int,
                      dropped: int) -> None:
        """A host's pools were retired abruptly (node loss): how many
        in-flight batches were failed, and how their requests resolved."""
        self.push({"t_s": t, "kind": POOL_DRAIN,
                   "accel_class": accel_class, "host_id": host_id,
                   "inflight_failed": inflight_failed,
                   "readmitted": readmitted, "dropped": dropped})

    def on_resize_start(self, t: float, old_counts: dict, new_counts: dict,
                        reason: str) -> None:
        self.push({"t_s": t, "kind": RESIZE_START,
                   "old_counts": dict(old_counts),
                   "new_counts": dict(new_counts), "reason": reason})

    def on_resize_complete(self, t: float, new_counts: dict,
                           carried: int, solver_wall_s: float) -> None:
        self.push({"t_s": t, "kind": RESIZE_COMPLETE,
                   "new_counts": dict(new_counts), "carried": carried,
                   "solver_wall_s": solver_wall_s})

    def on_retry_attempt(self, t: float, batch_id: int, pipeline_id: int,
                         n_requests: int, readmitted: int) -> None:
        """A transient stage-exec failure: the batch's reservation was
        cancelled and `readmitted` of its requests re-entered the EDF queue
        (hedged — the scheduler re-probes every pool, not just the failed
        one)."""
        self.push({"t_s": t, "kind": RETRY_ATTEMPT, "batch_id": batch_id,
                   "pipeline_id": pipeline_id, "n_requests": n_requests,
                   "readmitted": readmitted})

    def on_retry_exhausted(self, t: float, req_id: int,
                           attempts: int) -> None:
        """A request used up its retry budget; it drops as exec_failure."""
        self.push({"t_s": t, "kind": RETRY_EXHAUSTED, "req_id": req_id,
                   "attempts": attempts})

    # ------------------------------------------------------ materialization
    def _flush(self) -> None:
        """Replay the deferred buffer into windows + journal (in order)."""
        buf = self._buf
        if not buf:
            return
        self._buf = []
        self.push = self._buf.append
        trace = self._trace
        sample_all = self._sample_all
        sample_none = self._sample_none
        thr = self._threshold
        w = self.windows
        append = self.journal._events.append  # not .events: would re-flush
        for rec in buf:
            if rec.__class__ is dict:  # control-plane event, pre-built
                append(rec)
                continue
            op = rec[0]
            if op == OP_STAGE:
                (_, batch_id, epoch, pipeline_id, stage_idx, accel_class,
                 chip_id, vdev_id, start, dur, batch_size) = rec
                w.observe_busy(accel_class, start, dur)
                if trace:
                    append({"t_s": start, "kind": EXEC_STAGE,
                            "batch_id": batch_id, "epoch": epoch,
                            "pipeline_id": pipeline_id,
                            "stage_idx": stage_idx,
                            "accel_class": accel_class, "chip_id": chip_id,
                            "vdev_id": vdev_id, "start_s": start,
                            "dur_s": dur, "batch_size": batch_size})
            elif op == OP_ARRIVE:
                _, t, req = rec
                w.observe_arrival(t)
                if trace and (sample_all or (not sample_none and (
                        req.req_id * _HASH) & 0xFFFFFFFF < thr)):
                    append({"t_s": t, "kind": REQ_ARRIVE,
                            "req_id": req.req_id, "model": req.model_name,
                            "deadline_s": req.deadline_s})
            elif op == OP_COMPLETE:
                _, t, req, batch_id = rec
                # same epsilon as RequestOutcome.ok (core/types.py), so
                # windowed ok-sums match Telemetry attainment exactly
                ok = t <= req.deadline_s + 1e-9
                w.observe_complete(t, ok)
                if trace and (sample_all or (not sample_none and (
                        req.req_id * _HASH) & 0xFFFFFFFF < thr)):
                    append({"t_s": t, "kind": REQ_COMPLETE,
                            "req_id": req.req_id, "batch_id": batch_id,
                            "ok": bool(ok)})
            elif op == OP_DISPATCH:
                (_, t, batch_id, epoch, pipeline_id, requests, queue_depth,
                 inflight, planned_finish_s, total_depth) = rec
                depth = queue_depth if total_depth is None else total_depth
                w.observe_dispatch(t, len(requests), depth, inflight,
                                   [t - r.arrival_s for r in requests])
                if trace:
                    append({"t_s": t, "kind": BATCH_DISPATCH,
                            "batch_id": batch_id, "epoch": epoch,
                            "pipeline_id": pipeline_id,
                            "batch_size": len(requests),
                            "req_ids": [r.req_id for r in requests],
                            "queue_depth": queue_depth,
                            "planned_finish_s": planned_finish_s})
            elif op == OP_XFER:
                if trace:
                    _, batch_id, epoch, ul_key, dl_key, start, dur = rec
                    append({"t_s": start, "kind": EXEC_XFER,
                            "batch_id": batch_id, "epoch": epoch,
                            "ul": list(ul_key), "dl": list(dl_key),
                            "start_s": start, "dur_s": dur})
            elif op == OP_DROP:
                _, t, req, cause = rec
                w.observe_drop(t, cause)
                if trace and (sample_all or (not sample_none and (
                        req.req_id * _HASH) & 0xFFFFFFFF < thr)):
                    append({"t_s": t, "kind": REQ_DROP,
                            "req_id": req.req_id, "cause": cause})
            else:  # OP_BATCH_WALL
                done = rec[1]
                append({"t_s": done.submit_wall, "kind": BATCH_WALL,
                        "batch_id": done.job_id, "epoch": done.epoch,
                        "pipeline_id": done.pipeline_id,
                        "wall_s": done.total_wall_s,
                        "stage_wall_s": [float(x)
                                         for x in done.stage_wall_s]})

    # --------------------------------------------------------------- export
    def finalize(self, horizon_s: float,
                 cluster_counts: dict[str, int] | None = None) -> None:
        """Pin the run horizon (+ chip counts for utilization series);
        called by `DataPlane.serve` at the end of each serve round.  Cheap
        by design — buffered events materialize lazily at first read, so
        the serve wall never pays for journal/window construction."""
        self.horizon_s = max(self.horizon_s, horizon_s)
        if cluster_counts:
            self.cluster_counts = dict(cluster_counts)

    def timeseries(self) -> dict:
        """Per-window time series over the served horizon (strict-JSON)."""
        self._flush()
        return self.windows.series(self.horizon_s, self.cluster_counts)

    def perfetto(self) -> dict:
        """Chrome/Perfetto ``trace_event`` JSON of the journal."""
        from .spans import perfetto_trace

        self._flush()
        return perfetto_trace(self.journal.events)

    def export_perfetto(self, path) -> None:
        """Write the Perfetto trace to `path` (strict JSON, loadable at
        https://ui.perfetto.dev)."""
        import json
        from pathlib import Path

        Path(path).write_text(json.dumps(self.perfetto(), allow_nan=False))
