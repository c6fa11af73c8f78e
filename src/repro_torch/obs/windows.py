"""Rolling-window metrics: fixed virtual-time buckets of the Fig. 8/9 axes.

`Telemetry` answers "how did the run go overall"; `WindowedMetrics` answers
"what did it look like in the 0.5 s around the swap".  Counters, gauges and
busy-seconds are bucketed into fixed windows of the virtual clock (window
index = ``int(t / window_s)``); `series()` renders them as contiguous,
strict-JSON time series — attainment, goodput, queue depth/delay, batch
size, per-class utilization, in-flight count — per window.

Busy time is split exactly across window boundaries, so per-window
utilization sums back to the end-of-run aggregate (the invariant
tests/test_obs.py pins for every counter here).
"""

from __future__ import annotations


class _Window:
    __slots__ = ("arrivals", "completions", "ok", "drops", "dispatches",
                 "batch_sum", "qdelay_sum", "qdelay_n", "qdelay_max",
                 "depth_sum", "depth_n", "depth_max", "inflight_max", "busy")

    def __init__(self) -> None:
        self.arrivals = 0
        self.completions = 0
        self.ok = 0
        self.drops: dict[str, int] = {}
        self.dispatches = 0
        self.batch_sum = 0
        self.qdelay_sum = 0.0
        self.qdelay_n = 0
        self.qdelay_max = 0.0
        self.depth_sum = 0
        self.depth_n = 0
        self.depth_max = 0
        self.inflight_max = 0
        self.busy: dict[str, float] = {}


class WindowedMetrics:
    """Per-window counters/gauges on the virtual clock."""

    def __init__(self, window_s: float = 0.5) -> None:
        if not window_s > 0:
            raise ValueError(f"window_s must be > 0, got {window_s}")
        self.window_s = float(window_s)
        self._w: dict[int, _Window] = {}

    def _at(self, t: float) -> _Window:
        idx = int(t / self.window_s) if t > 0 else 0
        w = self._w.get(idx)
        if w is None:
            w = self._w[idx] = _Window()
        return w

    # ------------------------------------------------------------- recording
    def observe_arrival(self, t: float) -> None:
        self._at(t).arrivals += 1

    def observe_drop(self, t: float, cause: str) -> None:
        w = self._at(t)
        w.drops[cause] = w.drops.get(cause, 0) + 1

    def observe_complete(self, t: float, ok: bool) -> None:
        w = self._at(t)
        w.completions += 1
        if ok:
            w.ok += 1

    def observe_dispatch(self, t: float, batch_size: int, queue_depth: int,
                         inflight: int, queue_delays_s=()) -> None:
        """One dispatch: gauges plus the dispatched requests' queue delays
        (taken in one call — this runs on the scheduling hot path)."""
        w = self._at(t)
        w.dispatches += 1
        w.batch_sum += batch_size
        w.depth_sum += queue_depth
        w.depth_n += 1
        if queue_depth > w.depth_max:
            w.depth_max = queue_depth
        if inflight > w.inflight_max:
            w.inflight_max = inflight
        for d in queue_delays_s:
            w.qdelay_sum += d
            w.qdelay_n += 1
            if d > w.qdelay_max:
                w.qdelay_max = d

    def observe_busy(self, accel_class: str, start: float, dur: float) -> None:
        """Accumulate busy seconds, split exactly at window boundaries."""
        if dur <= 0:
            return
        end = start + dur
        t = max(start, 0.0)
        ws = self.window_s
        idx = int(t / ws)
        while t < end:
            edge = (idx + 1) * ws
            if edge <= t:
                # Non-dyadic ws: int(t/ws) can lag a window, making the
                # computed edge land at/before t.  Window `idx` ends before
                # t, so it gets no share — step the index, never stall.
                idx += 1
                continue
            part = min(end, edge) - t
            w = self._w.get(idx)
            if w is None:
                w = self._w[idx] = _Window()
            w.busy[accel_class] = w.busy.get(accel_class, 0.0) + part
            t = edge
            idx += 1

    # -------------------------------------------------------------- totals
    def totals(self) -> dict:
        """End-of-run sums over all windows (the cross-check surface)."""
        arrivals = completions = ok = dispatches = batch_sum = 0
        drops: dict[str, int] = {}
        busy_s: dict[str, float] = {}
        for w in self._w.values():
            arrivals += w.arrivals
            completions += w.completions
            ok += w.ok
            dispatches += w.dispatches
            batch_sum += w.batch_sum
            for c, n in w.drops.items():
                drops[c] = drops.get(c, 0) + n
            for c, b in w.busy.items():
                busy_s[c] = busy_s.get(c, 0.0) + b
        return {"arrivals": arrivals, "completions": completions, "ok": ok,
                "dispatches": dispatches, "batch_sum": batch_sum,
                "drops": drops, "busy_s": busy_s}

    # -------------------------------------------------------------- series
    def series(self, horizon_s: float = 0.0,
               cluster_counts: dict[str, int] | None = None) -> dict:
        """Contiguous per-window time series, strict-JSON.

        Windows with no activity appear as zeros (None for the undefined
        ratios), so downstream plots get an even time axis.  `horizon_s`
        extends the axis to the end of the run; `cluster_counts` (chips per
        class) turns busy seconds into utilization fractions.
        """
        ws = self.window_s
        # windows needed to cover the horizon: ceil, but a horizon landing
        # exactly on a window edge must not open a spurious empty window
        n_h = 0
        if horizon_s > 0:
            n_h = int(horizon_s / ws)
            if n_h * ws < horizon_s - 1e-12:
                n_h += 1
        n = max(len(self._w) and max(self._w) + 1, n_h, 1)
        empty = _Window()
        wins = [self._w.get(i, empty) for i in range(n)]
        classes = sorted({c for w in wins for c in w.busy})
        drop_causes = sorted({c for w in wins for c in w.drops})
        out: dict = {
            "window_s": ws,
            "n_windows": n,
            "t_s": [round(i * ws, 9) for i in range(n)],
            "arrivals": [w.arrivals for w in wins],
            "completions": [w.completions for w in wins],
            "ok": [w.ok for w in wins],
            "attainment": [w.ok / w.completions if w.completions else None
                           for w in wins],
            "goodput_rps": [w.ok / ws for w in wins],
            "drops": {c: [w.drops.get(c, 0) for w in wins]
                      for c in drop_causes},
            "dispatches": [w.dispatches for w in wins],
            "mean_batch_size": [w.batch_sum / w.dispatches if w.dispatches
                                else None for w in wins],
            "queue_depth_mean": [w.depth_sum / w.depth_n if w.depth_n
                                 else None for w in wins],
            "queue_depth_max": [w.depth_max for w in wins],
            "queue_delay_mean_ms": [w.qdelay_sum / w.qdelay_n * 1e3
                                    if w.qdelay_n else None for w in wins],
            "queue_delay_max_ms": [w.qdelay_max * 1e3 for w in wins],
            "inflight_max": [w.inflight_max for w in wins],
            "busy_s": {c: [w.busy.get(c, 0.0) for w in wins]
                       for c in classes},
        }
        if cluster_counts:
            out["utilization"] = {
                c: [w.busy.get(c, 0.0) / (cluster_counts[c] * ws)
                    for w in wins]
                for c in classes if cluster_counts.get(c)
            }
        # cumulative-so-far view for open-ended serves: at each window edge,
        # the running totals and the attainment/goodput a dashboard would
        # show "as of now" (goodput denominates over elapsed virtual time,
        # i.e. the right edge of the window)
        arr_c: list[int] = []
        comp_c: list[int] = []
        ok_c: list[int] = []
        att_c: list[float | None] = []
        good_c: list[float] = []
        a = comp = ok = 0
        for i, w in enumerate(wins):
            a += w.arrivals
            comp += w.completions
            ok += w.ok
            arr_c.append(a)
            comp_c.append(comp)
            ok_c.append(ok)
            att_c.append(ok / comp if comp else None)
            good_c.append(ok / ((i + 1) * ws))
        out["cumulative"] = {
            "arrivals": arr_c,
            "completions": comp_c,
            "ok": ok_c,
            "attainment": att_c,
            "goodput_rps": good_c,
        }
        return out
