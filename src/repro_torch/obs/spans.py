"""Span trees + Chrome/Perfetto ``trace_event`` export, derived from the
decision journal.

There is deliberately no live span bookkeeping: the journal (journal.py) is
the single source of truth, and this module reconstructs the causal span
tree of every traced request at export time — arrive -> queue -> batch
dispatch -> per-stage exec -> inter-pool transfer -> complete/drop — plus
per-chip / per-NIC resource tracks and a control-plane track (drift
estimates, replan verdicts, plan swaps with their transient).

`perfetto_trace()` emits the Chrome ``trace_event`` JSON flavour Perfetto
loads directly (https://ui.perfetto.dev -> open trace file): complete
("X") events with microsecond timestamps, one process per view —

* pid 1 ``requests``  — one thread per traced request (lifecycle spans)
* pid 2 ``chips``     — one thread per physical chip (stage executions)
* pid 3 ``nics``      — one thread per NIC direction (transfers)
* pid 4 ``control``   — swaps/drift/replan instants + swap-transient spans

Everything runs on the virtual clock; on a calibrated real deployment the
virtual clock *is* the wall clock (DESIGN.md section 3), and the dispatcher's
raw wall measurements remain available as ``batch.wall`` journal events.
"""

from __future__ import annotations

_US = 1e6  # virtual seconds -> trace_event microseconds


def request_trees(events: list[dict]) -> dict[int, dict]:
    """Reconstruct the span tree of every traced request.

    Returns ``{req_id: tree}`` where a tree is a dict with ``start_s``,
    ``end_s`` (None while pending), ``status`` ("served" | "dropped:<cause>"
    | "pending"), ``batch_id`` and ``children`` — the "queue" span plus one
    span per stage execution / transfer of the request's batch, each
    carrying its ``resource`` label.
    """
    arrive: dict[int, dict] = {}
    drop: dict[int, dict] = {}
    complete: dict[int, dict] = {}
    batch_of: dict[int, int] = {}
    batches: dict[int, dict] = {}
    stages: dict[int, list[dict]] = {}
    xfers: dict[int, list[dict]] = {}
    for ev in events:
        kind = ev["kind"]
        if kind == "req.arrive":
            arrive[ev["req_id"]] = ev
        elif kind == "req.drop":
            drop[ev["req_id"]] = ev
        elif kind == "req.complete":
            complete[ev["req_id"]] = ev
        elif kind == "batch.dispatch":
            batches[ev["batch_id"]] = ev
            for rid in ev["req_ids"]:
                batch_of[rid] = ev["batch_id"]
        elif kind == "exec.stage":
            stages.setdefault(ev["batch_id"], []).append(ev)
        elif kind == "exec.xfer":
            xfers.setdefault(ev["batch_id"], []).append(ev)

    trees: dict[int, dict] = {}
    for rid, ev in arrive.items():
        t0 = ev["t_s"]
        children: list[dict] = []
        node: dict = {"req_id": rid, "model": ev["model"], "start_s": t0,
                      "end_s": None, "status": "pending", "batch_id": None,
                      "children": children}
        if rid in complete:
            node["end_s"] = complete[rid]["t_s"]
            node["status"] = "served"
        elif rid in drop:
            node["end_s"] = drop[rid]["t_s"]
            node["status"] = f"dropped:{drop[rid]['cause']}"
        bid = batch_of.get(rid)
        if bid is not None and rid in complete:
            node["batch_id"] = bid
            d = batches[bid]
            children.append({
                "name": "queue", "start_s": t0, "end_s": d["t_s"],
                "resource": ["queue", d["pipeline_id"]]})
            for s in sorted(stages.get(bid, ()), key=lambda e: e["stage_idx"]):
                children.append({
                    "name": f"stage{s['stage_idx']}",
                    "start_s": s["start_s"],
                    "end_s": s["start_s"] + s["dur_s"],
                    "resource": ["chip", s["accel_class"], s["chip_id"]]})
            for x in sorted(xfers.get(bid, ()), key=lambda e: e["start_s"]):
                children.append({
                    "name": "xfer",
                    "start_s": x["start_s"],
                    "end_s": x["start_s"] + x["dur_s"],
                    "resource": ["nic", *x["ul"], "ul"]})
        trees[rid] = node
    return trees


def _meta(pid: int, name: str, tid: int | None = None,
          tname: str | None = None) -> list[dict]:
    out = [{"ph": "M", "pid": pid, "name": "process_name",
            "args": {"name": name}}]
    if tid is not None:
        out.append({"ph": "M", "pid": pid, "tid": tid, "name": "thread_name",
                    "args": {"name": tname}})
    return out


def perfetto_trace(events: list[dict]) -> dict:
    """Render the journal as Chrome/Perfetto ``trace_event`` JSON."""
    te: list[dict] = []
    te += _meta(1, "requests")
    te += _meta(2, "chips")
    te += _meta(3, "nics")
    te += _meta(4, "control")
    te += _meta(4, "control", tid=1, tname="control plane")

    # --- pid 1: request lifecycle (req_ids can be paper-scale striped ints,
    # so threads get small enumerated tids with the real id in the name)
    trees = request_trees(events)
    req_tid = {rid: i + 1 for i, rid in enumerate(
        sorted(trees, key=lambda r: (trees[r]["start_s"], r)))}
    for rid, tree in trees.items():
        tid = req_tid[rid]
        te += _meta(1, "requests", tid=tid,
                    tname=f"req {rid} ({tree['model']})")[1:]
        end = tree["end_s"] if tree["end_s"] is not None else tree["start_s"]
        te.append({"ph": "X", "pid": 1, "tid": tid,
                   "name": f"request [{tree['status']}]", "cat": "request",
                   "ts": tree["start_s"] * _US,
                   "dur": max(end - tree["start_s"], 0.0) * _US,
                   "args": {"req_id": rid, "status": tree["status"]}})
        for child in tree["children"]:
            te.append({"ph": "X", "pid": 1, "tid": tid, "name": child["name"],
                       "cat": "request", "ts": child["start_s"] * _US,
                       "dur": max(child["end_s"] - child["start_s"], 0.0) * _US,
                       "args": {"resource": child["resource"]}})

    # --- pid 2/3: physical resource tracks
    chip_tid: dict[tuple, int] = {}
    nic_tid: dict[tuple, int] = {}
    for ev in events:
        if ev["kind"] == "exec.stage":
            key = (ev["accel_class"], ev["chip_id"])
            tid = chip_tid.get(key)
            if tid is None:
                tid = chip_tid[key] = len(chip_tid) + 1
                te += _meta(2, "chips", tid=tid,
                            tname=f"{key[0]} chip {key[1]}")[1:]
            te.append({"ph": "X", "pid": 2, "tid": tid,
                       "name": f"e{ev['epoch']} p{ev['pipeline_id']} "
                               f"s{ev['stage_idx']} b{ev['batch_size']}",
                       "cat": "exec", "ts": ev["start_s"] * _US,
                       "dur": max(ev["dur_s"], 0.0) * _US,
                       "args": {"batch_id": ev["batch_id"],
                                "epoch": ev["epoch"],
                                "vdev_id": ev["vdev_id"]}})
        elif ev["kind"] == "exec.xfer":
            for direction, key in (("ul", tuple(ev["ul"])),
                                   ("dl", tuple(ev["dl"]))):
                nkey = (*key, direction)
                tid = nic_tid.get(nkey)
                if tid is None:
                    tid = nic_tid[nkey] = len(nic_tid) + 1
                    te += _meta(3, "nics", tid=tid,
                                tname=f"{key[0]} host {key[1]} {direction}")[1:]
                te.append({"ph": "X", "pid": 3, "tid": tid,
                           "name": f"e{ev['epoch']} xfer", "cat": "xfer",
                           "ts": ev["start_s"] * _US,
                           "dur": max(ev["dur_s"], 0.0) * _US,
                           "args": {"batch_id": ev["batch_id"],
                                    "epoch": ev["epoch"]}})

    # --- pid 4: control plane
    for ev in events:
        kind = ev["kind"]
        if kind == "plan.swap":
            te.append({"ph": "i", "pid": 4, "tid": 1, "s": "g",
                       "name": f"plan.swap e{ev['epoch_from']}->"
                               f"e{ev['epoch_to']} ({ev['reason']})",
                       "cat": "control", "ts": ev["t_s"] * _US,
                       "args": {k: ev[k] for k in
                                ("epoch_from", "epoch_to", "reason",
                                 "transient_s", "carried")}})
            if ev["transient_s"] > 0:
                te.append({"ph": "X", "pid": 4, "tid": 1,
                           "name": "swap transient", "cat": "control",
                           "ts": ev["t_s"] * _US,
                           "dur": ev["transient_s"] * _US,
                           "args": {"reason": ev["reason"]}})
        elif kind == "drift.estimate":
            te.append({"ph": "i", "pid": 4, "tid": 1, "s": "t",
                       "name": f"drift rate_rel={ev['rate_rel']:.3f} "
                               f"mix_tv={ev['mix_tv']:.3f}"
                               + (" TRIP" if ev["tripped"] else ""),
                       "cat": "control", "ts": ev["t_s"] * _US,
                       "args": {k: ev[k] for k in
                                ("rate_rel", "mix_tv", "tripped")}})
        elif kind == "replan.decision":
            verdict = "accept" if ev.get("accepted") else "reject"
            te.append({"ph": "i", "pid": 4, "tid": 1, "s": "t",
                       "name": f"replan.{verdict}", "cat": "control",
                       "ts": ev["t_s"] * _US,
                       "args": {k: v for k, v in ev.items()
                                if k not in ("kind",)}})
        elif kind in ("replan.failure", "replan.success",
                      "admit.shed", "admit.resume"):
            te.append({"ph": "i", "pid": 4, "tid": 1, "s": "t",
                       "name": kind, "cat": "control",
                       "ts": ev["t_s"] * _US,
                       "args": {k: v for k, v in ev.items()
                                if k not in ("kind",)}})

    return {"traceEvents": te, "displayTimeUnit": "ms"}
