"""repro_torch.api against the reference's repro.api: config validation
and dict round-trips, the Session lifecycle, sim-mode reports and journals
equal to the reference's float for float, open-loop serving with
backpressure, and real mode on the CPU (the port's entry points run on
CUDA unless the session is given another device; here it is the CPU, where
every kernel wrapper runs its plain version).

The port's public surface is the reference's plus one keyword, the
session's `device`; the snapshot tests below pin both."""

import dataclasses
import inspect
import json

import pytest
import torch

import repro.api as ref_api
import repro_torch.api as api
from repro.data import requests as ref_requests
from repro.stream import PoissonSource as RefPoissonSource
from repro_torch.api import (
    ClusterSpec,
    ConfigError,
    LifecycleError,
    ModelSpec,
    ObsConfig,
    ServeConfig,
    Session,
)
from repro_torch.core.types import Request, replace
from repro_torch.data import requests
from repro_torch.stream import PoissonSource, TraceSource

from test_torch_controlplane import run_key

COUNTS = {"tpu-hi": 2, "tpu-lo": 4}
MODEL = "stablelm-3b"
TINY = dict(n_layers=4, d_model=128, d_ff=256, n_heads=4, kv_heads=4, vocab=512)


def _config(m=api, **over):
    base = dict(cluster=m.ClusterSpec(counts=dict(COUNTS)),
                models=(m.ModelSpec(arch=MODEL, seq_len=256, n_blocks=5),))
    base.update(over)
    return m.ServeConfig(**base)


# ---------------------------------------------------------------------------
# Config validation + serialization
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mutation, match", [
    (dict(models=()), "empty"),
    (dict(models=(ModelSpec(arch="no-such-arch"),)), "unknown arch"),
    (dict(models=(ModelSpec(arch=MODEL), ModelSpec(arch=MODEL))), "duplicate"),
    (dict(models=(ModelSpec(arch=MODEL, slo_scale=0.0),)), "slo_scale"),
    (dict(models=(ModelSpec(arch=MODEL, n_blocks=1),)), "n_blocks"),
    (dict(backend="magic"), "unknown planner backend"),
    (dict(feedback="psychic"), "feedback"),
    (dict(source="vibes"), "source"),
    (dict(cluster=ClusterSpec(counts={"tpu-quantum": 4})), "accelerator class"),
    (dict(cluster=ClusterSpec(counts={"h200": 1})), "accelerator class"),
    (dict(cluster=ClusterSpec(counts={"tpu-hi": 0})), "count"),
    (dict(cluster=ClusterSpec(counts={"h100": 1, "l4": 0})), "count"),
    (dict(gc_interval_s=0.0), "gc_interval_s"),
    (dict(max_inflight=0), "max_inflight"),
    (dict(vfracs=()), "vfracs"),
    (dict(obs=ObsConfig(level="verbose")), "obs.level"),
    (dict(obs=ObsConfig(window_s=0.0)), "obs.window_s"),
    (dict(obs=ObsConfig(span_sampling=1.5)), "obs.span_sampling"),
])
def test_config_validation_rejects(mutation, match):
    with pytest.raises(ConfigError, match=match):
        _config(**mutation).validate()


def test_gpu_classes_validate():
    cfg = _config(cluster=ClusterSpec(counts={"h100": 1, "a100": 2, "l4": 8, "t4": 4}))
    assert cfg.validate() is cfg


def _rich(m):
    return _config(
        m,
        objective=m.Objective(slo_margin=0.3, weights={MODEL: 2.0}),
        admission=m.AdmissionPolicy(max_depth=16),
        replan=m.ReplanConfig(window_s=1.0, source="measured"),
        replan_policy=m.PolicyConfig(cooldown_s=2.0),
        obs=m.ObsConfig(level="trace", window_s=0.5),
        vfracs=(1, 2),
        batch_sizes=(1, 4),
    )


def test_config_dict_round_trip_equals_reference():
    """The port's dict encoding is the reference's, key for key, and both
    round-trip losslessly through strict JSON."""
    mine, ref = _rich(api), _rich(ref_api)
    assert mine.to_dict() == ref.to_dict()
    assert ServeConfig.from_dict(json.loads(json.dumps(mine.to_dict()))) == mine
    assert ServeConfig.from_dict(ref.to_dict()) == mine
    gpu = _config(cluster=ClusterSpec(counts={"h100": 1, "l4": 8}))
    assert ServeConfig.from_dict(json.loads(json.dumps(gpu.to_dict()))) == gpu


def test_config_from_dict_rejects_malformed():
    d = _config().to_dict()
    d["objective"]["no_such_knob"] = 1
    with pytest.raises(ConfigError, match="malformed"):
        ServeConfig.from_dict(d)
    with pytest.raises(ConfigError, match="malformed"):
        ServeConfig.from_dict({})
    incomplete = _config().to_dict()
    del incomplete["replan"]
    with pytest.raises(ConfigError, match="malformed"):
        ServeConfig.from_dict(incomplete)


# ---------------------------------------------------------------------------
# Lifecycle misuse (tests/test_api.py:99)
# ---------------------------------------------------------------------------


def test_lifecycle_misuse_raises():
    session = Session.from_config(_config())
    req = Request(arrival_s=0.0, req_id=0, model_name=MODEL, deadline_s=1.0)
    with pytest.raises(LifecycleError, match="deploy"):
        session.submit(req)
    with pytest.raises(LifecycleError, match="deploy"):
        session.run([req])
    with pytest.raises(LifecycleError, match="deploy"):
        session.swap()
    with pytest.raises(LifecycleError, match="deploy"):
        session.enable_replanning()
    with pytest.raises(LifecycleError, match="profile"):
        session.store  # noqa: B018 — the property access IS the test
    session.deploy(mode="sim")  # auto-chains profile() + plan()
    with pytest.raises(LifecycleError, match="twice"):
        session.deploy(mode="sim")
    with pytest.raises(LifecycleError, match="swap"):
        session.plan()
    with pytest.raises(LifecycleError, match="real"):
        session.prepare_swap(session.cluster_plan)
    session.shutdown()
    session.shutdown()  # idempotent
    with pytest.raises(LifecycleError, match="closed"):
        session.run([req])
    with pytest.raises(LifecycleError, match="closed"):
        session.profile()


def test_measured_feedback_requires_real_deploy():
    with pytest.raises(LifecycleError, match="real"):
        Session.from_config(_config(feedback="measured")).deploy(mode="sim")


def test_duplicate_pending_req_id_rejected():
    session = Session.from_config(_config()).deploy(mode="sim")
    req = Request(arrival_s=0.0, req_id=7, model_name=MODEL, deadline_s=1.0)
    session.submit(req)
    with pytest.raises(ConfigError, match="duplicate"):
        session.submit(req)


def test_profile_model_takes_the_fastest_class_explicitly():
    """profile_model pre-partitions on the cluster's fastest class, named
    explicitly (the port's pre_partition has no default class): the h100
    of a GPU cluster, and the reference's profile on a TPU one."""
    from repro_torch.configs import get_config
    from repro_torch.core import blocks, types
    from repro_torch.models.model_zoo import layer_costs

    spec = ModelSpec(arch=MODEL, seq_len=128, n_blocks=6)
    prof = api.profile_model(spec, ClusterSpec(counts={"h100": 1, "l4": 8}))
    want = blocks.build_profile(MODEL, layer_costs(get_config(MODEL), 128), 1.0,
                                n_blocks=6, accel=types.H100)
    assert prof.blocks == want.blocks
    tpu = api.profile_model(spec, ClusterSpec(counts=dict(COUNTS)))
    ref = ref_api.profile_model(ref_api.ModelSpec(arch=MODEL, seq_len=128, n_blocks=6),
                                ref_api.ClusterSpec(counts=dict(COUNTS)))
    assert dataclasses.asdict(tpu) == dataclasses.asdict(ref)


# ---------------------------------------------------------------------------
# Sim mode: the reference's reports and journals, float for float
# ---------------------------------------------------------------------------


def _sim_report(m, reqs, level="off", load=0.9, horizon=1.5):
    session = m.Session.from_config(_config(m, obs=m.ObsConfig(level=level)))
    plan = session.plan()
    session.deploy(mode="sim")
    prof = session.store.profiles[MODEL]
    trace = reqs.poisson_trace(plan.throughput * load, horizon, prof.slo_s, MODEL, seed=3)
    report = session.run(trace)
    return session, plan, trace, report


@pytest.mark.parametrize("level", ["off", "aggregate", "trace"])
def test_session_run_report_equals_reference(level):
    """Session(sim).run(trace) -> Report.as_dict() float-identical to the
    reference's, and with observability on, the same journal."""
    _, plan, trace, mine = _sim_report(api, requests, level)
    _, ref_plan, ref_trace, ref = _sim_report(ref_api, ref_requests, level)
    assert [dataclasses.asdict(r) for r in trace] == [dataclasses.asdict(r) for r in ref_trace]
    assert mine.as_dict() == ref.as_dict()
    assert run_key(mine.telemetry, mine.obs) == run_key(ref.telemetry, ref.obs)
    assert (mine.obs is None) == (level == "off") and mine.served > 0


def test_run_matches_handwired_dataplane_float_identically():
    """tests/test_api.py:146 for the port: Session.run equals DataPlane.serve
    on the same plan, exactly."""
    from repro_torch.core.runtime import build_runtime
    from repro_torch.dataplane.plane import serve_trace

    session, plan, trace, report = _sim_report(api, requests)
    tel = serve_trace(build_runtime(plan, dict(session.store.profiles)), trace)
    assert {o.req_id: (o.completion_s, o.pipeline_id) for o in report.telemetry.outcomes} == \
        {o.req_id: (o.completion_s, o.pipeline_id) for o in tel.outcomes}
    assert report.attainment == tel.attainment
    assert report.goodput_rps == tel.goodput_rps
    assert report.utilization == tel.utilization
    assert report.telemetry.probes_per_dispatch == tel.probes_per_dispatch


def test_sim_swap_equals_reference():
    """A managed swap mid-trace to a re-solved plan (other weights)."""
    def run(m, reqs):
        session = m.Session.from_config(_config(m, obs=m.ObsConfig(level="trace")))
        plan = session.plan()
        session.deploy(mode="sim")
        prof = session.store.profiles[MODEL]
        trace = reqs.poisson_trace(plan.throughput * 0.8, 1.0, prof.slo_s, MODEL, seed=5)
        mid = trace[len(trace) // 2].arrival_s
        state = {}

        def hook(req, t):
            if not state and t > mid:
                state["rec"] = session.swap(now=t, objective=m.Objective(slo_margin=0.2))

        session.on_arrival(hook)
        rep = session.run(trace)
        return rep, state["rec"]

    mine, rec = run(api, requests)
    ref, ref_rec = run(ref_api, ref_requests)
    assert run_key(mine.telemetry, mine.obs) == run_key(ref.telemetry, ref.obs)
    assert (rec.t_s, rec.reason, rec.new_ranges, rec.prepared) == \
        (ref_rec.t_s, ref_rec.reason, ref_rec.new_ranges, ref_rec.prepared)
    assert mine.plan_swaps == 1


def _overload(m, source_cls):
    """tests/test_stream.py's overload run: 4x the planned throughput into
    a depth-6 watermark, through Session.serve."""
    session = m.Session.from_config(_config(
        m, models=(m.ModelSpec(arch=MODEL, seq_len=256, n_blocks=5, slo_scale=20.0),),
        admission=m.AdmissionPolicy(high_watermark=6, low_watermark=2),
        obs=m.ObsConfig(level="aggregate", window_s=0.25)))
    plan = session.plan()
    session.deploy(mode="sim")
    slo = session.store.profiles[MODEL].slo_s
    rep = session.serve(source_cls(plan.throughput * 4.0, slo_s=slo, model_name=MODEL, seed=7),
                        horizon_s=1.0)
    return rep


def test_serve_stream_backpressure_equals_reference():
    mine, ref = _overload(api, PoissonSource), _overload(ref_api, RefPoissonSource)
    assert run_key(mine.telemetry, mine.obs) == run_key(ref.telemetry, ref.obs)
    assert mine.telemetry.backpressure_events == ref.telemetry.backpressure_events
    edges = [e[2] for e in mine.telemetry.backpressure_events]
    assert edges[0] == "shed" and edges[-1] == "resume"
    assert mine.telemetry.backpressure_rejects > 0


def test_handles_resolve_with_run_and_drain():
    session = Session.from_config(_config())
    plan = session.plan()
    session.deploy(mode="sim")
    prof = session.store.profiles[MODEL]
    trace = requests.poisson_trace(plan.throughput * 0.5, 0.5, prof.slo_s, MODEL, seed=4)
    handles = [session.submit(r) for r in trace]
    assert not any(h.done for h in handles)
    assert handles[0].result() is handles[0].outcome
    assert all(h.done for h in handles)
    served = [h for h in handles if h.latency_s is not None]
    assert served and all(h.latency_s > 0 for h in served)
    assert len(session.report().telemetry.outcomes) == len(trace)


def test_drain_rejects_arrivals_behind_served_horizon():
    session = Session.from_config(_config())
    plan = session.plan()
    session.deploy(mode="sim")
    prof = session.store.profiles[MODEL]
    trace = requests.poisson_trace(plan.throughput * 0.5, 0.5, prof.slo_s, MODEL, seed=6)
    session.run(trace)
    horizon = session.telemetry.horizon_s
    session.submit(Request(arrival_s=0.0, req_id=10**15, model_name=MODEL,
                           deadline_s=prof.slo_s))
    with pytest.raises(LifecycleError, match="horizon"):
        session.drain()
    session._pending.clear()
    session._open.clear()
    cont = [replace(r, arrival_s=r.arrival_s + horizon, deadline_s=r.deadline_s + horizon,
                    req_id=r.req_id + 10**9) for r in trace]
    assert len(session.run(cont).telemetry.outcomes) == 2 * len(trace)


def test_run_and_serve_trace_source_bit_identical():
    def deployed():
        s = Session.from_config(_config())
        return s, s.plan(), s.deploy(mode="sim")

    sa, plan, _ = deployed()
    sb, _, _ = deployed()
    slo = sa.store.profiles[MODEL].slo_s
    trace = requests.poisson_trace(plan.throughput * 1.2, 1.0, slo, MODEL, seed=3)
    ra, rb = sa.run(trace), sb.serve(TraceSource(trace))
    assert ra.telemetry.outcomes == rb.telemetry.outcomes
    assert ra.telemetry.snapshot() == rb.telemetry.snapshot()


# ---------------------------------------------------------------------------
# Real mode on the CPU: executors, warmed swaps, the executor cache
# ---------------------------------------------------------------------------


def _tiny_config(**over):
    base = dict(cluster=ClusterSpec(counts={"tpu-hi": 1, "tpu-lo": 2}),
                models=(ModelSpec(arch=MODEL, reduced=dict(TINY), n_blocks=4, seq_len=16,
                                  slo_scale=8.0),),
                serve_seq_len=16)
    base.update(over)
    return ServeConfig(**base)


def _staged_plans(session):
    """Two hand-pinned 2-stage plans with disjoint block ranges (the
    re-partitioning swap of tests/test_api.py's real_session_setup)."""
    from repro_torch.core import costmodel as cm
    from repro_torch.core.plan import ClusterPlan, PipelinePlan, StagePlan

    prof = session.store.profiles[MODEL]
    tbl = session.store.analytic_table(MODEL)
    cl = session.config.cluster
    n = prof.n_blocks

    def staged(cut, bs=4):
        return ClusterPlan(cluster=cl, pipelines=[PipelinePlan(
            model_name=MODEL, batch_size=bs,
            stages=(StagePlan(0, cut, "tpu-lo", 1, 2, tbl.partition(0, cut, "tpu-lo", 1, bs)),
                    StagePlan(cut, n, "tpu-hi", 1, 1, tbl.partition(cut, n, "tpu-hi", 1, bs))),
            xfer_latency_s=(cm.transfer_latency(prof, cl, "tpu-lo", "tpu-hi", cut, bs),),
        )])

    return staged(n // 2), staged(n // 2 + 1)


@pytest.fixture(scope="module")
def real_session_setup():
    session = Session.from_config(_tiny_config(), device="cpu")
    session.profile()
    plan_a, plan_b = _staged_plans(session)
    session.use_plan(plan_a)
    session.deploy(mode="real")
    yield session, plan_a, plan_b, session.store.profiles[MODEL]
    session.shutdown()


def test_real_deploy_runs_on_the_named_device():
    """Without a device the session means the card: on a machine without
    one, deploy("real") raises instead of falling back to the CPU."""
    assert Session.from_config(_tiny_config()).device == torch.device("cuda")
    if not torch.cuda.is_available():
        with pytest.raises((RuntimeError, AssertionError)):
            Session.from_config(_tiny_config()).deploy(mode="real")


def test_real_mode_serves_every_request_on_the_cpu(real_session_setup):
    """deploy("real") on the CPU: the session's executors run the stage
    programs (their plain kernels), every request resolves, and the
    executors' parameters come from the session's seed."""
    session, plan_a, _, prof = real_session_setup
    disp = session.dataplane.dispatcher
    before = disp.submitted
    t0 = session.telemetry.horizon_s
    trace = requests.poisson_trace(plan_a.throughput * 0.5, 12 / (plan_a.throughput * 0.5),
                                   prof.slo_s, MODEL, seed=2)
    trace = [replace(r, arrival_s=r.arrival_s + t0, deadline_s=r.deadline_s + t0,
                     req_id=r.req_id + 10**6) for r in trace]
    handles = [session.submit(r) for r in trace]
    session.drain()
    assert all(h.done for h in handles)
    assert disp.submitted > before
    ex = next(iter(session._exec_cache.values()))
    assert ex.device == torch.device("cpu")
    again = Session.from_config(_tiny_config(), device="cpu")
    again.use_plan(plan_a)
    again.deploy(mode="real")
    p0, p1 = ex.params, next(iter(again._exec_cache.values())).params
    assert all(torch.equal(a, b) for a, b in zip(p0.parameters(), p1.parameters()))


def test_swap_to_new_partitioning_warms_before_install(real_session_setup):
    """tests/test_api.py:281 for the port: prepare_swap warms the new
    ranges on a background thread, the swap consumes it, serving goes on."""
    session, plan_a, plan_b, prof = real_session_setup
    a_ranges = {(s.block_start, s.block_end) for pp in plan_a.pipelines for s in pp.stages}
    b_ranges = {(s.block_start, s.block_end) for pp in plan_b.pipelines for s in pp.stages}
    assert not (a_ranges & b_ranges), "fixture must re-partition"
    missing = session.missing_ranges(plan_b)
    assert len(missing) == len(b_ranges)
    t0 = session.telemetry.horizon_s
    rate = plan_a.throughput * 0.5
    trace = requests.poisson_trace(rate, 24 / rate, prof.slo_s, MODEL, seed=5)
    trace = [replace(r, arrival_s=r.arrival_s + t0, deadline_s=r.deadline_s + t0,
                     req_id=r.req_id + 10**7) for r in trace]
    mid = trace[len(trace) // 2].arrival_s
    state = {}

    def hook(req, t):
        if "prep" not in state and t > mid:
            state["prep"] = session.prepare_swap(plan_b)
        elif "rec" not in state and "prep" in state:
            state["rec"] = session.swap(plan_b, now=t, reason="repartition")

    session.on_arrival(hook)
    report = session.run(trace)
    rec = state["rec"]
    assert rec.prepared, "the prepared background warm was not consumed"
    assert sorted(rec.new_ranges) == missing
    assert rec.reused_executors == 0
    assert session.missing_ranges(plan_b) == []
    assert report.telemetry.plan_swaps == 1
    assert all(o.req_id in {r.req_id for r in trace} or o.req_id < 10**7
               for o in report.telemetry.outcomes)
    assert {r.req_id for r in trace} <= {o.req_id for o in report.telemetry.outcomes}


def test_enable_replanning_wires_recalibration_and_warm_factory(real_session_setup):
    from repro_torch.core.runtime import build_runtime

    fixture_session, plan_a, plan_b, _ = real_session_setup
    cfg = dataclasses.replace(fixture_session.config, feedback="measured")
    with Session.from_config(cfg, store=fixture_session.store, device="cpu") as session:
        session.use_plan(plan_a)
        session.deploy(mode="real")
        loop = session.enable_replanning()
        assert loop.dispatcher_factory == session._dispatcher_factory
        assert loop.runtime_setup is not None
        new_rt = build_runtime(plan_b, dict(session.store.profiles))
        loop.runtime_setup(new_rt)
        assert all(s.latency(1) > 0 for p in new_rt.pipelines for s in p.stages)
        disp = loop.dispatcher_factory(new_rt)
        assert session.missing_ranges(plan_b) == []
        assert disp.executors


def test_swap_back_reuses_cached_executors(real_session_setup):
    """tests/test_api.py:349 for the port."""
    session, plan_a, _, _ = real_session_setup
    rec = session.swap(plan_a, now=session._vnow + 1.0, reason="back")
    assert rec.new_ranges == ()
    assert rec.reused_executors == sum(len(pp.stages) for pp in plan_a.pipelines)
    assert not rec.prepared


def test_epoch_gc_releases_graphs_no_live_plan_uses():
    """The data plane's epoch GC drops the CUDA graphs of the retired
    epoch's executors that no dispatcher still serves with, and keeps those
    of executors the live plan shares (graphs stand in as markers here:
    the CPU captures none, and its calls count no graph miss)."""
    from repro_torch.serving.engine import GRAPH_STATS

    session = Session.from_config(_tiny_config(), device="cpu")
    session.profile()
    plan_a, plan_b = _staged_plans(session)
    session.use_plan(plan_a)
    session.deploy(mode="real")
    misses = GRAPH_STATS.misses
    a_execs = session.dataplane.dispatcher.executors[0]
    for ex in a_execs:
        ex.graphs[("marker",)] = object()
    session.swap(plan_b, now=session._vnow + 1.0, reason="repartition")
    assert session.telemetry.epochs_gcd == 1
    assert all(ex.graphs == {} for ex in a_execs)
    b_execs = session.dataplane.dispatcher.executors[0]
    for ex in a_execs + b_execs:
        ex.graphs[("marker",)] = object()
    session.swap(plan_a, now=session._vnow + 2.0, reason="back")
    assert session.telemetry.epochs_gcd == 2
    assert all(ex.graphs == {} for ex in b_execs)
    assert all(ex.graphs for ex in a_execs)  # the live plan's: kept
    session.run([])
    assert GRAPH_STATS.misses == misses
    session.shutdown()


def test_graph_capture_pauses_the_cyclic_collector():
    """`serving.engine.gc_paused`, around every stage and train-step
    capture: the collector is off inside (a collection could destroy another
    CUDA graph on the capturing thread, which invalidates the capture),
    back on when the last of several threads' captures ends, and left off
    if it was off."""
    import gc
    import threading

    from repro_torch.serving.engine import gc_paused

    assert gc.isenabled()
    entered, leave = threading.Event(), threading.Event()

    def other_capture():
        with gc_paused():
            entered.set()
            leave.wait(30)

    with gc_paused():
        assert not gc.isenabled()
        worker = threading.Thread(target=other_capture)
        worker.start()
        assert entered.wait(30)
    assert not gc.isenabled()  # the other thread still captures
    leave.set()
    worker.join(30)
    assert gc.isenabled()
    gc.disable()
    try:
        with gc_paused():
            assert not gc.isenabled()
        assert not gc.isenabled()
    finally:
        gc.enable()


def test_graph_capture_collector_pause_under_thread_churn():
    """More threads than cores entering and leaving `gc_paused` at a short
    switch interval: the collector is off whenever any of them is inside,
    and on again after the last leaves."""
    import gc
    import os
    import sys
    import threading

    from repro_torch.serving.engine import gc_paused

    n = 2 * (os.cpu_count() or 4)
    seen_on = []

    def churn():
        for _ in range(200):
            with gc_paused():
                if gc.isenabled():
                    seen_on.append(True)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        workers = [threading.Thread(target=churn) for _ in range(n)]
        for w in workers:
            w.start()
        for w in workers:
            w.join(60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(w.is_alive() for w in workers)
    assert not seen_on and gc.isenabled()


# ---------------------------------------------------------------------------
# Public-surface snapshot (tests/test_api.py:409, :422)
# ---------------------------------------------------------------------------

_DEVICE = "device: 'torch.device | str | None' = None"


def test_public_api_snapshot():
    """The reference's surface, plus the session's `device` keyword."""
    import test_api

    assert sorted(api.__all__) == test_api.EXPECTED_ALL == sorted(ref_api.__all__)
    for name in api.__all__:
        assert hasattr(api, name), f"__all__ names missing symbol {name}"
    for dotted, want in test_api.EXPECTED_SIGNATURES.items():
        obj = api
        for part in dotted.split("."):
            obj = getattr(obj, part)
        if dotted == "Session.from_config":
            want = want.replace("= None) ->", f"= None, {_DEVICE}) ->")
        assert str(inspect.signature(obj)) == want, dotted
    assert str(inspect.signature(Session.__init__)).endswith(f"{_DEVICE}) -> 'None'")


def test_config_field_surface_snapshot():
    for mine, ref in ((ModelSpec, ref_api.ModelSpec), (ServeConfig, ref_api.ServeConfig)):
        assert [f.name for f in dataclasses.fields(mine)] == \
            [f.name for f in dataclasses.fields(ref)]
    assert [f.name for f in dataclasses.fields(api.SwapRecord)] == \
        [f.name for f in dataclasses.fields(ref_api.SwapRecord)]
