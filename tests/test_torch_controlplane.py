"""The port's control plane, observability, streams, faults and the
epoch/fault half of its data plane, held to the reference package.

`repro_torch.controlplane`, `obs`, `stream` and `faults` are copies of the
reference's device-free modules, and `repro_torch.dataplane.plane` ports
the reference's event loop line for line.  Every scenario here runs twice
from the same numbers, once through each package's modules, and the
results must be equal exactly: plans (stages, classes, vfracs, pool sizes,
batch sizes, latencies), outcomes, telemetry snapshots and journal events.

Both packages solve with the same scipy (HiGHS) on the same matrices, so
even solver ties resolve the same way; the plan tests assert equality of
the whole plan, which implies equal objectives.

The GPU class table lives in the port's `core/types.py` only; the
reference's table keeps its four TPU classes.
"""

import dataclasses
import importlib
import json
from types import SimpleNamespace

import numpy as np
import pytest

_MODULES = dict(cm="core.costmodel", blocks="core.blocks", types="core.types",
                runtime="core.runtime", cp="controlplane", requests="data.requests",
                dataplane="dataplane", faults="faults", obs="obs", stream="stream")


def _package(root: str) -> SimpleNamespace:
    return SimpleNamespace(**{k: importlib.import_module(f"{root}.{v}")
                              for k, v in _MODULES.items()})


REF, PORT = _package("repro"), _package("repro_torch")
COUNTS = {"tpu-hi": 2, "tpu-lo": 4}


def cluster(m, counts=None):
    return m.types.ClusterSpec(counts=dict(counts or COUNTS))


def profile(m, n_layers=8, n_blocks=4, slo=0.03, seed=0, seq=256, name="m"):
    """The reference suites' synthetic profile (tests/test_controlplane.py
    `_profile`), pre-partitioned on the reference's default class, named."""
    rng = np.random.default_rng(seed)
    layers = [m.cm.embed_cost(seq, 1024, 32000)]
    for i in range(n_layers):
        layers.append(m.cm.layer_sequence_cost(f"l{i}", [
            m.cm.attention_cost(seq, 1024, 16, 4),
            m.cm.mlp_cost(seq, 1024, int(rng.uniform(2048, 8192))),
        ]))
    layers.append(m.cm.head_cost(seq, 1024, 32000))
    return m.blocks.build_profile(name, layers, slo, n_blocks=n_blocks,
                                  accel=m.types.TPU_HI)


def store(m, profs, counts=None):
    s = m.cp.ProfileStore(cluster(m, counts), vfracs=(1, 2), batch_sizes=(1, 2))
    for p in profs.values():
        s.add(p, m.cm.build_latency_table(p, cluster(m, counts), vfracs=(1, 2),
                                          batch_sizes=(1, 2)))
    return s


def two_plan_setup(m):
    """Two models whose SLOs sit between the classes' whole-model latencies
    (plans must partition), and two plans weighted to one model or the
    other: the reference's epoch-lifecycle and faults scenario."""
    profs = {f"m{i}": profile(m, seed=i, name=f"m{i}", n_layers=6, n_blocks=3)
             for i in range(2)}
    cl = cluster(m)
    hi, lo = cl.accel("tpu-hi"), cl.accel("tpu-lo")
    for name, p in profs.items():
        whole_hi = sum(m.cm.block_latency(b, hi, 1, 1) for b in p.blocks)
        whole_lo = sum(m.cm.block_latency(b, lo, 1, 1) for b in p.blocks)
        profs[name] = m.types.replace(
            p, slo_s=(whole_hi * 1.4 + whole_lo * 0.6) / 2 / 0.6)
    planner = m.cp.Planner(objective=m.cp.Objective(slo_margin=0.4, max_partitions=2))
    st = store(m, profs)
    plan_a = planner.plan(profs, st.tables(), cl, objective=planner.objective.with_weights(
        {"m0": 0.9, "m1": 0.1}))
    plan_b = planner.plan(profs, st.tables(), cl, objective=planner.objective.with_weights(
        {"m0": 0.1, "m1": 0.9}))
    return profs, st, planner, plan_a, plan_b


def trace_for(m, profs, plan, horizon_s, load=0.7, seed=0):
    rates = {k: max(plan.throughput_of(k), 1.0) * load for k in profs}
    slos = {k: p.slo_s for k, p in profs.items()}
    return m.requests.multi_model_trace(rates, horizon_s, slos, seed=seed)


def plan_key(plan) -> list:
    """Everything a plan decides: per pipeline its model, batch size,
    stages (blocks, class, vfrac, pool size, latency) and transfers."""
    return [(p.model_name, p.batch_size,
             [(s.block_start, s.block_end, s.accel_class, s.vfrac, s.n_vdev, s.latency_s)
              for s in p.stages], tuple(p.xfer_latency_s))
            for p in plan.pipelines]


def _virtual(data):
    """`data` without its host-clock readings (keys naming a wall time,
    such as a solver's `solver_wall_s`), which differ run to run."""
    if isinstance(data, dict):
        return {k: _virtual(v) for k, v in data.items() if "wall" not in k}
    if isinstance(data, list):
        return [_virtual(v) for v in data]
    return data


def run_key(tel, obs=None) -> dict:
    """A served run: outcomes, dispatches, the telemetry snapshot, the
    replan decisions and the journal, as plain data on the virtual clock."""
    out = {
        "outcomes": [dataclasses.asdict(o) for o in tel.outcomes],
        "dispatches": [dataclasses.asdict(d) for d in tel.dispatches],
        "snapshot": json.loads(json.dumps(tel.snapshot())),
        "swap_log": list(tel.swap_log),
        "replan": json.loads(json.dumps(tel.replan_decisions)),
    }
    if obs is not None:
        out["journal"] = json.loads(json.dumps(obs.journal.events))
        out["series"] = json.loads(json.dumps(obs.timeseries()))
    return _virtual(out)


def observer(m, level="trace"):
    return m.obs.Observer(m.obs.ObsConfig(level=level))


# ---------------------------------------------------------------------------
# Planner: every backend, the same plan as the reference's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("backend", ["enumerate", "milp", "np", "dart-r"])
def test_planner_backend_plans_equal_reference(backend):
    def solve(m):
        prof = profile(m, n_layers=6, n_blocks=3, slo=0.02)
        obj = m.cp.Objective(slo_margin=0.4, max_partitions=2, time_limit_s=30.0)
        planner = m.cp.Planner(backend=backend, objective=obj)
        plan = planner.plan({"m": prof}, store(m, {"m": prof}).tables(), cluster(m))
        return plan_key(plan), plan.throughput

    ref, port = solve(REF), solve(PORT)
    assert port == ref and ref[1] > 0


@pytest.mark.parametrize("backend", ["enumerate", "milp"])
def test_planner_multimodel_weighted_plans_equal_reference(backend):
    def solve(m):
        profs = {f"m{i}": profile(m, seed=i, name=f"m{i}", n_blocks=3) for i in range(2)}
        planner = m.cp.Planner(backend=backend,
                               objective=m.cp.Objective(max_partitions=2, slo_margin=0.4))
        obj = planner.objective.with_weights({"m0": 2.0, "m1": 1.0})
        plan = planner.plan(profs, store(m, profs).tables(), cluster(m), objective=obj)
        return plan_key(plan), {k: plan.throughput_of(k) for k in profs}

    ref, port = solve(REF), solve(PORT)
    assert port == ref and all(v > 0 for v in ref[1].values())


def test_warm_started_resolve_equals_reference():
    """A re-solve on a shrunk cluster, warm-started from the incumbent (the
    path `Session.resize` takes)."""
    def solve(m):
        profs, st, planner, plan_a, _ = two_plan_setup(m)
        small = cluster(m, {"tpu-hi": 2, "tpu-lo": 3})
        plan = planner.plan(profs, st.tables(), small, incumbent=None)
        warm = planner.plan(profs, st.tables(), cluster(m), incumbent=plan)
        return plan_key(plan_a), plan_key(plan), plan_key(warm)

    assert solve(PORT) == solve(REF)


def test_profile_store_tables_equal_reference():
    def tables(m):
        prof = profile(m, n_blocks=4)
        tbl = store(m, {"m": prof}).tables()["m"]
        n = prof.n_blocks
        return {(i, j, c, v, b): tbl.partition(i, j, c, v, b)
                for i in range(n) for j in range(i + 1, n + 1)
                for c in COUNTS for v in (1, 2) for b in (1, 2)}

    assert tables(PORT) == tables(REF)


# ---------------------------------------------------------------------------
# The data plane's epoch and fault paths, and the observer
# ---------------------------------------------------------------------------


def _swap_run(m, level):
    """Scripted swaps between the two plans mid-trace (the reference's
    epoch-lifecycle scenario), observed at `level` or not at all."""
    profs, _, _, plan_a, plan_b = two_plan_setup(m)
    trace = trace_for(m, profs, plan_a, 4.0, load=0.85, seed=9)
    obs = observer(m, level) if level else None
    dp = m.dataplane.DataPlane(m.runtime.build_runtime(plan_a, profs), observer=obs)
    swaps = [0.5, 1.5, 2.5]

    def hook(req, t):
        if swaps and t >= swaps[0]:
            i = 3 - len(swaps)
            swaps.pop(0)
            dp.swap_plan(plan_b if i % 2 == 0 else plan_a, profs, now=t,
                         reason=f"script#{i}")

    dp.arrival_hooks.append(hook)
    tel = dp.serve(trace)
    assert tel.plan_swaps == 3 and len(tel.outcomes) == len(trace)
    return run_key(tel, obs) | {"gc": tel.epochs_gcd, "transients": tel.swap_transient_s}


@pytest.mark.parametrize("level", [None, "aggregate", "trace"], ids=["off", "aggregate", "trace"])
def test_swap_plan_runs_equal_reference(level):
    assert _swap_run(PORT, level) == _swap_run(REF, level)


def _fault_run(m, kind):
    profs, st, planner, plan_a, _ = two_plan_setup(m)
    obs = observer(m)
    dp = m.dataplane.DataPlane(m.runtime.build_runtime(plan_a, profs), observer=obs)
    F = m.faults
    if kind == "exec_fault":
        trace = trace_for(m, profs, plan_a, 2.0, load=0.5, seed=4)
        F.FaultInjector(F.FaultSchedule([F.FaultEvent(0.5, "exec_fault", count=2)]),
                        max_retries=1).attach(dp)
    elif kind == "chip_slowdown":
        trace = trace_for(m, profs, plan_a, 2.0, load=0.4, seed=2)
        F.FaultInjector(F.FaultSchedule([F.FaultEvent(
            0.3, "chip_slowdown", accel_class="tpu-hi", factor=3.0)])).attach(dp)
    else:  # node loss under a replan loop that must install a mandatory plan
        trace = trace_for(m, profs, plan_a, 5.0, load=0.6, seed=8)
        loop = m.cp.ReplanLoop(
            planner=planner, store=st, cluster=cluster(m), dataplane=dp,
            config=m.cp.ReplanConfig(window_s=0.4, check_interval_s=0.2, min_requests=8),
            policy=m.cp.ReplanPolicy(m.cp.PolicyConfig(cooldown_s=2.0))).attach()
        loop.set_baseline({k: plan_a.throughput_of(k) for k in profs})
        state = {}

        def hook(req, now):
            if "t" not in state and now >= 2.0:
                state["t"] = now
                state["res"] = dp.fail_host("tpu-lo", now=now)

        dp.arrival_hooks.append(hook)
    tel = dp.serve(trace)
    assert len({o.req_id for o in tel.outcomes}) == len(trace)
    counters = (tel.faults_injected, tel.exec_failures, tel.retries, tel.retry_exhausted,
                tel.node_losses, tel.node_loss_drops, tel.plan_swaps)
    return run_key(tel, obs) | {"counters": counters}


@pytest.mark.parametrize("kind", ["exec_fault", "chip_slowdown", "node_loss"])
def test_fault_injection_runs_equal_reference(kind):
    port, ref = _fault_run(PORT, kind), _fault_run(REF, kind)
    assert port == ref
    faults_injected, exec_failures, retries, _, node_losses, _, swaps = ref["counters"]
    if kind == "exec_fault":
        assert exec_failures == 2 and retries >= 1
    elif kind == "chip_slowdown":
        assert faults_injected == 1
    else:
        assert node_losses == 1 and swaps >= 1


def test_serve_of_a_trace_equals_serve_stream_of_its_source():
    """serve(trace) and serve_stream(TraceSource(trace)) agree exactly in
    the port, as in the reference."""
    profs, _, _, plan_a, _ = two_plan_setup(PORT)
    trace = trace_for(PORT, profs, plan_a, 1.5, load=1.1, seed=3)
    a = PORT.dataplane.DataPlane(PORT.runtime.build_runtime(plan_a, profs)).serve(trace)
    b = PORT.dataplane.DataPlane(PORT.runtime.build_runtime(plan_a, profs)).serve_stream(
        PORT.stream.TraceSource(trace).arrivals())
    assert a.outcomes == b.outcomes and a.snapshot() == b.snapshot()


def test_replan_loop_on_mix_drift_equals_reference():
    """A drift-driven re-solve and live swap with a ReplanLoop attached (the
    reference's test_replan_loop_triggers_on_mix_drift_and_improves_fit):
    the same decisions, swaps and outcomes as the reference's."""
    def run(m):
        profs = {f"m{i}": profile(m, seed=i, slo=0.03, name=f"m{i}") for i in range(2)}
        st = store(m, profs)
        planner = m.cp.Planner(objective=m.cp.Objective(slo_margin=0.4, max_partitions=2))
        plan0 = planner.plan(profs, st.tables(), cluster(m),
                             objective=planner.objective.with_weights({"m0": 0.9, "m1": 0.1}))
        rate = plan0.throughput * 0.8
        slos = {k: p.slo_s for k, p in profs.items()}
        first = m.requests.multi_model_trace({"m0": rate * 0.9, "m1": rate * 0.1}, 1.0,
                                             slos, seed=1)
        second = [m.types.replace(r, arrival_s=r.arrival_s + 1.0, deadline_s=r.deadline_s + 1.0,
                                  req_id=r.req_id + 10_000_000)
                  for r in m.requests.multi_model_trace(
                      {"m0": rate * 0.1, "m1": rate * 0.9}, 1.0, slos, seed=2)]
        obs = observer(m)
        dp = m.dataplane.DataPlane(m.runtime.build_runtime(plan0, profs), observer=obs)
        loop = m.cp.ReplanLoop(
            planner=planner, store=st, cluster=cluster(m), dataplane=dp,
            config=m.cp.ReplanConfig(window_s=0.4, check_interval_s=0.2, min_requests=8,
                                     max_swaps=2)).attach()
        loop.set_baseline({"m0": rate * 0.9, "m1": rate * 0.1})
        tel = dp.serve(sorted(first + second))
        return run_key(tel, obs) | {"events": len(loop.events), "plan": plan_key(dp.rt.plan)}

    port, ref = run(PORT), run(REF)
    assert port == ref and ref["events"] >= 1 and ref["snapshot"]["plan_swaps"] >= 1


# ---------------------------------------------------------------------------
# The GPU class table and explicit accelerator classes
# ---------------------------------------------------------------------------


def test_gpu_class_table():
    T = PORT.types
    gpus = {"h100": T.H100, "a100": T.A100, "l4": T.L4, "t4": T.T4}
    assert (T.H100.peak_flops, T.H100.hbm_bw) == (989e12, 3.35e12)
    assert (T.A100.peak_flops, T.A100.hbm_bw) == (312e12, 2.0e12)
    assert (T.L4.peak_flops, T.L4.hbm_bw) == (121e12, 300e9)
    assert (T.T4.peak_flops, T.T4.hbm_bw) == (65e12, 320e9)
    assert all(T.ACCEL_CLASSES[n] is c and c.name == n for n, c in gpus.items())
    # the TPU classes stay, equal to the reference's, whose table has no GPU
    assert set(T.ACCEL_CLASSES) == set(REF.types.ACCEL_CLASSES) | set(gpus)
    assert {n: dataclasses.asdict(c) for n, c in REF.types.ACCEL_CLASSES.items()} == \
        {n: dataclasses.asdict(T.ACCEL_CLASSES[n]) for n in REF.types.ACCEL_CLASSES}
    assert not set(gpus) & set(REF.types.ACCEL_CLASSES)
    # one card's memory rate sets the order of the classes' batch-1 latency
    prof = profile(PORT)
    lat = {n: sum(PORT.cm.block_latency(b, c, 1, 1) for b in prof.blocks)
           for n, c in gpus.items()}
    assert lat["h100"] < lat["a100"] < min(lat["l4"], lat["t4"])


def test_pre_partition_refuses_without_an_accelerator_class():
    prof = profile(PORT)
    layers = [PORT.cm.embed_cost(16, 64, 100), PORT.cm.head_cost(16, 64, 100)]
    with pytest.raises(ValueError, match="explicit accelerator class"):
        PORT.blocks.build_profile("m", layers, 1.0, n_blocks=2)
    with pytest.raises(ValueError, match="explicit accelerator class"):
        PORT.blocks.pre_partition(layers, 2)
    # with a GPU class the same greedy sweep as the reference's
    ref_h100 = REF.types.AcceleratorClass(**dataclasses.asdict(PORT.types.H100))
    costs = [PORT.cm.embed_cost(256, 1024, 32000)] + [
        PORT.cm.mlp_cost(256, 1024, 2048 * (1 + i % 3)) for i in range(9)]
    ref_costs = [REF.cm.LayerCost(**dataclasses.asdict(c)) for c in costs]
    assert [dataclasses.asdict(b) for b in
            PORT.blocks.pre_partition(costs, 4, PORT.types.H100)] == \
        [dataclasses.asdict(b) for b in REF.blocks.pre_partition(ref_costs, 4, ref_h100)]
    assert prof.n_blocks == 4


def test_full_width_gpu_cluster_plan_pools_the_low_class():
    """What the card's smoke run plans: full-width stablelm-3b at seq 128,
    6 blocks, on one h100 and eight l4 stand-ins.  At the ModelSpec's
    default SLO (5x the h100 batch-1 latency) the planner feeds the h100
    from a pool of l4s; at 3x no l4 stage fits the SLO and the h100 serves
    alone."""
    from repro_torch.api import ClusterSpec, ModelSpec, ServeConfig, Session

    def solve(scale):
        cfg = ServeConfig(cluster=ClusterSpec(counts={"h100": 1, "l4": 8}),
                          models=(ModelSpec(arch="stablelm-3b", n_blocks=6, seq_len=128,
                                            slo_scale=scale),), serve_seq_len=128)
        return Session.from_config(cfg).plan()

    pooled = solve(5.0)
    (p,) = pooled.pipelines
    assert [s.accel_class for s in p.stages] == ["l4", "h100"]
    assert p.stages[0].n_vdev > 1 and p.stages[1].n_vdev == 1
    alone = solve(3.0)
    assert [[s.accel_class for s in q.stages] for q in alone.pipelines] == [["h100"]]
    assert pooled.throughput > alone.throughput
