"""The port's discrete-event simulator, frozen scheduler and deprecation
shims, held to the reference package: the same trace through either
package's `run_simulation` gives the same outcomes, attainment,
utilization and probes, float for float; the reference's simulator-parity
and scheduler-equivalence tests pass unchanged on the port's modules; and
each shim warns and resolves to the object its non-deprecated path names."""

import dataclasses
import importlib
import inspect
import re
import warnings
from pathlib import Path

import pytest

import repro.core as ref_core
import repro.core.blocks as ref_blocks
import repro.core.costmodel as ref_cm
import repro.core.runtime as ref_runtime
import repro.core.simulator as ref_simulator
import repro.core.types as ref_types
import repro.data.requests as ref_requests
import repro_torch.core as core
import repro_torch.core.blocks as blocks
import repro_torch.core.costmodel as cm
import repro_torch.core.runtime as runtime_mod
import repro_torch.core.simulator as simulator
import repro_torch.core.types as types
import repro_torch.data.requests as requests

REF = dict(core=ref_core, blocks=ref_blocks, cm=ref_cm, runtime=ref_runtime,
           simulator=ref_simulator, types=ref_types, requests=ref_requests)
PORT = dict(core=core, blocks=blocks, cm=cm, runtime=runtime_mod, simulator=simulator,
            types=types, requests=requests)
TESTS = Path(__file__).resolve().parent


def _setup(m, slo=0.03, n_layers=12, counts=None):
    """tests/test_simulator.py's `_setup`, from one package's modules `m`."""
    counts = counts or {"tpu-hi": 3, "tpu-lo": 6}
    c = m["cm"]
    layers = [c.embed_cost(256, 1024, 32000)]
    for i in range(n_layers):
        layers.append(c.layer_sequence_cost(f"l{i}", [
            c.attention_cost(256, 1024, 16, 4), c.mlp_cost(256, 1024, 4096)]))
    layers.append(c.head_cost(256, 1024, 32000))
    prof = m["blocks"].build_profile("m", layers, slo, n_blocks=6, accel=m["types"].TPU_HI)
    cluster = m["types"].ClusterSpec(counts=counts)
    tbl = c.build_latency_table(prof, cluster)
    res = m["core"].plan_cluster({"m": prof}, {"m": tbl}, cluster, slo_margin=0.4)
    return prof, res.plan


# every trace of tests/test_simulator.py: (setup kwargs, load factor,
# horizon, seed, generator, run_simulation kwargs)
_CONTENTION = dict(slo=0.02, n_layers=16, counts={"tpu-hi": 2, "tpu-lo": 8})
_SIM_CASES = {
    "low_load": ({}, 0.3, 5.0, 0, "poisson", {}),
    "load_0.4": ({}, 0.4, 5.0, 1, "poisson", {}),
    "load_0.9": ({}, 0.9, 5.0, 1, "poisson", {}),
    "load_1.4": ({}, 1.4, 5.0, 1, "poisson", {}),
    "noise": ({}, 0.6, 5.0, 2, "poisson", {"noise_sigma": 0.05}),
    "utilization_0.3": ({}, 0.3, 5.0, 3, "poisson", {}),
    "utilization_0.8": ({}, 0.8, 5.0, 3, "poisson", {}),
    "poisson_0.9": ({}, 0.9, 6.0, 4, "poisson", {}),
    "bursty_0.9": ({}, 0.9, 6.0, 4, "bursty", {}),
    "contention_reservation": (_CONTENTION, 0.9, 6.0, 5, "poisson", {}),
    "contention_reactive": (_CONTENTION, 0.9, 6.0, 5, "poisson", {"reactive": True}),
    "drops": ({}, 2.5, 3.0, 6, "poisson", {}),
    "probes": ({}, 0.8, 4.0, 7, "poisson", {}),
}


def _simulate(m, case):
    setup, lf, horizon, seed, gen, kw = _SIM_CASES[case]
    prof, plan = _setup(m, **setup)
    trace = getattr(m["requests"], f"{gen}_trace")(plan.throughput * lf, horizon, prof.slo_s,
                                                   "m", seed=seed)
    sim = m["simulator"].run_simulation(m["runtime"].build_runtime(plan, {"m": prof}), trace,
                                        **kw)
    return plan, trace, sim


@pytest.mark.parametrize("case", list(_SIM_CASES))
def test_run_simulation_equals_reference(case):
    """Outcome for outcome (request, completion, deadline, pipeline), with
    the same attainment, utilization by class, probes a dispatch and
    transfer times, on the same plan and trace."""
    ref_plan, ref_trace, ref_sim = _simulate(REF, case)
    plan, trace, sim = _simulate(PORT, case)
    assert plan.throughput == ref_plan.throughput
    assert [dataclasses.asdict(r) for r in trace] == [dataclasses.asdict(r) for r in ref_trace]
    assert len(sim.outcomes) == len(trace)
    assert dataclasses.asdict(sim) == dataclasses.asdict(ref_sim)
    assert sim.attainment == ref_sim.attainment


@pytest.fixture
def tpu_hi_default(monkeypatch):
    """The reference pre-partitions on TPU_HI where its caller names no
    class; the port's `build_profile` needs the class named
    (core/blocks.py).  Name the reference's default for the reference's own
    test code run on the port."""
    build = blocks.build_profile

    def build_on_tpu_hi(*args, accel=None, **kw):
        return build(*args, accel=accel or types.TPU_HI, **kw)

    monkeypatch.setattr(blocks, "build_profile", build_on_tpu_hi)


def _port_module(name: str):
    """A reference test module of tests/, executed with its `repro.` imports
    pointed at `repro_torch.`: its helpers and tests then drive the port's
    modules, line for line as they drive the reference's."""
    src = (TESTS / f"{name}.py").read_text()
    src = src.replace("from repro.", "from repro_torch.").replace("import repro.",
                                                                  "import repro_torch.")
    assert not re.search(r"^\s*(from|import) repro\b(?!_torch)", src, re.M)
    module = type(importlib)(f"port_{name}")
    module.__file__ = str(TESTS / f"{name}.py")
    exec(compile(src, module.__file__, "exec"), module.__dict__)
    return module


_SCHED = _port_module("test_sched_equivalence")
# the seeded tests (no hypothesis decorator, no fixture): the reference's
# loops, here against the port's _reference and optimized scheduler
_SEEDED = sorted(
    name for name, fn in vars(_SCHED).items()
    if name.startswith("test_") and inspect.isfunction(fn)
    and not inspect.signature(fn).parameters and not hasattr(fn, "hypothesis"))


def test_seeded_equivalence_tests_found():
    assert len(_SEEDED) >= 18
    assert "test_dataplane_equivalent_under_reference_scheduler" in _SEEDED
    assert _SCHED.ReferenceReservationScheduler.__module__ == "repro_torch.core._reference"
    assert _SCHED.ReservationScheduler.__module__ == "repro_torch.core.scheduler"


@pytest.mark.parametrize("name", _SEEDED)
def test_port_scheduler_equivalence(name, tpu_hi_default):
    """tests/test_sched_equivalence.py's seeded test `name` on the port:
    the port's frozen scheduler and its optimized one decide bit for bit
    alike (dispatches, drops, waits, final timelines)."""
    getattr(_SCHED, name)()


@pytest.mark.parametrize("bursty", [False, True])
def test_parity_with_simulator(bursty, tpu_hi_default):
    """tests/test_dataplane.py's `test_parity_with_simulator` on the port's
    DataPlane and simulator, and both equal to the reference's simulator
    on the same trace."""
    port = _port_module("test_dataplane")
    port.test_parity_with_simulator(bursty)
    ref = importlib.import_module("test_dataplane")
    gen = "bursty_trace" if bursty else "poisson_trace"
    sims = []
    for m, mod in ((REF, ref), (PORT, port)):
        trace = getattr(m["requests"], gen)(mod.PLAN.throughput * 0.9, 1.5, mod.PROF.slo_s, "m",
                                            seed=3)
        sims.append(m["simulator"].run_simulation(mod._runtime(), trace, noise_sigma=0.0))
    assert dataclasses.asdict(sims[1]) == dataclasses.asdict(sims[0])


# ---------------------------------------------------------------- shims

_SHIMS = [("repro_torch.core.milp", "solve_milp", "repro_torch.controlplane.milp"),
          ("repro_torch.core.enumerate", "plan_cluster", "repro_torch.controlplane.templates"),
          ("repro_torch.core.baselines", "plan_np", "repro_torch.controlplane.baselines"),
          ("repro_torch.core.baselines", "plan_dart_r", "repro_torch.controlplane.baselines")]


@pytest.mark.parametrize("shim,attr,target", _SHIMS)
def test_core_shim_warns_and_resolves(shim, attr, target):
    mod = importlib.import_module(shim)
    with pytest.warns(DeprecationWarning, match="has moved to"):
        value = getattr(mod, attr)
    assert value is getattr(importlib.import_module(target), attr)
    assert attr in dir(mod)
    with pytest.raises(AttributeError):
        mod.__no_such_dunder__


@pytest.mark.parametrize("name", sorted(core._LAZY))
def test_core_lazy_reexports(name):
    """`repro_torch.core`'s lazy table (the reference's, with the port's
    paths): each name resolves to its module's object (the three shim
    modules to themselves), is cached, and is listed by dir()."""
    module, attr = core._LAZY[name]
    ref_module, ref_attr = ref_core._LAZY[name]
    assert (module.replace("repro_torch.", "repro."), attr) == (ref_module, ref_attr)
    want = importlib.import_module(module)
    if attr is not None:
        want = getattr(want, attr)
    assert getattr(core, name) is want
    assert core.__dict__[name] is want
    assert name in dir(core)


def test_core_unknown_name_raises():
    with pytest.raises(AttributeError, match="no attribute"):
        core.no_such_planner


def test_dataplane_serve_trace_shim():
    """`repro_torch.dataplane.serve_trace` warns on every access and is the
    bare helper of `repro_torch.dataplane.plane`; the package's other names
    import without a warning."""
    import repro_torch.dataplane as dp
    from repro_torch.dataplane.plane import serve_trace

    for _ in range(2):
        with pytest.warns(DeprecationWarning, match="repro_torch.api.Session"):
            assert dp.serve_trace is serve_trace
    assert "serve_trace" in dir(dp)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert dp.DataPlane is not None and dp.calibrate_runtime is not None
    with pytest.raises(AttributeError):
        dp.no_such_helper


def test_simulator_and_reference_scheduler_are_copies():
    """The two device-free modules are the reference's, line for line."""
    for name in ("simulator", "_reference"):
        mine = (TESTS.parent / "src" / "repro_torch" / "core" / f"{name}.py").read_text()
        ref = (TESTS.parent / "src" / "repro" / "core" / f"{name}.py").read_text()
        assert mine == ref
