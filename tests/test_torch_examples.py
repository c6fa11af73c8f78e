"""The port's examples (`python -m repro_torch.examples.<name>`) against the
reference's `examples/*.py`.

With the reference's TPU classes set in each port example's cluster
constant, the port prints the reference's lines: `quickstart`,
`plan_explorer --quick` and `stream_serve --quick` apart from the
solver's wall-clock `solver=... ms`; `serve_pipeline --quick --device cpu`
in acts 1, 2 and 4 apart from wall-clock fields, while its act 3, calibrated
from measured walls, prints the same pinned plan and serves every request.
On the port's own GPU classes every example runs and its asserts hold; and
a stage executor that raises makes `serve_workload` raise.

The port's runs use one CPU thread: its real mode times tiny stage programs
on the wall clock (act 3), where several threads a process contend with
the other test workers.  Act 3 must serve every request even when its
calibration or its feedback makes batch 1 slower than a full batch."""

import contextlib
import io
import re
import runpy
import sys
import time
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
TPU = {"quickstart": {"tpu-hi": 4, "tpu-lo": 12},
       "plan_explorer": {"tpu-hi": 4, "tpu-lo": 12},
       "stream_serve": {"tpu-hi": 2, "tpu-lo": 4},
       "serve_pipeline": {"tpu-hi": 1, "tpu-lo": 8}}
ARGV = {"quickstart": [], "plan_explorer": ["--quick"], "stream_serve": ["--quick"],
        "serve_pipeline": ["--quick"]}
_SOLVER = re.compile(r"solver=[0-9.]+ ms")
_WALL = re.compile(r"\([0-9.]+s wall\)")
_SWAP_WALL = re.compile(r"took [0-9.]+ ms wall \(compile [0-9.]+ ms,")
_SERVED = re.compile(r"^  served (\d+)/(\d+) \(attainment", re.M)


def _mask(out: str) -> str:
    out = _SOLVER.sub("solver=<wall> ms", out)
    out = _WALL.sub("(<wall>)", out)
    return _SWAP_WALL.sub("took <wall> (compile <wall>,", out)


@pytest.fixture(scope="module")
def reference():
    """Each reference example's stdout, run once for the module."""
    outs = {}

    def get(name: str) -> str:
        if name not in outs:
            argv = sys.argv
            sys.argv = [f"{name}.py", *ARGV[name]]
            buf = io.StringIO()
            try:
                with contextlib.redirect_stdout(buf):
                    runpy.run_path(str(REPO / "examples" / f"{name}.py"), run_name="__main__")
            finally:
                sys.argv = argv
            outs[name] = buf.getvalue()
        return outs[name]

    return get


@pytest.fixture
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port(name: str, argv: list[str], monkeypatch, cluster=None, **constants):
    """Run the port's example `name` in this process; (stdout, main's return)."""
    import importlib

    mod = importlib.import_module(f"repro_torch.examples.{name}")
    if cluster is not None:
        monkeypatch.setattr(mod, "CLUSTER", dict(cluster))
    for k, v in constants.items():
        monkeypatch.setattr(mod, k, v)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        ret = mod.main(argv)
    return buf.getvalue(), ret


def _tpu_constants(name: str) -> dict:
    # stream_serve's backpressure act takes the reference's 20x SLO on its
    # TPU classes (the port's GPU classes need 30x; its docstring says why)
    return {"BACKPRESSURE_SLO_SCALE": 20.0} if name == "stream_serve" else {}


@pytest.mark.parametrize("name", ["quickstart", "plan_explorer", "stream_serve"])
def test_sim_example_prints_the_references_lines(name, reference, monkeypatch, one_thread):
    ref = reference(name)
    mine, _ = _port(name, ARGV[name], monkeypatch, TPU[name], **_tpu_constants(name))
    assert "ClusterPlan:" in ref or "[parity]" in ref
    assert _SOLVER.sub("solver=<wall> ms", mine) == _SOLVER.sub("solver=<wall> ms", ref)


def _act3(lines: list[str]) -> tuple[int, int]:
    """The span of act 3's calibrated lines: from `calibrated:` to the line
    before act 4's header."""
    start = next(i for i, s in enumerate(lines) if s.startswith("calibrated:"))
    end = next(i for i, s in enumerate(lines) if s.startswith("[live swap]"))
    return start, end


def test_serve_pipeline_prints_the_references_plans_and_counts(reference, monkeypatch,
                                                               one_thread):
    ref = _mask(reference("serve_pipeline")).splitlines()
    out, results = _port("serve_pipeline", ["--quick", "--device", "cpu"], monkeypatch,
                         TPU["serve_pipeline"])
    mine = _mask(out).splitlines()
    (r0, r1), (m0, m1) = _act3(ref), _act3(mine)
    # acts 1, 2 and 4 and act 3's pinned plan (printed before its
    # calibration): line for line
    assert mine[:m0] == ref[:r0] and mine[m1:] == ref[r1:]
    assert "tpu-lo x3" in "\n".join(mine[:m0])  # the pinned 2-stage plan
    # act 3: calibrated from this run's walls, so its trace differs; every
    # request is served
    served = _SERVED.findall("\n".join(mine[m0:m1]))
    assert served and all(a == b for a, b in served)
    assert [r["name"] for r in results] == ["poisson", "bursty", "bursty/measured 2-stage",
                                            "live swap"]
    assert all(r["served"] == r["n"] for r in results)


@pytest.mark.parametrize("name", ["quickstart", "plan_explorer", "stream_serve",
                                  "serve_pipeline"])
def test_example_runs_on_the_gpu_classes(name, monkeypatch, one_thread):
    """Each example on its own cluster constant (the port's GPU classes):
    it runs to its end, so every assert in it holds."""
    argv = ARGV[name] + (["--device", "cpu"] if name == "serve_pipeline" else [])
    out, _ = _port(name, argv, monkeypatch)
    assert "h100" in out or name == "stream_serve"
    assert "tpu" not in out
    if name == "stream_serve":
        assert re.search(r"\n  ([1-9]\d*) shed / \1 resume edges", out)


def test_stream_serve_backpressure_at_the_references_slo_sheds_nothing_on_gpu_classes():
    """Why stream_serve's act 2 takes a 30x SLO on the GPU classes: at the
    reference's 20x the MILP partitions the model, the scheduler drops the
    backlog at scheduling time, and no watermark edge fires (the act's
    `max(edge depths)` would have no edge to read)."""
    from repro_torch.api import AdmissionPolicy, ModelSpec, Session
    from repro_torch.examples import stream_serve as ex
    from repro_torch.stream import PoissonSource

    def act2(slo_scale):
        cfg = ex.base_config(models=(ModelSpec(arch=ex.MODEL, seq_len=256, n_blocks=5,
                                               slo_scale=slo_scale),),
                             admission=AdmissionPolicy(high_watermark=6, low_watermark=2))
        session = Session.from_config(cfg)
        plan = session.plan()
        session.deploy(mode="sim")
        slo = session.store.profiles[ex.MODEL].slo_s
        source = PoissonSource(plan.throughput * 4.0, slo_s=slo, model_name=ex.MODEL, seed=7)
        tel = session.serve(source, horizon_s=2.0).telemetry
        return plan, tel

    plan, tel = act2(20.0)
    assert [len(p.stages) for p in plan.pipelines] == [2]
    assert tel.backpressure_events == [] and tel.snapshot()["drops"]["scheduler"] > 0
    plan, tel = act2(ex.BACKPRESSURE_SLO_SCALE)
    assert all(len(p.stages) == 1 for p in plan.pipelines)
    assert tel.backpressure_events and tel.snapshot()["drops"]["scheduler"] == 0


class _SlowBatchOne:
    """A stage executor that takes 20 ms longer at batch 1, as timing noise
    can make a launch-bound stage look in calibration."""

    def __init__(self, ex):
        self.ex = ex
        self.device = ex.device

    def transfer(self, x):
        return self.ex.transfer(x)

    def __call__(self, x):
        if x.shape[0] == 1:
            time.sleep(0.02)
        return self.ex(x)


@pytest.mark.parametrize("slow_batch_one, first_wall",
                         [(True, 1.0), (False, 3.0), (True, 3.0)])
def test_act3_serves_a_last_moment_batch_of_one(slow_batch_one, first_wall, monkeypatch,
                                                one_thread):
    """Act 3's session (pinned 2-stage plan, measured feedback) serves two
    full batches and then one request, which waits until its planned
    finish at the full batch's latency meets its deadline.  It must be
    served then: batch 1 may not be priced above the full batch although
    calibration timed it 20 ms slower (`slow_batch_one`), and the expiry
    prune's best-case bound must follow the feedback's scales after a
    first observation `first_wall` times slower than planned scales every
    stage down.  Each stage reports its planned duration as its wall (the
    first `first_wall` times it), so the schedule does not depend on this
    host's load."""
    from repro_torch.api import Session
    from repro_torch.core.types import Request
    from repro_torch.dataplane import dispatcher, plane
    from repro_torch.examples import serve_pipeline as ex

    calibrate = plane.calibrate_runtime

    def calibrate_slow(runtime, executors, *args, **kw):
        if slow_batch_one:
            executors = {pid: [_SlowBatchOne(e) for e in execs]
                         for pid, execs in executors.items()}
        return calibrate(runtime, executors, *args, **kw)

    observe, seen = dispatcher.FeedbackController.observe, set()

    def planned_walls(self, pipeline_id, stage_idx, planned_s, wall_s):
        wall_s = planned_s
        if (pipeline_id, stage_idx) not in seen:
            seen.add((pipeline_id, stage_idx))
            wall_s *= first_wall
        return observe(self, pipeline_id, stage_idx, planned_s, wall_s)

    monkeypatch.setattr(plane, "calibrate_runtime", calibrate_slow)
    monkeypatch.setattr(dispatcher.FeedbackController, "observe", planned_walls)
    with Session.from_config(ex.base_config(feedback="measured", slo_scale=8.0),
                             device="cpu") as session:
        session.profile()
        session.use_plan(ex.staged_plan(session))
        session.deploy(mode="real")
        stages = session.runtime.pipelines[0].stages
        for s in stages:
            table = [s.latency_by_batch[b] for b in sorted(s.latency_by_batch)]
            assert table == sorted(table)
        full = sum(s.latency(4) for s in stages)
        slo = 6 * sum(s.latency(1) for s in stages)
        arrivals = [i * 1e-6 for i in range(4)] + [3 * full + i * 1e-6 for i in range(4)]
        arrivals.append(6 * full)
        trace = [Request(arrival_s=t, req_id=i, model_name="stablelm-3b", deadline_s=t + slo)
                 for i, t in enumerate(arrivals)]
        with contextlib.redirect_stdout(io.StringIO()):
            stats = ex.serve_workload(session, "act 3", trace)
        scales = [s.lat_scale for s in stages]
    assert stats["served"] == stats["n"] == len(trace)
    assert all(x < 1.0 for x in scales) if first_wall > 1.0 else scales == [1.0, 1.0]


class _Raising:
    """A stage executor that fails every call, as a kernel that refused its
    shape would."""

    def __init__(self, ex):
        self.ex = ex

    def transfer(self, x):
        return self.ex.transfer(x)

    def __call__(self, x):
        raise RuntimeError("planted executor failure")


def test_serve_workload_raises_on_a_failed_executor(one_thread):
    from repro_torch.api import Session
    from repro_torch.data.requests import poisson_trace
    from repro_torch.examples import serve_pipeline as ex

    with Session.from_config(ex.base_config(), device="cpu") as session:
        plan = session.plan()
        session.deploy(mode="real")
        prof = session.store.profiles["stablelm-3b"]
        execs = session.dataplane.dispatcher.executors
        for pid in execs:
            execs[pid][-1] = _Raising(execs[pid][-1])
        rate = plan.throughput * 0.6
        trace = poisson_trace(rate, 8 / rate, prof.slo_s, "stablelm-3b", seed=7)
        with pytest.raises(RuntimeError, match=r"served 0/\d+; executor failures [1-9]"):
            ex.serve_workload(session, "planted", trace)
