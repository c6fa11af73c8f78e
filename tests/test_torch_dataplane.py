"""The port's control-plane inputs and data plane, held against the
reference package: layer costs and profiles equal field for field, the
virtual serve path gives identical outcomes, and a real serve on the CPU
resolves every request through `PoolDispatcher` and `DataPlane`."""

import dataclasses

import numpy as np
import pytest
import torch

import repro.configs as ref_configs
import repro.core.blocks as ref_blocks
import repro.core.costmodel as ref_cm
import repro.core.plan as ref_plan
import repro.core.runtime as ref_runtime
import repro.core.types as ref_types
import repro.data.requests as ref_requests
import repro.dataplane.plane as ref_plane
import repro.dataplane.queues as ref_queues
import repro.models.model_zoo as ref_zoo
import repro_torch.configs as configs
import repro_torch.core.blocks as blocks
import repro_torch.core.costmodel as cm
import repro_torch.core.plan as plan_mod
import repro_torch.core.runtime as runtime_mod
import repro_torch.core.types as types
import repro_torch.data.requests as requests
import repro_torch.dataplane.plane as plane
import repro_torch.dataplane.queues as queues
import repro_torch.models.model_zoo as zoo
from repro_torch.dataplane import DataPlane, PoolDispatcher, build_executors, calibrate_runtime
from repro_torch.kernels.boundary_quant import ops as bq
from repro_torch.serving.engine import (
    StageExecutor,
    build_engine,
    layer_block_map_from_profile,
)

REF = dict(configs=ref_configs, blocks=ref_blocks, cm=ref_cm, plan=ref_plan,
           runtime=ref_runtime, types=ref_types, requests=ref_requests,
           plane=ref_plane, queues=ref_queues, zoo=ref_zoo)
PORT = dict(configs=configs, blocks=blocks, cm=cm, plan=plan_mod,
            runtime=runtime_mod, types=types, requests=requests,
            plane=plane, queues=queues, zoo=zoo)

REDUCED = dict(n_layers=4, d_model=128, d_ff=256, n_heads=4, kv_heads=4, vocab=512)


def _as_dicts(items):
    return [dataclasses.asdict(x) for x in items]


def _pinned(m, arch="stablelm-3b", seq=16, n_blocks=4, bs=4, counts=None):
    """The hand-pinned 2-stage pooled plan of tests/test_dataplane.py's
    `real_pipeline` fixture, built from one package's modules `m`."""
    cfg = m["configs"].get_config(arch).reduced(**REDUCED)
    costs = m["zoo"].layer_costs(cfg, seq)
    cluster = m["types"].ClusterSpec(counts=counts or {"tpu-hi": 1, "tpu-lo": 2})
    prof0 = m["blocks"].build_profile(cfg.name, costs, slo_s=1.0, n_blocks=n_blocks,
                                      accel=cluster.accel("tpu-hi"))
    base = sum(m["cm"].block_latency(b, cluster.accel("tpu-hi"), 1, 1)
               for b in prof0.blocks)
    prof = m["types"].replace(prof0, slo_s=base * 6.0)
    tbl = m["cm"].build_latency_table(prof, cluster)
    P = m["plan"]
    cut, n = prof.n_blocks // 2, prof.n_blocks
    plan = P.ClusterPlan(cluster=cluster, pipelines=[P.PipelinePlan(
        model_name=cfg.name, batch_size=bs,
        stages=(
            P.StagePlan(0, cut, "tpu-lo", 1, counts["tpu-lo"] if counts else 2,
                        tbl.partition(0, cut, "tpu-lo", 1, bs)),
            P.StagePlan(cut, n, "tpu-hi", 1, 1, tbl.partition(cut, n, "tpu-hi", 1, bs)),
        ),
        xfer_latency_s=(m["cm"].transfer_latency(prof, cluster, "tpu-lo", "tpu-hi", cut, bs),),
    )])
    return cfg, prof, plan


# --------------------------------------------- (d) costs and profiles


@pytest.mark.parametrize("arch", ["stablelm-3b", "qwen3-14b"])
@pytest.mark.parametrize("reduced", [False, True])
def test_layer_costs_and_profile_equal_reference(arch, reduced):
    seq = 128
    rcfg = ref_configs.get_config(arch)
    cfg = configs.get_config(arch)
    if reduced:
        rcfg, cfg = rcfg.reduced(**REDUCED), cfg.reduced(**REDUCED)
    ref_costs, costs = ref_zoo.layer_costs(rcfg, seq), zoo.layer_costs(cfg, seq)
    assert _as_dicts(costs) == _as_dicts(ref_costs)
    for n_blocks in (4, 6):
        ref_prof = ref_blocks.build_profile(rcfg.name, ref_costs, 1.0, n_blocks=n_blocks)
        prof = blocks.build_profile(cfg.name, costs, 1.0, n_blocks=n_blocks)
        assert dataclasses.asdict(prof) == dataclasses.asdict(ref_prof)


def test_pinned_plans_equal_reference():
    _, ref_prof, ref_p = _pinned(REF, counts={"tpu-hi": 1, "tpu-lo": 8})
    _, prof, p = _pinned(PORT, counts={"tpu-hi": 1, "tpu-lo": 8})
    assert dataclasses.asdict(prof) == dataclasses.asdict(ref_prof)
    assert [dataclasses.asdict(pp) for pp in p.pipelines] == \
        [dataclasses.asdict(pp) for pp in ref_p.pipelines]
    assert p.throughput == ref_p.throughput


# ----------------------------------------- (e) the virtual serve path


@pytest.mark.parametrize("gen", ["poisson_trace", "bursty_trace"])
@pytest.mark.parametrize("load", [0.5, 4.0])
def test_virtual_serve_outcomes_identical_to_reference(gen, load):
    """Planned feedback, no dispatcher: admission, Algorithm 1 and the event
    loop decide exactly as the reference does — same drops, same
    completion times, same utilization, to the bit."""
    results = []
    for m in (REF, PORT):
        cfg, prof, plan_ = _pinned(m)
        rt = m["runtime"].build_runtime(plan_, {cfg.name: prof})
        rate = plan_.throughput * load
        trace = getattr(m["requests"], gen)(rate, 60 / rate, prof.slo_s, cfg.name, seed=4)
        tel = m["plane"].serve_trace(rt, trace)
        results.append((trace, tel))
    (rtrace, rtel), (trace, tel) = results
    assert [(r.req_id, r.arrival_s, r.deadline_s) for r in trace] == \
        [(r.req_id, r.arrival_s, r.deadline_s) for r in rtrace]
    assert _as_dicts(tel.outcomes) == _as_dicts(rtel.outcomes)
    assert _as_dicts(tel.dispatches) == _as_dicts(rtel.dispatches)
    assert tel.utilization == rtel.utilization
    assert tel.horizon_s == rtel.horizon_s
    assert tel.scheduler == rtel.scheduler
    assert len(tel.outcomes) == len(trace) and tel.served > 0


def test_virtual_serve_permissive_policy_identical_to_reference():
    outs = []
    for m in (REF, PORT):
        cfg, prof, plan_ = _pinned(m)
        rt = m["runtime"].build_runtime(plan_, {cfg.name: prof})
        rate = plan_.throughput * 0.9
        trace = m["requests"].poisson_trace(rate, 40 / rate, prof.slo_s, cfg.name, seed=8)
        tel = m["plane"].serve_trace(rt, trace, policy=m["queues"].AdmissionPolicy.permissive())
        outs.append(_as_dicts(tel.outcomes))
    assert outs[0] == outs[1]


# ------------------------------------- (f) real serving on the CPU


@pytest.fixture(scope="module")
def cpu_pipeline():
    cfg, prof, plan_ = _pinned(PORT)
    lbm = layer_block_map_from_profile(prof, cfg.n_layers)
    executors = build_executors(cfg, plan_, lbm, torch.Generator(device="cpu").manual_seed(0))
    return cfg, prof, plan_, executors


def test_real_serve_on_cpu_resolves_every_request(cpu_pipeline):
    cfg, prof, plan_, executors = cpu_pipeline
    rt = runtime_mod.build_runtime(plan_, {cfg.name: prof})
    thr = plan_.throughput
    trace = requests.poisson_trace(thr * 0.5, 24 / (thr * 0.5), prof.slo_s, cfg.name, seed=5)
    disp = PoolDispatcher.from_runtime(rt, executors, max_inflight=4)
    tel = DataPlane(rt, dispatcher=disp, feedback="planned", seq_len=16).serve(trace)
    assert len(tel.outcomes) == len(trace)
    assert {o.req_id for o in tel.outcomes} == {r.req_id for r in trace}
    assert tel.served > 0
    # both stages of the pipeline ran for real and were measured
    assert (0, 0, 0) in tel.stage_wall_s and (0, 0, 1) in tel.stage_wall_s
    n_batches = len(tel.stage_wall_s[(0, 0, 0)])
    assert n_batches == len(tel.dispatches) == disp.submitted


def test_real_measured_feedback_on_cpu(cpu_pipeline):
    cfg, prof, plan_, executors = cpu_pipeline
    rt = runtime_mod.build_runtime(plan_, {cfg.name: prof})
    measured = calibrate_runtime(rt, executors, seq_len=16)
    p0 = rt.pipelines[0]
    assert set(measured) == {(0, si, b) for si in range(2) for b in (1, 2, 4)}
    assert all(s.lat_scale == 1.0 for s in p0.stages)
    e2e = sum(s.latency(1) for s in p0.stages)
    thr = min(len(s.vdevs) * p0.unified_batch / s.latency(p0.unified_batch)
              for s in p0.stages)
    trace = requests.bursty_trace(thr * 0.4, 16 / (thr * 0.4), e2e * 8, cfg.name, seed=6)
    disp = PoolDispatcher.from_runtime(rt, executors, max_inflight=4)
    dp = DataPlane(rt, dispatcher=disp, feedback="measured", seq_len=16)
    tel = dp.serve(trace)
    assert len(tel.outcomes) == len(trace)
    assert dp.fb.observations > 0  # the feedback loop closed
    assert 0.0 <= tel.attainment <= 1.0


def test_dispatcher_measures_every_stage(cpu_pipeline):
    cfg, prof, plan_, executors = cpu_pipeline
    disp = PoolDispatcher(executors, max_inflight=2)
    tokens = torch.ones((4, 16), dtype=torch.int64)
    ids = [disp.submit_chain(0, tokens) for _ in range(3)]
    assert disp.inflight <= 2  # the window retired the oldest batch
    assert disp.poll_stage(ids[2], 0) >= 0.0
    done = disp.drain_all()
    assert sorted(c.job_id for c in done) == ids
    for c in done:
        assert len(c.stage_wall_s) == 2 and c.total_wall_s > 0
        assert c.done_wall >= c.submit_wall


def test_executor_output_matches_full_forward(cpu_pipeline):
    cfg, prof, plan_, executors = cpu_pipeline
    s0, s1 = executors[0]
    tokens = torch.from_numpy(np.random.default_rng(3).integers(0, cfg.vocab, (2, 16)))
    out = s1(s1.transfer(s0(tokens)))
    full = zoo.build_model(cfg).forward(s0.params, {"tokens": tokens})
    assert out.shape == (2, 16, cfg.padded_vocab)
    assert torch.equal(out, full)


# ------------------------------------------ (g) the transfer() cases


def test_transfer_same_device_is_identity(cpu_pipeline):
    ex = cpu_pipeline[3][0][1]
    h = torch.randn(2, 16, 128, generator=torch.Generator().manual_seed(1)).bfloat16()
    assert ex.transfer(h) is h


def test_transfer_integer_carry_moves_unquantized(cpu_pipeline):
    """An integer carry takes `.to(device)`, never the quantizer.  (`cpu:0`
    is a device object distinct from `cpu`, so the hop path runs here.)"""
    params = cpu_pipeline[3][0][1].params
    ex = StageExecutor(stage_fn=lambda p, x: x, params=params, device="cpu:0")
    tokens = torch.arange(8).reshape(2, 4)
    before = bq.quantize.launches
    out = ex.transfer(tokens)
    assert torch.equal(out, tokens) and out.dtype == tokens.dtype
    assert bq.quantize.launches == before


def test_transfer_across_devices_quantizes(cpu_pipeline):
    params = cpu_pipeline[3][0][1].params
    hop = StageExecutor(stage_fn=lambda p, x: x, params=params, device="cpu:0")
    plain = StageExecutor(stage_fn=lambda p, x: x, params=params, device="cpu:0",
                          quantize_boundary=False)
    h = (torch.randn(2, 16, 128, generator=torch.Generator().manual_seed(2)) * 5).bfloat16()
    q, s = bq.quantize_plain(h)
    want = bq.dequantize_plain(q, s, h.dtype)
    got = hop.transfer(h)
    assert got.dtype == h.dtype and torch.equal(got, want)
    assert not torch.equal(got, h)  # the int8 round trip really ran
    assert (got.float() - h.float()).abs().max() <= h.float().abs().max() / 127
    assert torch.equal(plain.transfer(h), h)  # quantize_boundary=False: moved as is


def test_serving_engine_infers_and_serves(cpu_pipeline):
    """`build_engine` shares one executor across a pool's members; `infer`
    runs a batch through the pipeline and `serve` batches requests through
    the PoolDispatcher."""
    cfg, prof, plan_, _ = cpu_pipeline
    pipeline = plan_.pipelines[0]
    lbm = layer_block_map_from_profile(prof, cfg.n_layers)
    engine = build_engine(cfg, pipeline, lbm, torch.Generator().manual_seed(1))
    assert [len(pool) for pool in engine.executors] == [s.n_vdev for s in pipeline.stages]
    assert engine.executors[0][0] is engine.executors[0][1]
    out = engine.infer(torch.ones((2, 16), dtype=torch.int64))
    assert out.shape == (2, 16, cfg.padded_vocab) and torch.isfinite(out.float()).all()
    trace = requests.poisson_trace(100.0, 0.1, 1.0, cfg.name, seed=2)
    stats = engine.serve(trace, batch_size=4, seq_len=16)
    assert stats["served"] == len(trace)
    assert stats["batches"] == -(-len(trace) // 4)
