"""The dry run on the meta device (`repro_torch.launch.dryrun`,
`launch/hlo_analysis.py`, the registry's shapes), on the CPU.

Against the reference: the shapes and cells equal `repro.configs`', the
analytic FLOPs and bytes equal `repro.launch.hlo_analysis`'s at every cell,
and `active_params` equals `repro.launch.dryrun`'s (read in a subprocess:
importing that module sets the 512-device XLA_FLAGS, which this process
must not see).  The meta route: every kernel entry's outputs have the plain
version's shapes and dtypes, no plain version runs and no library loads,
each call counts its entry's work, and any other device still raises.  The
tracker: the exact peak of a scripted run.  A tiny model of each family
dry-runs to `ok` with its parameters, moments and (dense prefill) FLOPs as
reckoned; the CLI writes `skip` and `ok` records."""

import contextlib
import json
import math
import os
import subprocess
import sys
import types
from pathlib import Path

import pytest
import torch

import repro.configs as ref_configs
import repro.launch.hlo_analysis as ref_hlo
from repro_torch.configs import (ARCH_IDS, SHAPES, SUBQUADRATIC, ShapeSpec, all_cells, get_config,
                                 shape_applicable)
from repro_torch.kernels import _lib, work_counts
from repro_torch.kernels.boundary_quant import ops as bq
from repro_torch.kernels.decode_attention import ops as da
from repro_torch.kernels.flash_attention import ops as fa
from repro_torch.kernels.rmsnorm import ops as rn
from repro_torch.kernels.ssd_scan import ops as ssd
from repro_torch.launch import dryrun, hlo_analysis
from repro_torch.models.common import count_params
from repro_torch.models.model_zoo import build_model

ROOT = Path(__file__).resolve().parents[1]
bf16 = torch.bfloat16

# --------------------------------------------------------- the reference's


def test_shapes_and_cells_equal_reference():
    assert {k: (s.name, s.seq_len, s.global_batch, s.kind) for k, s in SHAPES.items()} == {
        k: (s.name, s.seq_len, s.global_batch, s.kind) for k, s in ref_configs.SHAPES.items()}
    assert list(SHAPES) == list(ref_configs.SHAPES)
    assert SUBQUADRATIC == ref_configs.registry.SUBQUADRATIC
    assert all_cells() == ref_configs.registry.all_cells()
    for arch, shape in all_cells():
        assert shape_applicable(arch, shape) == ref_configs.shape_applicable(arch, shape)


@pytest.mark.parametrize("n_devices", [1, 256])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_analytic_terms_equal_reference(arch, n_devices):
    cfg, ref_cfg = get_config(arch), ref_configs.get_config(arch)
    for name, shape in SHAPES.items():
        ref_shape = ref_configs.SHAPES[name]
        assert hlo_analysis.analytic_hbm_bytes(cfg, shape, n_devices) == \
            ref_hlo.analytic_hbm_bytes(ref_cfg, ref_shape, n_devices)
        tokens = shape.global_batch * shape.seq_len
        assert hlo_analysis.model_flops(1.5e9, tokens, shape.kind == "train") == \
            ref_hlo.model_flops(1.5e9, tokens, shape.kind == "train")


def test_active_params_equal_reference():
    code = ("import json; from repro.launch import dryrun as d; "
            "from repro.configs import ARCH_IDS, get_config; "
            "from repro.models.common import count_params; "
            "from repro.models.model_zoo import build_model; "
            "print(json.dumps({a: d.active_params(get_config(a), "
            "count_params(build_model(get_config(a)).defs)) for a in ARCH_IDS}))")
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env.update(PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env,
                         timeout=300, check=True).stdout
    ref = json.loads(out.strip().splitlines()[-1])
    for arch in ARCH_IDS:
        cfg = get_config(arch)
        n = count_params(build_model(cfg).defs)
        assert dryrun.active_params(cfg, n) == ref[arch]


# --------------------------------------------------------- the meta route


@contextlib.contextmanager
def refused():
    """Every plain version and every library load raises: a meta call must
    reach neither."""
    def refuse(*a, **k):
        raise AssertionError("a meta call reached a plain version or a library")

    with pytest.MonkeyPatch.context() as mp:
        for mod in (rn, fa, da, ssd, bq):
            for name in dir(mod):
                if name.endswith("_plain"):
                    mp.setattr(mod, name, refuse)
        mp.setattr(_lib, "load", refuse)
        mp.setattr(_lib, "build_all", refuse)
        yield


def _meta(*shape, dtype=bf16):
    return torch.empty(shape, dtype=dtype, device="meta")


def _cpu(*shape, dtype=bf16, g=None):
    return torch.randn(shape, generator=g).to(dtype)


def _same(meta, cpu):
    meta = meta if isinstance(meta, (tuple, list)) else (meta,)
    cpu = cpu if isinstance(cpu, (tuple, list)) else (cpu,)
    assert len(meta) == len(cpu)
    for m, c in zip(meta, cpu):
        if c is None:
            assert m is None
            continue
        assert m.device.type == "meta"
        assert (tuple(m.shape), m.dtype) == (tuple(c.shape), c.dtype)


def _delta(before: dict, name: str) -> dict:
    """What `name`'s counters gained since `before`.  A precision class
    absent from `ops` gained 0: a class that an earlier call in this process
    counted but this one did not is left out, as the work's own `ops`
    leave it out."""
    now = work_counts()[name]
    ops = {c: n - before[name]["ops"].get(c, 0.0) for c, n in now["ops"].items()}
    return {"launches": now["launches"] - before[name]["launches"],
            "nbytes": now["nbytes"] - before[name]["nbytes"],
            "ops": {c: n for c, n in ops.items() if n}}


def _ops(work) -> dict:
    """`work`'s operations by precision class, as `_delta` gives them."""
    return {c: n for c, n in work.ops if n}


def _counted(name: str, call, work):
    """`call()`, which reaches no plain version and no library, adds one
    launch of `name` doing `work`."""
    before = work_counts()
    with refused():
        out = call()
    got = _delta(before, name)
    assert got["launches"] == 1
    assert got["nbytes"] == pytest.approx(work.nbytes)
    assert got["ops"] == pytest.approx(_ops(work))
    return out


def test_rmsnorm_meta():
    g = torch.Generator().manual_seed(0)
    x, w, dy = _cpu(6, 64, g=g), _cpu(64, g=g), _cpu(6, 64, g=g)
    want, want_b = rn.rmsnorm_plain(x, w), rn.rmsnorm_backward_plain(x, w, dy)
    xm, wm = _meta(6, 64), _meta(64)
    _same(_counted("rmsnorm", lambda: rn.rmsnorm(xm, wm), rn.rmsnorm_work(6, 64, 2)), want)
    _same(_counted("rmsnorm_backward", lambda: rn.rmsnorm_backward(xm, wm, _meta(6, 64)),
                   rn.rmsnorm_backward_work(6, 64, 2)), want_b)


def test_rmsnorm_meta_under_grad():
    """Under grad the meta call takes `_RMSNormFn`, whose backward counts one
    `rmsnorm_backward`."""
    xm, wm = _meta(6, 64).requires_grad_(), _meta(64).requires_grad_()
    before = work_counts()
    with refused():
        dx, dw = torch.autograd.grad(rn.rmsnorm(xm, wm), (xm, wm), _meta(6, 64))
    assert (dx.shape, dw.shape) == (xm.shape, wm.shape)
    assert _delta(before, "rmsnorm")["launches"] == 1
    assert _delta(before, "rmsnorm_backward")["launches"] == 1


def _plain_flash(name):
    """The CPU route's output, gradients (of the output's sum) and lse."""
    g = torch.Generator().manual_seed(1)
    B, Sq, Sk, H, KH, D, Dv, causal = FLASH_SHAPES[name]
    q, k, v = _cpu(B, Sq, H, D, g=g), _cpu(B, Sk, KH, D, g=g), _cpu(B, Sk, KH, Dv, g=g)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    o = fa.attention_bthd(*leaves, causal=causal)
    grads = torch.autograd.grad(o, leaves, torch.ones_like(o))
    lse = fa.flash_attention_lse_plain(q.transpose(1, 2), k.transpose(1, 2), causal=causal)
    return o.detach(), grads, lse


# (B, Sq, Sk, H, KH, D, Dv, causal)
FLASH_SHAPES = {"Sq != Sk, causal": (2, 24, 40, 4, 2, 32, 32, True),
                "Sq != Sk, non-causal": (2, 40, 24, 4, 2, 32, 32, False),
                "MLA 192 / 128": (1, 16, 16, 2, 2, 192, 128, True)}


@pytest.mark.parametrize("name", sorted(FLASH_SHAPES))
def test_flash_attention_meta(name):
    B, Sq, Sk, H, KH, D, Dv, causal = FLASH_SHAPES[name]
    want, want_grads, want_lse = _plain_flash(name)
    q, k, v = _meta(B, Sq, H, D), _meta(B, Sk, KH, D), _meta(B, Sk, KH, Dv)
    # the bf16 forward is handed v padded to D; the backward takes MLA's
    # (192, 128) as it is
    _same(_counted("flash_attention", lambda: fa.attention_bthd(q, k, v, causal=causal),
                   fa.flash_work(B, H, KH, Sq, Sk, D, D, causal, 2)), want)
    # the training forward, then its backward, through `_FlashFn`
    leaves = [t.requires_grad_() for t in (q, k, v)]
    before = work_counts()
    with refused():
        o = fa.attention_bthd(*leaves, causal=causal)
        grads = torch.autograd.grad(o, leaves, torch.ones_like(o))
    _same(o, want)
    lse_work = fa.forward_lse_work(B, H, KH, Sq, Sk, D, D, causal)
    got = _delta(before, "flash_attention_forward_lse")
    assert got["launches"] == 1 and got["nbytes"] == pytest.approx(lse_work.nbytes)
    _same(grads, want_grads)
    got = _delta(before, "flash_attention_backward")
    work = fa.backward_work(B, H, KH, Sq, Sk, D, Dv, causal)
    assert got["launches"] == 1 and got["ops"] == pytest.approx(_ops(work))
    # the LSE forward called directly, beside its plain lse
    qh, kh = q.detach().transpose(1, 2), k.detach().transpose(1, 2)
    vh = torch.nn.functional.pad(v.detach(), (0, D - Dv)).transpose(1, 2)
    lse = _counted("flash_attention_forward_lse", lambda: fa.flash_attention_forward_lse(
        qh, kh, vh, torch.empty_like(qh), D ** -0.5, causal), fa.forward_lse_work(
        B, H, KH, Sq, Sk, D, D, causal))
    _same(lse, want_lse)


@pytest.mark.parametrize("split", [False, True])
def test_decode_attention_meta(split):
    """Not split: more (batch, KV head) pairs than half the H100's SMs; split:
    few pairs over a long cache (`split_plan` at 132 SMs)."""
    B, H, KH, S, D = (16, 32, 8, 64, 64) if not split else (1, 8, 2, 1024, 64)
    assert (da.split_plan(B, KH, S, _lib.H100_SMS)[0] > 1) == split
    g = torch.Generator().manual_seed(2)
    want = da.decode_attention_bthd(_cpu(B, 1, H, D, g=g), _cpu(B, S, KH, D, g=g),
                                    _cpu(B, S, KH, D, g=g), S - 3)
    q, kc = _meta(B, 1, H, D), _meta(B, S, KH, D)
    _same(_counted("decode_attention", lambda: da.decode_attention_bthd(q, kc, kc, S - 3),
                   da.decode_work(B, H, KH, S - 3, D, 2)), want)
    # a device-side kv_len counts the cache's capacity
    lens = torch.empty((), dtype=torch.int32, device="meta")
    _counted("decode_attention", lambda: da.decode_attention_bthd(q, kc, kc, lens),
             da.decode_work(B, H, KH, S, D, 2))


# (B, T, NH, DK, DV, chunk, q/k one head, log_i): the narrow path (and the
# backward's heads route), the wide path (and the pairs route)
SCAN_SHAPES = {"narrow": (2, 40, 3, 16, 16, 16, True, False),
               "wide": (1, 40, 2, 72, 70, 16, False, True)}


@pytest.mark.parametrize("name", sorted(SCAN_SHAPES))
def test_ssd_scan_meta(name):
    B, T, NH, DK, DV, chunk, one, with_i = SCAN_SHAPES[name]
    g = torch.Generator().manual_seed(3)
    heads = 1 if one else NH
    cpu = [_cpu(B, T, heads, DK, g=g), _cpu(B, T, heads, DK, g=g), _cpu(B, T, NH, DV, g=g),
           -torch.rand(B, T, NH, generator=g), -torch.rand(B, T, NH, generator=g) if with_i
           else None]
    dy = _cpu(B, T, NH, DV, g=g)
    want = ssd.ssd_scan_bthd(*cpu, chunk=chunk)
    want_b = ssd.ssd_scan_backward(*cpu, dy, None, chunk=chunk)
    route = ssd.backward_plan(B, T, NH, heads, DK, DV, chunk)[0]
    assert route == ("heads" if name == "narrow" else "pairs")
    meta = [None if t is None else torch.empty_like(t, device="meta") for t in cpu]
    _same(_counted("ssd_scan", lambda: ssd.ssd_scan_bthd(*meta, chunk=chunk),
                   ssd.scan_work(B, T, NH, DK, DV, chunk, 2, one, with_i)), want)
    work = ssd.scan_backward_work(B, T, NH, DK, DV, chunk, one, with_i, False)
    before = work_counts()
    with refused():
        got = ssd.ssd_scan_backward(*meta, torch.empty_like(dy, device="meta"), None,
                                    chunk=chunk)
    _same(got, want_b)
    b = _delta(before, "ssd_scan_backward")
    assert b["launches"] == 1 and b["ops"] == pytest.approx(_ops(work))
    # either route without the forward's scratch runs the forward first ...
    assert _delta(before, "ssd_scan")["launches"] == 1
    # ... and with it (`SAVED`, as `_ScanFn` keeps it) launches no forward
    meta_dy = torch.empty_like(dy, device="meta")
    saved = ssd.forward_saved(*meta, chunk=chunk)
    assert tuple(saved) == ssd.SAVED
    before = work_counts()
    with refused():
        got = ssd.ssd_scan_backward(*meta, meta_dy, None, chunk=chunk, saved=saved)
    _same(got, want_b)
    assert _delta(before, "ssd_scan_backward")["launches"] == 1
    assert _delta(before, "ssd_scan")["launches"] == 0


def test_boundary_quant_meta():
    xm = _meta(6, 40)
    q, s = _counted("quantize", lambda: bq.quantize(xm), bq.quantize_work(6, 40, 2))
    assert (q.dtype, tuple(q.shape), s.dtype, tuple(s.shape)) == (torch.int8, (6, 40),
                                                                  torch.float32, (6, 1))
    out = _counted("dequantize", lambda: bq.dequantize(q, s), bq.dequantize_work(6, 40, 2))
    assert (out.dtype, tuple(out.shape)) == (bf16, (6, 40))


def test_meta_loads_no_library():
    """After meta calls of every entry, no library was built or loaded."""
    assert not _lib._libs
    assert _lib.route(_meta(2)) is True
    assert _lib.sm_count(torch.device("meta")) == _lib.H100_SMS == 132
    assert _lib.stream_handle(_meta(2)) == 0


def test_unknown_device_still_raises():
    """A device other than CPU, CUDA or meta: no kernel and no plain version
    (a stand-in with a `device`, as the CPU build makes no such tensor)."""
    with pytest.raises(RuntimeError, match="no kernel and no plain version"):
        _lib.route(types.SimpleNamespace(device=torch.device("xpu")))
    with pytest.raises(ValueError, match="different devices"):
        _lib.route(_meta(2), torch.zeros(2))


def test_occupancy_table_misses_raise():
    from repro_torch.kernels import occupancy

    with pytest.raises(ValueError, match="no H100 reading"):
        occupancy.rmsnorm_blocks_per_sm(100, 1, True)
    with pytest.raises(ValueError, match="no H100 reading"):
        occupancy.flash_clusters(9, 128, 128)


# --------------------------------------------------------------- the tracker


def test_tracker_exact_peak():
    """Allocations, views and frees on meta: each storage rounded up to 512
    bytes, a view adds nothing, a storage leaves when its last view goes."""
    t = hlo_analysis.MemoryTracker("meta")
    arg = torch.empty(100, device="meta")  # 400 bytes -> 512
    t.hold(arg)
    with t:
        a = torch.empty(1000, device="meta")  # 4000 -> 4096
        b = torch.empty(10, device="meta")  # 40 -> 512
        view = a[10:]
        del a  # the view keeps its storage
        assert t.live == 512 + 4096 + 512
        c = torch.empty(300, device="meta")  # 1200 -> 1536
        assert (t.live, t.peak) == (6656, 6656)
        del view
        assert t.live == 6656 - 4096
        d = b + 1  # 512, through an op
        e = d.view(2, 5)
        del b, c
        assert (t.live, t.peak) == (1024, 6656)
        f = torch.empty(5000, device="meta")  # 20000 -> 20480
        assert t.peak == 1024 + 20480
        del d, e, f
    assert t.live == 512


def test_analyze_traced_fields():
    """argument, output, alias and temp sizes of a scripted step: x updated
    in place (aliased), a temporary freed inside, then a new output; temp
    is the peak less the arguments and the new outputs, so the reference's
    sum (argument + output + temp - alias) is the peak."""
    x, y = torch.empty(1000, device="meta"), torch.empty(10, device="meta")

    def step(x, y):
        tmp = torch.empty(3000, device="meta")  # 12000 -> 12288
        x.add_(1.0)
        del tmp
        return x, y * 2  # 512

    terms, extra = hlo_analysis.analyze_traced(step, x, y)
    ma = extra["memory_analysis"]
    assert extra["peak_size"] == 4096 + 512 + 12288
    assert ma == {"argument_size": 4096 + 512, "output_size": 4096 + 512, "alias_size": 4096,
                  "temp_size": 12288 - 512}
    assert (ma["argument_size"] + ma["output_size"] + ma["temp_size"] - ma["alias_size"]
            == extra["peak_size"])


def test_tracker_counts_matmul_flops():
    a, b = torch.empty(3, 5, 7, device="meta"), torch.empty(7, 11, device="meta")
    terms, extra = hlo_analysis.analyze_traced(lambda a, b: (a @ b, torch.einsum(
        "bij,bjk->bik", a, torch.empty(3, 7, 2, device="meta"))), a, b)
    assert terms.flops_per_device == 2 * 15 * 7 * 11 + 2 * 3 * 5 * 7 * 2


# ------------------------------------------------------- tiny models, each family

FAMILIES = {"dense": "qwen2-1.5b", "hybrid": "zamba2-2.7b", "xlstm": "xlstm-1.3b",
            "vlm": "llava-next-34b", "encdec": "seamless-m4t-large-v2",
            "moe": "llama4-maverick-400b-a17b", "mla": "deepseek-v3-671b"}
TINY = {"tiny_train": ShapeSpec("tiny_train", 48, 4, "train"),
        "tiny_prefill": ShapeSpec("tiny_prefill", 48, 2, "prefill"),
        "tiny_decode": ShapeSpec("tiny_decode", 48, 2, "decode")}


@pytest.fixture
def tiny(monkeypatch):
    monkeypatch.setattr(dryrun, "get_config", lambda arch: get_config(arch).reduced())
    monkeypatch.setattr(dryrun, "SHAPES", TINY)
    monkeypatch.setattr(dryrun, "shape_applicable", lambda arch, shape: (True, ""))


def _leaves(defs) -> list:
    if hasattr(defs, "shape"):
        return [defs]
    return [d for x in (defs if isinstance(defs, list) else defs.values()) for d in _leaves(x)]


def _param_bytes(defs) -> int:
    return sum(math.prod(d.shape) * d.dtype.itemsize for d in _leaves(defs))


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_tiny_family_dry_runs(family, kind, tiny, capsys):
    arch = FAMILIES[family]
    rec = dryrun.run_cell(arch, f"tiny_{kind}")
    assert rec["status"] == "ok", rec.get("traceback")
    cfg = get_config(arch).reduced()
    defs = build_model(cfg).defs
    n = count_params(defs)
    assert rec["n_params"] == n
    state = rec["argument_bytes"]
    assert state["params"] == _param_bytes(defs)
    if all(d.dtype == bf16 for d in _leaves(defs)):
        assert state["params"] == 2 * n
    if kind == "train":
        assert state["opt_state"] == 2 * 4 * n + 4  # two f32 moments and the int32 step
        assert rec["accum"] == 2
        assert rec["kernels"]["rmsnorm_backward"]["launches"] > 0
    ma = rec["memory_analysis"]
    assert ma["argument_size"] + ma["temp_size"] + ma["output_size"] - ma["alias_size"] \
        == rec["peak_size"]
    assert rec["hbm_per_device_gb"] == round(rec["peak_size"] / 1e9, 3)
    assert rec["fits_one_card"] and rec["roofline"]["flops_per_device"] > 0
    assert 0 < rec["useful_flops_ratio"]
    if kind == "decode":
        assert ma["alias_size"] > 0  # the cache, written in place


def test_dense_prefill_flops_are_its_matrices_and_kernels(tiny):
    """A tiny dense prefill: 2 x tokens x each layer's projection and MLP
    matrices, 2 x batch x the head (the last position's logits; the
    embedding is a lookup), plus the kernels' own operations."""
    cfg = get_config("qwen2-1.5b").reduced()
    defs = build_model(cfg).defs
    B, S = TINY["tiny_prefill"].global_batch, TINY["tiny_prefill"].seq_len
    layer = sum(math.prod(d.shape) for d in _leaves(defs["layers"]) if len(d.shape) == 2)
    head = math.prod(defs["head"].shape) if "head" in defs else math.prod(defs["embed"].shape)
    kernels = sum(n * sum(c for _, c in w.ops) for n, w in (
        (cfg.n_layers, fa.flash_work(B, cfg.n_heads, cfg.kv_heads, S, S, cfg.hd, cfg.hd, True, 2)),
        (2 * cfg.n_layers, rn.rmsnorm_work(B * S, cfg.d_model, 2)),
        (1, rn.rmsnorm_work(B, cfg.d_model, 2))))
    rec = dryrun.run_cell("qwen2-1.5b", "tiny_prefill")
    assert rec["kernels"]["flash_attention"]["launches"] == cfg.n_layers
    assert rec["roofline"]["flops_per_device"] == pytest.approx(
        2 * B * S * layer + 2 * B * head + kernels, rel=1e-12)


# ------------------------------------------------------------------- the CLI


def _cli(*args, out):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun", *args, "--out",
                           str(out)], capture_output=True, text=True, env=env, timeout=300)


def test_cli_skip_and_ok_records(tmp_path):
    out = tmp_path / "dry.jsonl"
    r = _cli("--arch", "qwen3-14b", "--shape", "long_500k", out=out)
    assert r.returncode == 0, r.stderr
    r = _cli("--arch", "qwen2-1.5b", "--shape", "decode_32k", "--memory-only", out=out)
    assert r.returncode == 0, r.stderr
    skip, ok = (json.loads(line) for line in out.read_text().splitlines())
    assert skip == {"arch": "qwen3-14b", "shape": "long_500k", "mesh": "1xH100",
                    "variant": "baseline", "status": "skip",
                    "reason": "full-attention arch: 500k-token decode excluded by assignment"}
    assert ok["status"] == "ok" and ok["n_devices"] == 1 and ok["mesh"] == "1xH100"
    assert set(ok["memory_analysis"]) == {"argument_size", "output_size", "alias_size",
                                          "temp_size"}
    assert "roofline" not in ok  # --memory-only
    # the KV cache: 28 layers of (128, 32768, 2, 128) bf16 for K and V
    assert ok["argument_bytes"]["cache"] == 2 * 28 * 128 * 32768 * 2 * 128 * 2
    assert ok["fits_one_card"] is False
