"""The port's compiled train step (`training.train_lib.compile_train_step`,
the counterpart of the reference's `jax.jit(train_step, donate_argnums=(0,
1))`) on the CPU, and the error class that the elastic loop lets through.

On CPU state the compiled step is the eager step itself: its losses,
gradient norms and parameters must equal `make_train_step`'s exactly.
The CUDA graph path (warm-up, capture, replay, a restore into the graph's
buffers) runs only on the card: `tests/test_torch_cuda.py`.  Here the
plain parts of it are held: the copy of foreign state into the static
buffers (`copy_into`, `CompiledTrainStep._adopt`) and the device rule.
"""

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.data.tokens import TokenPipeline
from repro_torch.examples.train_small import small_config
from repro_torch.kernels import _lib
from repro_torch.models.model_zoo import build_model
from repro_torch.serving.engine import GraphStats
from repro_torch.training import AdamWConfig, compile_train_step, init_opt_state, make_train_step
from repro_torch.training import checkpoint as ckpt_lib
from repro_torch.training.elastic import ElasticConfig, FailureInjector, run_elastic
from repro_torch.training.train_lib import CompiledTrainStep, batch_key, copy_into
from repro_torch.training.tree import leaves, paths


def _model(dim: int = 64, layers: int = 2, arch: str = "qwen2-1.5b"):
    """`train_small`'s qwen2-1.5b config at `dim` and `layers`, or another
    arch's config (xlstm-1.3b: one period, 7 mLSTM blocks and an sLSTM
    block), `reduced()` to vocab 256 in f32."""
    base = small_config(dim, layers) if arch == "qwen2-1.5b" else get_config(arch)
    cfg = base.reduced(vocab=256, dtype=torch.float32)
    return cfg, build_model(cfg)


def _state(model, seed: int = 0):
    params = model.init(torch.Generator().manual_seed(seed))
    return params, init_opt_state(params, AdamWConfig(lr=1e-3))


def _batches(cfg, n: int, batch: int = 4, seq: int = 16):
    pipe = TokenPipeline(vocab=cfg.vocab, seq_len=seq, global_batch=batch, seed=3)
    return [{k: torch.from_numpy(v) for k, v in pipe.batch_for(i).items()} for i in range(n)]


def _assert_trees_equal(a, b):
    for x, y in zip(leaves(a), leaves(b), strict=True):
        assert x.dtype == y.dtype and torch.equal(x, y)


@pytest.mark.parametrize("arch,accum", [pytest.param("qwen2-1.5b", 1, id="1"),
                                        pytest.param("qwen2-1.5b", 2, id="2"),
                                        pytest.param("xlstm-1.3b", 2, id="xlstm-1.3b-2")])
def test_compiled_step_on_cpu_is_the_eager_step(arch, accum):
    """Over four steps the compiled step's losses, gradient norms,
    parameters, moments and step counter equal the eager step's exactly,
    and it captures nothing on the CPU."""
    cfg, model = _model(arch=arch)
    step = make_train_step(model, AdamWConfig(lr=1e-3), remat=True, accum_steps=accum)
    compiled = compile_train_step(step)
    assert isinstance(compiled, CompiledTrainStep)
    p, o = _state(model)
    q, r = _state(model)
    for batch in _batches(cfg, 4):
        p, o, m = step(p, o, batch)
        q, r, n = compiled(q, r, batch)
        assert torch.equal(m["loss"], n["loss"]) and torch.equal(m["grad_norm"],
                                                                   n["grad_norm"])
    _assert_trees_equal(p, q)
    _assert_trees_equal(o, r)
    assert int(r["step"]) == 4
    assert not compiled.graphs and not compiled.warmed and compiled.params is None


def test_remat_recompute_equals_the_stored_forward():
    """`remat_call` saves no RNG state (so a CUDA graph can capture it):
    the recomputed forward is exact, so gradients with remat equal those
    without, bit for bit, on the CPU."""
    cfg, model = _model()
    params, _ = _state(model)
    batch = _batches(cfg, 1)[0]
    got = {}
    for remat in (False, True):
        for t in leaves(params):
            t.requires_grad_(True)
        loss = model.loss(params, batch, remat=remat)
        got[remat] = (loss.detach(), torch.autograd.grad(loss, leaves(params)))
        for t in leaves(params):
            t.requires_grad_(False)
    assert torch.equal(got[False][0], got[True][0])
    for a, b in zip(got[False][1], got[True][1], strict=True):
        assert torch.equal(a, b)


def test_copy_into_writes_a_restored_tree_into_the_static_buffers(tmp_path):
    """A checkpoint restored from disk (fresh tensors, as after a restart)
    lands in the static buffers: every leaf and the step counter take the
    restored values, the leaves that are already the static ones are
    skipped, and the static buffers stay the graph's own tensors (the
    restored tree is not aliased: writing it later leaves them alone)."""
    cfg, model = _model()
    params, opt = _state(model)
    step = make_train_step(model, AdamWConfig(lr=1e-3), remat=False)
    for batch in _batches(cfg, 3):
        params, opt, _ = step(params, opt, batch)
    ckpt_lib.save(str(tmp_path), 3, {"params": params, "opt": opt})
    static_p, static_o = _state(model, seed=1)
    static = leaves(static_p) + leaves(static_o)
    ids = [id(t) for t in static]
    restored, at = ckpt_lib.restore(str(tmp_path), {"params": static_p, "opt": static_o})
    assert at == 3
    given = leaves(restored["params"]) + leaves(restored["opt"])
    assert not any(g is s for g, s in zip(given, static))
    assert copy_into(static, given) == len(static)
    assert [id(t) for t in static] == ids
    _assert_trees_equal(static_p, params)
    _assert_trees_equal(static_o, opt)
    assert int(static_o["step"]) == 3
    for g in given:
        g.zero_()
    _assert_trees_equal(static_p, params)
    assert int(static_o["step"]) == 3
    # the same tensors again: nothing to copy
    assert copy_into(static, static) == 0
    mixed = list(static)
    mixed[0] = static[0].clone() + 1
    assert copy_into(static, mixed) == 1 and torch.equal(static[0], mixed[0])


@pytest.mark.parametrize("what", ["count", "shape", "dtype"])
def test_copy_into_refuses_a_tree_of_another_shape(what):
    static = [torch.zeros(2, 3), torch.zeros((), dtype=torch.int32)]
    given = [torch.ones(2, 3), torch.ones((), dtype=torch.int32)]
    if what == "count":
        given = given[:1]
    elif what == "shape":
        given[0] = torch.ones(3, 2)
    else:
        given[0] = torch.ones(2, 3, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        copy_into(static, given)
    assert not static[0].any()


def test_adopt_keeps_the_first_state_and_counts_copy_ins():
    """The first state a compiled step sees becomes its static state; the
    same trees again copy nothing, other trees (a restart's) are copied in
    and counted."""
    _, model = _model()
    compiled = CompiledTrainStep(lambda p, o, b: (p, o, {}), stats=GraphStats())
    p, o = _state(model)
    compiled._adopt(p, o)
    compiled._adopt(p, o)
    assert compiled.params is p and compiled.opt_state is o and compiled.stats.copy_ins == 0
    q, r = _state(model, seed=1)
    r["step"].fill_(7)
    compiled._adopt(q, r)
    assert compiled.params is p and compiled.stats.copy_ins == 1
    _assert_trees_equal(p, q)
    assert int(o["step"]) == 7


def test_batch_key_names_every_shape_and_dtype():
    a = {"tokens": torch.zeros(4, 16, dtype=torch.int64)}
    assert batch_key(a) == batch_key({"tokens": torch.ones(4, 16, dtype=torch.int64)})
    assert batch_key(a) != batch_key({"tokens": torch.zeros(8, 16, dtype=torch.int64)})
    assert batch_key(a) != batch_key({"tokens": torch.zeros(4, 16, dtype=torch.int32)})


def test_paths_name_the_leaves_in_flatten_order():
    """`tree.paths` (how the card's check names a parameter that differs)
    gives each leaf's dotted path, in `leaves`' order."""
    _, model = _model(layers=3)
    params, opt = _state(model)
    names = paths(params)
    assert len(names) == len(set(names)) == len(leaves(params))
    for name, leaf in zip(names, leaves(params), strict=True):
        node = params
        for part in name.split("."):
            node = node[int(part)] if part.isdigit() else node[part]
        assert node is leaf
    assert paths(opt) == [f"m.{n}" for n in names] + ["step"] + [f"v.{n}" for n in names]


def test_compiled_step_refuses_a_device_with_no_route():
    """CPU state runs eagerly, CUDA state is captured, and any other device
    raises the port's error."""
    _, model = _model()
    compiled = compile_train_step(lambda p, o, b: pytest.fail("the step ran"))
    params, opt = _state(model)
    meta = params.to("meta")
    with pytest.raises(_lib.ProgramError, match="meta"):
        compiled(meta, opt, {})


# ------------------------------------------------------- the port's error


def test_program_error_is_not_a_runtime_error():
    err = _lib.no_backward("ssd_scan", "ROADMAP.md queue 1, item 13d")
    assert isinstance(err, _lib.ProgramError) and not isinstance(err, RuntimeError)
    assert "item 13d" in str(err)


def _elastic(tmp_path, error: Exception):
    """run_elastic over a train step that raises `error` at step 3 of 6,
    checkpoints every 2; returns (how often make_state ran, the outcome)."""
    made = []

    def make_state():
        made.append(1)
        return {"w": torch.zeros(3)}

    def train_step(state, batch):
        if batch["step"] == 3 and len(made) == 1:
            raise error
        return {"w": state["w"] + 1}, {"loss": torch.tensor(float(batch["step"]))}

    cfg = ElasticConfig(ckpt_dir=str(tmp_path), ckpt_every=2)
    try:
        out = run_elastic(make_state, train_step, lambda s: {"step": s}, 6, cfg,
                          FailureInjector())
    except Exception as e:  # noqa: BLE001 - the outcome under test
        out = e
    return len(made), out


def test_elastic_loop_lets_a_program_error_through_at_once(tmp_path):
    """A kernel with no backward (or a step that cannot be captured) raises
    `ProgramError`, which the elastic loop does not take for a node
    failure: it propagates from the first failing step, `make_state`
    having run once."""
    err = _lib.no_backward("ssd_scan", "ROADMAP.md queue 1, item 13d")
    made, out = _elastic(tmp_path, err)
    assert out is err and made == 1


def test_elastic_loop_still_restarts_on_a_runtime_error(tmp_path):
    """The contrast: a `RuntimeError` (the loop's node failure) rebuilds
    the state and resumes from the newest checkpoint."""
    made, out = _elastic(tmp_path, RuntimeError("node lost"))
    state, stats = out
    assert made == 2 and stats["restarts"] == 1 and stats["resumed_from"] == [2]
    assert np.array_equal(state["w"].numpy(), np.full(3, 6.0))
