"""The port's checkpointing and elastic loop: tests/test_checkpoint.py on
the port (atomic commit, checksum, prune, async, elastic restart, resume),
and the on-disk layout shared with the reference: a step directory either
package writes restores in the other with equal bytes."""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.training import checkpoint as ref_ck
from repro_torch.training import checkpoint as ck
from repro_torch.training.elastic import (ElasticConfig, FailureInjector, run_elastic,
                                          shrink_mesh)


def _tree(v=0.0):
    return {"a": torch.full((4, 4), v), "b": {"c": torch.arange(6, dtype=torch.int32)}}


def test_save_restore_roundtrip(tmp_path):
    d = str(tmp_path)
    ck.save(d, 10, _tree(1.5))
    out, step = ck.restore(d, _tree())
    assert step == 10
    np.testing.assert_allclose(out["a"].numpy(), 1.5)
    np.testing.assert_array_equal(out["b"]["c"].numpy(), np.arange(6))
    assert out["b"]["c"].dtype == torch.int32


def test_latest_committed_skips_torn_writes(tmp_path):
    d = str(tmp_path)
    ck.save(d, 1, _tree())
    ck.save(d, 2, _tree())
    os.makedirs(os.path.join(d, "step_00000003"))  # a torn write: no _COMMITTED
    assert ck.latest_step(d) == 2


def test_checksum_detects_corruption(tmp_path):
    d = str(tmp_path)
    ck.save(d, 5, _tree(2.0))
    path = os.path.join(d, "step_00000005", "arr_00000.npy")
    arr = np.load(path)
    arr[0, 0] += 1
    np.save(path, arr)
    with pytest.raises(IOError, match="checksum"):
        ck.restore(d, _tree())


def test_prune_keeps_newest(tmp_path):
    d = str(tmp_path)
    for s in (1, 2, 3, 4, 5):
        ck.save(d, s, _tree())
    ck.prune(d, keep=2)
    assert ck.latest_step(d) == 5
    assert not os.path.exists(os.path.join(d, "step_00000001"))
    assert os.path.exists(os.path.join(d, "step_00000004"))


def test_async_save(tmp_path):
    d = str(tmp_path)
    t = ck.save(d, 7, _tree(3.0), async_=True)
    t.join()
    out, step = ck.restore(d, _tree())
    assert step == 7 and float(out["a"][0, 0]) == 3.0


def test_elastic_run_recovers_from_failures(tmp_path):
    """Injected failures at steps 25 and 61: the loop restarts from the newest
    committed checkpoint and completes all 80 steps with a consistent state."""
    d = str(tmp_path / "ckpt")

    def make_state():
        return {"w": torch.zeros(()), "step_sum": torch.zeros(())}

    def train_step(state, batch):
        w = state["w"] + batch["x"]
        return {"w": w, "step_sum": state["step_sum"] + 1}, {"loss": -w}

    def batch_for(step):
        return {"x": torch.tensor(float(step))}

    fail = FailureInjector(fail_at={25, 61})
    cfg = ElasticConfig(ckpt_dir=d, ckpt_every=10)
    state, stats = run_elastic(make_state, train_step, batch_for, 80, cfg, fail)
    assert stats["restarts"] == 2 and stats["resumed_from"] == [20, 60]
    assert float(state["w"]) == sum(range(80))
    assert float(state["step_sum"]) == 80


def test_elastic_resume_from_existing_ckpt(tmp_path):
    d = str(tmp_path / "ckpt")

    def make_state():
        return {"w": torch.zeros(())}

    def train_step(state, batch):
        return {"w": state["w"] + 1.0}, {"loss": state["w"]}

    cfg = ElasticConfig(ckpt_dir=d, ckpt_every=5)
    run_elastic(make_state, train_step, lambda s: {}, 10, cfg)
    state, stats = run_elastic(make_state, train_step, lambda s: {}, 20, cfg)
    assert float(state["w"]) == 20.0
    assert stats["resumed_from"][0] == 10


def test_shrink_mesh_drops_data_parallel_rows():
    devices = np.arange(8).reshape(4, 2)
    assert shrink_mesh(devices, 0) is devices
    np.testing.assert_array_equal(shrink_mesh(devices, 1), devices[:3])
    with pytest.raises(ValueError):
        shrink_mesh(devices, 4)


# -------------------------------------------------------- the shared layout


def _mixed(seed: int = 0):
    """f32, bf16 and int32 leaves in a dict, as numpy values (bf16 exact)."""
    rng = np.random.default_rng(seed)
    return {"w": rng.standard_normal((3, 5)).astype(np.float32),
            "h": {"b": (rng.standard_normal((4, 2)) * 4).astype(np.float32),
                  "s": np.arange(7, dtype=np.int32)}}


def _ref_tree(v):
    return {"w": jnp.asarray(v["w"]), "h": {"b": jnp.asarray(v["h"]["b"], jnp.bfloat16),
                                             "s": jnp.asarray(v["h"]["s"])}}


def _port_tree(v):
    return {"w": torch.from_numpy(v["w"]),
            "h": {"b": torch.from_numpy(v["h"]["b"]).to(torch.bfloat16),
                  "s": torch.from_numpy(v["h"]["s"])}}


def _files(path: str) -> dict:
    return {n: open(os.path.join(path, n), "rb").read() for n in sorted(os.listdir(path))
            if n.endswith(".npy")}


def _manifest(path: str) -> dict:
    with open(os.path.join(path, "manifest.json")) as f:
        m = json.load(f)
    m.pop("treedef")
    return m


def test_reference_step_restores_in_the_port(tmp_path):
    """A step directory the reference writes restores in the port with equal
    bytes, bf16 included; the port's own write of the same tree is the same
    files byte for byte, with an equal manifest apart from `treedef`."""
    v = _mixed()
    ref_ck.save(str(tmp_path / "ref"), 3, _ref_tree(v))
    out, step = ck.restore(str(tmp_path / "ref"), _port_tree(_mixed(1)))
    assert step == 3
    want = _port_tree(v)
    for key in ("w",):
        assert torch.equal(out[key], want[key])
    assert out["h"]["b"].dtype == torch.bfloat16 and torch.equal(out["h"]["b"], want["h"]["b"])
    assert out["h"]["s"].dtype == torch.int32 and torch.equal(out["h"]["s"], want["h"]["s"])
    ck.save(str(tmp_path / "port"), 3, _port_tree(v))
    ref_dir, port_dir = (str(tmp_path / k / "step_00000003") for k in ("ref", "port"))
    assert _files(port_dir) == _files(ref_dir)
    assert _manifest(port_dir) == _manifest(ref_dir)
    assert [m["dtype"] for m in _manifest(port_dir)["leaves"]] == ["bfloat16", "int32", "float32"]


def test_port_step_restores_in_the_reference(tmp_path):
    """The reverse: the reference's `restore` reads the port's f32 and int32
    leaves back equal and verifies every checksum; for the bf16 leaf it
    fails as on its own bf16 checkpoints (it cannot cast the '<V2' array
    np.load returns to bfloat16), while the port restores both."""
    v = _mixed()
    ck.save(str(tmp_path / "p"), 4, _port_tree(v))
    flat = {"w": jnp.asarray(v["w"]), "s": jnp.asarray(v["h"]["s"])}
    ck.save(str(tmp_path / "q"), 4, {"w": torch.from_numpy(v["w"]),
                                     "s": torch.from_numpy(v["h"]["s"])})
    out, step = ref_ck.restore(str(tmp_path / "q"), flat)
    assert step == 4
    np.testing.assert_array_equal(np.asarray(out["w"]), v["w"])
    np.testing.assert_array_equal(np.asarray(out["s"]), v["h"]["s"])
    with pytest.raises(ValueError, match="No cast function"):
        ref_ck.restore(str(tmp_path / "p"), _ref_tree(v))
    ref_ck.save(str(tmp_path / "r"), 4, _ref_tree(v))
    with pytest.raises(ValueError, match="No cast function"):
        ref_ck.restore(str(tmp_path / "r"), _ref_tree(v))


def test_restore_places_leaves_like_the_fresh_state(tmp_path):
    """Each leaf lands in the dtype of its counterpart in `like`; a ParamTree
    comes back as a ParamTree of frozen leaves."""
    from repro_torch.configs import get_config
    from repro_torch.models.model_zoo import build_model
    from repro_torch.training.tree import leaves

    model = build_model(get_config("qwen2-1.5b").reduced(n_layers=2))
    params = model.init(torch.Generator().manual_seed(0))
    ck.save(str(tmp_path), 1, {"params": params})
    fresh = model.init(torch.Generator().manual_seed(1))
    out, _ = ck.restore(str(tmp_path), {"params": fresh})
    assert type(out["params"]) is type(params)
    for a, b in zip(leaves(out["params"]), leaves(params)):
        assert a.dtype == b.dtype and torch.equal(a, b) and not a.requires_grad
