"""`Model.loss` and its gradients against `jax.value_and_grad` of the
reference's `model.loss`, the MoE family (llama4-maverick-400b-a17b;
deepseek-v3-671b with MLA, its dense and MoE layers and the MTP term at
weight 0.3) at `reduced()`, on shared parameters and batches, f32 and bf16, remat on and
off.  Bounds in tests/test_torch_train_parity.py.  On the CPU the `KERNELS` ops
run their plain versions, so this holds the port's math and its autograd;
the backward kernels are held to the same plain math on the card
(tests/test_torch_cuda.py, chip_smoke.py).  The routing is the forward's,
held equal to the reference's (ids and kept choices) by
tests/test_torch_moe.py; llama4's top-1 router gradient is the named
exception of tests/test_torch_train_parity.py (zero in exact arithmetic)."""

import pytest

import test_torch_train_parity as tp

ARCHS = ["llama4-maverick-400b-a17b", "deepseek-v3-671b"]


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_reference_f32(arch):
    """Remat on and off give the reference's loss and gradients (the
    reference's taken with remat; its jax.checkpoint does not change them)."""
    _, _, cfg, model, params = tp.models(arch, "f32")
    batch = tp.batches(cfg, "f32")[1]
    want = tp.f32_reference(arch)
    for remat in (True, False):
        tp.check_f32(cfg, want, tp.port_loss_and_grads(model, params, batch, remat))


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_reference_bf16(arch):
    ref_model, rparams, cfg, model, params = tp.models(arch, "bf16")
    rb, tb = tp.batches(cfg, "bf16")
    ref = tp.ref_loss_and_grads(ref_model, rparams, rb, remat=False)
    tp.check_bf16(cfg, tp.f32_reference(arch)[1], ref,
                  tp.port_loss_and_grads(model, params, tb, remat=True))


def test_aux_load_balance_loss_matches_reference():
    """`moe.aux_load_balance_loss`, which no loss calls (nor the
    reference's), against the reference's on the same router and inputs."""
    import jax.numpy as jnp
    import numpy as np
    import torch

    from repro.models import moe as ref_moe
    from repro_torch.models import moe

    ref_model, rparams, cfg, _, params = tp.models("llama4-maverick-400b-a17b", "f32")
    x = np.random.default_rng(3).standard_normal((2, 12, cfg.d_model)).astype(np.float32)
    rp = {"router": rparams["layers"]["moe"]["router"][0]}
    want = float(ref_moe.aux_load_balance_loss(ref_model.cfg, rp, jnp.asarray(x)))
    got = float(moe.aux_load_balance_loss(cfg, params["layers"][0]["moe"], torch.from_numpy(x)))
    assert abs(got - want) <= 1e-6 * abs(want)
