"""`Model.loss` and its gradients against `jax.value_and_grad` of the
reference's `model.loss`, the recurrent family and the enc-dec
(xlstm-1.3b, zamba2-2.7b, seamless-m4t-large-v2 over its frames) at
`reduced()`, on shared parameters and batches (fan-in-conditioned, as
tests/test_torch_xlstm.py and tests/test_torch_encdec.py take them: at the
reference's own init these forwards are chaotic in f32), f32 and bf16,
remat on and off (the hybrid checkpoints each group, the enc-dec each
encoder and decoder layer).  Bounds in tests/test_torch_train_parity.py.
On the CPU the `KERNELS` ops run their plain versions, so this holds the
port's math and its autograd;
the backward kernels are held to the same plain math on the card
(tests/test_torch_cuda.py, chip_smoke.py)."""

import pytest

import test_torch_train_parity as tp

ARCHS = ["xlstm-1.3b", "zamba2-2.7b", "seamless-m4t-large-v2"]


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
