"""repro_torch — the PyTorch/CUDA port of the PPipe reproduction.

The JAX package `repro` is the reference; this package mirrors its module
layout and names so each part can be found beside its counterpart.  It
imports nothing of `repro` and never imports JAX: the device-free modules
(`core/`, `data/`, the queues/batcher/metrics of `dataplane/`) are copies.

Entry points run on CUDA unless the caller passes a CPU device.  The three
kernels on the serving path (`kernels/`) are hand-written CUDA for Hopper
(sm_90a); their plain PyTorch versions run only for tensors on the CPU.
"""
