#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (src/repro_torch) on one NVIDIA GPU.

Run from a checkout of the repository:

    python3 chip_smoke.py

Phases, each of which must pass (any failure raises and exits non-zero):

1. build the five CUDA libraries from `src/repro_torch/kernels/*/csrc` with
   nvcc for sm_90a, one nvcc per source, in parallel;
2. hold every kernel against its plain PyTorch version on the card at the
   main paths' shapes (quantize bit-equal at every launch instance, and
   timed at the serve boundary, decode, narrow and long shapes;
   rmsnorm, flash and decode attention at every shape the smoke paths
   run (phase 8's serve_pipeline example's included), flash attention's
   f32 route also at tests/test_kernels.py's f32 shapes and non-causal,
   and both routes at the VLM's and the enc-dec's
   shapes (llava-next-34b's causal prefill, seamless-m4t-large-v2's
   non-causal encoder and its cross-attention, Sq != Sk), the MoE
   family's prefills (llama4-maverick-400b-a17b's, G = 5; deepseek-v3's
   MLA at head_dim 192 with 128-wide values, which both routes read at
   their own width) and a causal Sq != Sk either way, the bf16 forward
   beside its launch plan (`forward_plan`, held to the source's) and also
   timed with a cold L2, rmsnorm
   also at qwen3-14b's qk_norm and decode attention (bf16 and
   f32) at every decode shape (llama4's at G = 5), llava-next-34b's and
   one of qwen3-14b taking the split path; ssd_scan in f32 with q and k
   broadcast or per head, with and without log_i, and in bf16, and at the
   mLSTM's state widths (xlstm-1.3b: DK 1024, DV 1025, log_i over its clip
   range [-30, 10]) in bf16 at its prefill and train micro-batch and in f32
   at its prefill, each split by launch), and time it beside its bound, its
   plain version and one PyTorch library call (a yardstick only; the port
   never calls it), with the host time of one call;
3. serve stablelm-3b at full width (32 layers, random weights from a seed)
   through the port's public entry point, `repro_torch.api.Session`, on
   one h100 and eight l4 stand-ins (every pool co-resident on the card),
   in three acts, the counterpart of examples/serve_pipeline.py: the MILP
   plan deployed for real on a Poisson and a bursty trace; a hand-pinned
   2-stage pooled plan through `use_plan`, calibrated on the card, with
   measured feedback; a live `swap` to another partitioning warmed on a
   background thread.  Every stage runs as a CUDA graph captured at
   deploy (or in the swap's warm) and replayed; a stage call that finds
   no graph fails the phase.  Every request must be served with no
   executor failure (the data plane would drop the batch of a kernel that
   failed), and serving must launch the RMSNorm and attention kernels
   (counted through the replays).  The pinned plan's stages are then run
   as served and eagerly, in turns, for the device busy share and stage
   times of either;
4. check the full-width stage split through the kernels against the plain
   PyTorch math on the same parameters: layer by layer from the same input,
   and the whole forward by the decisive-margin top-1 rule;
5. decode through the model API (`build_model(cfg).prefill` then greedy
   `decode_step`): stablelm-3b on the serve phase's parameters (8 prompts
   of 128 tokens, 32 steps; the serve phase's session is released after
   it), zamba2-2.7b and xlstm-1.3b at full width and depth (54 and 48
   layers, random weights from a seed; 4 prompts of 512 tokens, 16 steps),
   seamless-m4t-large-v2 (24 + 24 layers; 4 requests of 1024 frame
   embeddings, the BOS step, 32 steps) and llava-next-34b (60 layers,
   d_model 7168, 34.39 B parameters; 2 requests of 2880 patch embeddings
   and 128 tokens, 16 steps), all at full width and depth; then the MoE
   family at full width and the depth that fits on the card
   (`DEPTH_CUTS`): llama4-maverick-400b-a17b at 2 of 48 layers and
   deepseek-v3-671b at 5 of 61 (its 3 dense layers, 2 MoE layers and the
   MTP module, whose forward is held to the model's), 2 requests of 512
   tokens, 16 steps.  Each step's
   logits are held to the teacher-forced forward (the serving invariant)
   in bf16, beside witnesses from the same tokens: the plain math in bf16,
   and the kernels in f32, which must hold the invariant at decisive
   positions (and, for the attention models, have some; llava-next-34b's
   at 8 layers, llama4's at 1 and deepseek-v3's at 4 (3 dense, 1 MoE),
   each after its bf16 weights are freed: no more fits on the card in
   f32).  A fresh prefill and one step are held, cache slot by
   cache slot, to the layers walked one at a time; every layer (every
   group's blocks; the encoder layers and the decoder's self-, cross- and
   MLP blocks; the MoE family's attention and FFN blocks) is held to the
   plain math, and its decode form to its full form, from the same input
   (an MoE block at the tokens both route alike: the walks count the
   routing decisions that flip, at most `FLIP_LIMIT` of them in bf16 and
   none in f32); the launch counts show the path ran each
   kernel its layers call (rmsnorm, flash_attention, decode_attention,
   ssd_scan) as often as its layers do; a profiler window over one
   prefill of each model reads its device busy share and top kernels, and
   each run logs its peak device memory.

6. train (`[train]` lines): (a) qwen2-1.5b at full width and depth (28
   layers, 1.78 B parameters, random weights from a seed) for eight steps
   of the port's `make_train_step` (AdamW, remat, two micro-batches of
   4 x 1024 tokens from `TokenPipeline`), twice from the same seed and
   batches: run eagerly, then compiled (`compile_train_step`: a warm-up
   step, one CUDA graph captured, replayed every later step), the graphed
   run's losses, gradient norms and final parameters bit-equal to the
   eager run's; every loss and gradient norm finite, with each run's step
   times, peak memory (allocated and reserved), tokens/s, the launches of
   each kernel a step (the rmsnorm and flash attention forwards through
   their autograd routes, their backward kernels, as many as the layers
   make; in the graphed run the warm-up's, the graph's recorded once and
   run once a replay) and one step's device busy share and host launch
   calls; (b) one loss and its gradients
   at full width and 2 of 28 layers through the kernels and through the
   plain math, every leaf within 5e-2 of its scale, and so for
   deepseek-v3-671b's first layer (dense) and its MTP module's layer, MLA
   at q and k 192, v 128 through the flash backward (3.12 B parameters);
   for these, for zamba2-2.7b's first group, xlstm-1.3b's first period and
   seamless-m4t-large-v2's first 2 encoder and 2 decoder layers, every leaf
   through the kernels within `F32_FLOOR_FACTOR` times the plain math's
   own bf16 distance from the f32 gradient (at least 5e-2), and at each
   scan call autograd's gradients bit-equal to the scan's backward kernel
   at the call's own inputs and cotangents; (c) the elastic loop
   of `repro_torch.examples.train_small` on the card, its step compiled,
   150 steps with checkpoints every 50 and a failure at step 120: the loss
   falls, the restart reaches the graph through one copy of the restored
   state into its buffers, and the losses after the restore equal an
   uninjected run's; (d) zamba2-2.7b at full width and depth (54 layers,
   2.06 B parameters) through the same two runs as (a), bit-equal, with
   `ssd_scan` and `ssd_scan_backward` launched as its Mamba2 blocks make
   them; (e) seamless-m4t-large-v2 at full width and depth (24 encoder
   and 24 decoder layers, 2.035 B parameters) through the same two runs,
   each micro-batch 4 x 1024 frame embeddings and 4 x 256 tokens, its
   encoder's and cross-attention's non-causal attention (q of 256 rows
   over 1024) through flash attention's backward; (f) xlstm-1.3b at full
   width and depth (48 layers: 42 mLSTM blocks at state widths 1024 x
   1025, 6 sLSTM blocks; 3.530 B parameters) through the same two runs of
   3 steps each, bit-equal, with `ssd_scan` and `ssd_scan_backward`
   launched as its mLSTM blocks make them (the wide route); no eager step
   is profiled (its sLSTM's ~1.4 M launches), so its busy share is the
   device time of one more replay, profiled, over the eager step's wall,
   and that device time is split into the wide route, the sLSTM's
   elementwise kernels (one sLSTM block replayed alone) and the rest.
   Each compiled run logs its graph's nodes, its record and instantiation
   seconds and its pool.  Phase 2 also
   holds the backward kernels (`rmsnorm_backward`, flash attention's
   LSE-writing forward and its backward, `ssd_scan_backward`) against
   their plain backward run in f32, at the train shapes (`train_small`'s
   too; the scan's at zamba2-2.7b's and the mLSTM's and a ragged one; the
   flash backward's also at seamless-m4t-large-v2's non-causal encoder
   and cross-attention and its causal decoder, a ragged non-causal Sq <
   Sk, a causal Sq < Sk and Sq > Sk, deepseek-v3's MLA at a training micro-batch (q and k 192
   wide, v 128), 16 query heads a KV head and q, k and v all 192 wide)
   and the serve's or a G = 1 one; flash attention's
   backward is split by launch (Delta, dK/dV, dQ) and read in TFLOP/s
   against its bound.

7. the dry run (`[dry run]` lines): `repro_torch.kernels.occupancy`'s
   table of the backward kernels' occupancy held equal to the card's
   readings; six calls of the earlier phases, each measured on the card
   where it ran (its peak allocated memory less what was allocated before
   it and is none of its inputs; `measured`): 6a's, 6d's, 6e's and 6f's
   second eager train step and llava-next-34b's and llama4's prefills,
   each traced again on the meta device (`repro_torch.launch.hlo_analysis`,
   the dry run's tracker, through the kernels' CUDA route with no
   launch; 6f's in a process of its own started before phase 6), the
   predicted peak within 5% of the measured and every kernel's launches
   equal to the card's; printed, not held: each trace's wall, and for the
   MoE pair the deepest prefill of phase 5's shape the dry run predicts
   fits the card, beside `DEPTH_CUTS`.

8. the examples (`[examples]` lines): the port's four examples,
   `repro_torch.examples.{quickstart,plan_explorer,stream_serve,
   serve_pipeline}`, in this process with the reference CI's arguments
   (`--quick` but for quickstart), serve_pipeline's four acts on the card
   (a reduced stablelm-3b: 8 layers, d_model 256, 4 heads of 64, 32 tokens
   a request, whose rmsnorm and flash-attention shapes phase 2 holds);
   every request served with no executor failure, the two kernels
   launched (`launches_by_path.examples`), each example's wall and each
   workload's attainment and p50 logged.

With `--parent ROOT` (another tree of the repository, such as the parent
commit unpacked), every kernel that tree has is built too, timed in turns
with this tree's at the same inputs, and run in a second profiled prefill
(not for a model whose path needs a wrapper's argument that tree lacks,
which is logged).

The line before the last is a JSON object with one entry per kernel; the
last line is `{"ok": true, "device": {...}}`.  Without a CUDA device, or
outside a checkout, the script exits non-zero and prints no result.
"""

from __future__ import annotations

import contextlib
import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SEED = 0
MODEL = "stablelm-3b"
SEQ = 128          # tokens per request
BATCH = 8          # unified batch of the pinned plan
N_BLOCKS = 6
CUT = 3            # blocks [0, CUT) on the 3-member l4 pool, the rest on the h100
L4_COUNT = 8       # l4 stand-ins beside the one h100
N_REQUESTS = 48    # requests a trace
SWAP_REQUESTS = 10 * N_REQUESTS  # the live swap's trace (act_swap says why)
# SLO scales (x the h100's analytic batch-1 latency): the ModelSpec default
# for the MILP act, where the planner pools l4s in front of the h100 (at 3x
# no l4 stage fits and the h100 serves alone); 8x for the swap act, whose
# MILP plan and the plan it swaps to both fit; 20x for the pinned plan,
# whose batch of 8 must pass use_plan's analytic check (its trace's SLO
# comes from the calibrated latency)
MILP_SLO_SCALE, SWAP_SLO_SCALE, PINNED_SLO_SCALE = 5.0, 8.0, 20.0
# phase 8: the port's examples in-process, as the reference's CI runs them
# (`.github/workflows/ci.yml`), serve_pipeline on the card; the largest
# batch its plans serve (the MILP's h100 pool), for phase 2's shapes
EXAMPLES = (("quickstart", []), ("plan_explorer", ["--quick"]), ("stream_serve", ["--quick"]),
            ("serve_pipeline", ["--quick", "--device", "cuda"]))
EXAMPLE_MAX_BATCH = 16
# phase 5: (arch, batch, prompt tokens (the VLM's after its 2880 patch
# embeddings; the enc-dec's frame embeddings), greedy decode steps)
DECODE_RUNS = (("stablelm-3b", 8, 128, 32), ("zamba2-2.7b", 4, 512, 16),
               ("xlstm-1.3b", 4, 512, 16), ("seamless-m4t-large-v2", 4, 1024, 32),
               ("llava-next-34b", 2, 128, 16))
DECODE_RUNS += (("llama4-maverick-400b-a17b", 2, 512, 16), ("deepseek-v3-671b", 2, 512, 16))
# models run at full width and fewer layers than their configs', for memory
# (the first layers: deepseek-v3's dense ones, then its MoE ones), on the
# full model's per-layer init formulas (the stacked fan-in of every layer):
# one llama4 layer holds 32.2 GB of experts (3 x 128 x 5120 x 8192 bf16),
# so 2 layers and the 2.07 B-parameter embedding and head make 34.66 B
# parameters, 69.3 GB; deepseek-v3's 3 dense layers, 2 MoE layers (22.5 GB
# of experts each) and the MTP module make 27.30 B, 54.6 GB.  Neither fits
# at full depth on four cards either (0.8 and 1.3 TB in bf16).
DEPTH_CUTS = {"llama4-maverick-400b-a17b": 2, "deepseek-v3-671b": 5}
# models whose f32 witness runs at full width and fewer layers, after the
# bf16 weights are freed: llava-next-34b's 60 layers in f32 would take 137
# GB; llama4's 1 layer is 73.5 GB in f32 and deepseek-v3's 3 dense layers and
# 1 MoE layer 63.2 GB, the fewest layers that hold an MoE layer
F32_WITNESS_LAYERS = {"llava-next-34b": 8, "llama4-maverick-400b-a17b": 1,
                      "deepseek-v3-671b": 4}
# the share of an MoE walk's routing decisions (a token's expert ids at one
# layer) that may flip between the kernels and the plain math, or between a
# block's decode and full forms, in bf16: the attention in front of the
# router rounds apart, and a near-tied choice can flip, moving that token's
# output by O(1); a fault in the kernels in front of the router flips many.
# In f32, none may flip.
FLIP_LIMIT = 0.15
PROFILED_STEPS = 4

# NVIDIA H100 SXM data sheet (dense): the bf16 tensor-core peak; every
# kernel's bound comes from its entry's work count in the package
# (`repro_torch.kernels.work`: bytes, operations by precision class, the
# data sheet's rates)
BF16_FLOP_S = 989e12
FLUSH_BYTES = 128 << 20  # written between calls for a cold-L2 reading (L2: 50 MB)

# The backward kernels have no Pallas counterpart: the reference takes their
# gradients with jax.grad through its plain math (the line each replaces).
KERNEL_SOURCES = {
    "quantize": ("src/repro_torch/kernels/boundary_quant/csrc/boundary_quant.cu",
                 "src/repro/kernels/boundary_quant/kernel.py:32"),
    "dequantize": ("src/repro_torch/kernels/boundary_quant/csrc/boundary_quant.cu",
                   "src/repro/kernels/boundary_quant/kernel.py:56"),
    "rmsnorm": ("src/repro_torch/kernels/rmsnorm/csrc/rmsnorm.cu",
                "src/repro/kernels/rmsnorm/kernel.py:26"),
    "flash_attention": ("src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention/kernel.py:70"),
    "decode_attention": ("src/repro_torch/kernels/decode_attention/csrc/decode_attention.cu",
                         "src/repro/kernels/decode_attention/kernel.py:61"),
    "ssd_scan": ("src/repro_torch/kernels/ssd_scan/csrc/ssd_scan.cu",
                 "src/repro/kernels/ssd_scan/kernel.py:75"),
    "rmsnorm_backward": ("src/repro_torch/kernels/rmsnorm/csrc/rmsnorm.cu",
                         "src/repro/models/common.py:266"),
    "flash_attention_forward_lse": (
        "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu",
        "src/repro/kernels/flash_attention/kernel.py:70"),
    "flash_attention_backward": (
        "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu",
        "src/repro/models/common.py:326"),
    "ssd_scan_backward": ("src/repro_torch/kernels/ssd_scan/csrc/ssd_scan.cu",
                          "src/repro/models/ssm.py:29"),
}
KERNEL_NAMES = tuple(KERNEL_SOURCES)
# the training run of phase 6: qwen2-1.5b at full width and depth, AdamW,
# remat, two micro-batches of 4 x 1024 tokens a step
TRAIN_ARCH = "qwen2-1.5b"
TRAIN_STEPS, TRAIN_SEQ, TRAIN_BATCH, TRAIN_ACCUM = 8, 1024, 8, 2
# phase 6d: zamba2-2.7b at full width and depth (54 layers: 45 Mamba2
# blocks, the shared attention block applied 9 times), the same run as 6a
HYBRID_TRAIN_ARCH = "zamba2-2.7b"
# phase 6e: seamless-m4t-large-v2 at full width and depth (24 encoder and
# 24 decoder layers), the same run as 6a over micro-batches of 4 x
# TRAIN_SEQ frame embeddings and 4 x ENCDEC_TRAIN_TEXT text tokens
ENCDEC_TRAIN_ARCH, ENCDEC_TRAIN_TEXT = "seamless-m4t-large-v2", 256
# phase 6f: xlstm-1.3b at full width and depth (48 layers: 42 mLSTM blocks
# at state widths DK 1024, DV 1025 and 6 sLSTM blocks), the same run as 6a
# for fewer steps (a warm-up, the measured second step, a replay): its
# sLSTM, a loop over time steps in plain PyTorch, makes ~1.4 M launches a
# step (forward, remat's recompute, backward), so an eager step takes
# ~45 s of host time and its graph ~2 minutes to record and instantiate
XLSTM_TRAIN_ARCH, XLSTM_TRAIN_STEPS = "xlstm-1.3b", 3
# phase 6b's MLA model and phase 2's MLA backward row: deepseek-v3's
# attention, q and k 128 + 64 wide, v 128, through the flash backward
MLA_TRAIN_ARCH = "deepseek-v3-671b"
# phase 6b: (arch, layers kept) at full width: qwen2-1.5b's first 2 of 28;
# zamba2-2.7b's first group (5 Mamba2 blocks and the shared attention);
# xlstm-1.3b's first period (7 mLSTM blocks at DK 1024, DV 1025, 1 sLSTM);
# seamless-m4t-large-v2's first 2 encoder and first 2 decoder layers;
# deepseek-v3-671b's first layer, a dense one, and its MTP module's dense
# layer: two MLA layers through the flash backward at q and k 192, v 128
# (3.12 B parameters: the embedding and the head 0.93 B each, a layer 0.58
# B, the MTP projection 0.10 B; 6.2 GB in bf16, 12.5 GB in f32, so the
# three routes' parameters and gradients ~44 GB before activations; an MoE
# layer holds 11.3 B)
GRAD_PARITY_RUNS = ((TRAIN_ARCH, 2), (HYBRID_TRAIN_ARCH, 6), ("xlstm-1.3b", 8),
                    (ENCDEC_TRAIN_ARCH, 2), (MLA_TRAIN_ARCH, 1))
# 6b's held rule beside the plain math: each leaf's gradient through the
# kernels no farther from the f32 gradient than this many times the plain
# math's own bf16 distance from it, or this many times 5e-2 where that
# distance is smaller.  The recurrent models' bf16 gradients miss their f32
# ones at their own inits by far more than 5e-2 in either route (zamba2's
# decays of ~ -2 a step; xlstm's exponential gates: PERF.md section 6), so
# there the two bf16 routes are held each against f32, not to each other
F32_FLOOR_FACTOR = 2.0
ELASTIC_STEPS, ELASTIC_FAIL_AT, ELASTIC_CKPT_EVERY = 150, 120, 50
# phase 7: the calls whose peak memory and launches the dry run predicts
# (`launch/dryrun.py`'s trace on the meta device), each measured where the
# earlier phases make it: the second eager step of 6a, 6d, 6e and 6f (after
# the first, the warm-up) and these models' prefills in phase 5; the
# prediction must lie within DRY_RUN_TOL of the card's peak
DRY_RUN_PREFILLS = ("llava-next-34b", "llama4-maverick-400b-a17b")
DRY_RUN_TOL = 0.05


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, iters: int = 50, warmup: int = 5, cold: bool = False) -> float:
    """Mean device time of one call: `iters` calls timed by CUDA events,
    queued behind a device-side sleep so the card runs them back to back
    (the host issues a call more slowly than the card runs these kernels).
    Hot (the default): inputs stay in L2 from call to call, as they are on
    the serving path, one pair of events around all the calls.  `cold`:
    before each call the card writes `FLUSH_BYTES`, more than its 50 MB L2
    holds, and each call has its own pair of events; the mean of those
    intervals (the writes outside them)."""
    import torch

    flush = torch.empty(FLUSH_BYTES // 4, device="cuda") if cold else None
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2 + 2 * iters)]
    for attempt in range(4):
        ev[0].record()
        torch.cuda._sleep(int(2e7 * 4 ** attempt))
        ev[1].record()
        t0 = time.perf_counter()
        for n in range(iters):
            if cold:
                flush.zero_()
                ev[2 + 2 * n].record()
            fn()
            if cold:
                ev[3 + 2 * n].record()
        host_ms = (time.perf_counter() - t0) * 1e3
        if not cold:
            ev[2].record()
        ev[-1 if cold else 2].synchronize()
        if ev[0].elapsed_time(ev[1]) > 1.1 * host_ms:  # the queue never ran dry
            if cold:
                return sum(ev[2 + 2 * n].elapsed_time(ev[3 + 2 * n]) for n in range(iters)) / iters
            return ev[1].elapsed_time(ev[2]) / iters
    raise RuntimeError("the host could not queue the timed calls ahead of the card")


def host_ms(fn, calls: int = 1000) -> float:
    """Host time of one call: `calls` calls on the host clock, the card
    drained before (the wrapper's Python, its checks and launches; these
    kernels run faster than the host issues them, so the launch queue never
    fills and the host never waits on the card)."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    elapsed = time.perf_counter() - t0
    torch.cuda.synchronize()
    return elapsed / calls * 1e3


def once_ms(fn, warmup: int = 1) -> float:
    """Time of one call between CUDA events, the card drained before it,
    the host's gaps included: for a plain version whose host work outruns
    the card, so that `time_ms` cannot queue its calls ahead."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def bound_ms(work) -> tuple[float, str]:
    """A kernel entry's bound at a call's shapes, in ms, from its work
    count (`repro_torch.kernels.work.bound_ms`): the larger of its bytes
    over the HBM rate and its operations, each class at its own peak."""
    from repro_torch.kernels.work import bound_ms as work_bound

    return work_bound(work)


def gpu_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


# ----------------------------------------------------------------- phase 1


def load_parent(root: Path) -> dict:
    """The kernel wrapper modules of another tree of this repository
    (`--parent ROOT`), by kernel name, one for every kernel its `_lib`
    builds; imported under the package name `parent_kernels` so they sit
    beside this tree's.  Their libraries build into that tree."""
    import importlib
    import importlib.util

    pkg = root / "src" / "repro_torch" / "kernels"
    spec = importlib.util.spec_from_file_location(
        "parent_kernels", pkg / "__init__.py", submodule_search_locations=[str(pkg)])
    module = importlib.util.module_from_spec(spec)
    sys.modules["parent_kernels"] = module
    spec.loader.exec_module(module)
    lib = importlib.import_module("parent_kernels._lib")
    return {name: importlib.import_module(f"parent_kernels.{name}.ops") for name in lib.SOURCES}


def phase_build(parent) -> None:
    from repro_torch.kernels import _lib

    t0 = time.perf_counter()
    seconds = _lib.build_all()
    if parent is not None:
        sys.modules["parent_kernels._lib"].build_all()
    log(f"[build] {len(seconds)} libraries in {time.perf_counter() - t0:.1f} s "
        f"(nvcc {_lib.nvcc_path()}, flags {' '.join(_lib.NVCC_FLAGS)})")
    for name in seconds:
        log_path = _lib.lib_path(name).with_suffix(".log")
        entry = ""
        for line in log_path.read_text().splitlines():
            m = re.search(r"Compiling entry function '(\w+)'", line)
            if m:
                entry = kernel_label(m.group(1))
            elif "registers" in line or "spill" in line:
                log(f"[build] {name}: {entry}: {line.strip()}")


def kernel_label(mangled: str) -> str:
    """A kernel's name and leading template arguments (types float and
    bf16, integers, booleans) from its mangled name (`_Z<len><name>`, or
    inside an anonymous namespace `..._cu_<8 hex><len><name>`), for the
    build lines; the mangled name where neither fits."""
    m = (re.search(r"_cu_[0-9a-f]{8}(\d+)(\w+)", mangled)
         or re.match(r"_Z(\d+)(\w+)", mangled))
    if m is None:
        return mangled
    n, rest = int(m.group(1)), m.group(2)
    name, tail = rest[:n], rest[n:]
    if not tail.startswith("I"):
        return name
    args, tail = [], tail[1:]
    for tok in iter(lambda: re.match(r"Li(\d+)E|Lb([01])E|f|13__nv_bfloat16", tail), None):
        args.append(tok.group(1) or {"0": "false", "1": "true"}.get(tok.group(2))
                    or ("float" if tok.group(0) == "f" else "bf16"))
        tail = tail[tok.end():]
    return name + (f"<{', '.join(args)}>" if args else "")


# ----------------------------------------------------------------- phase 2


def phase_kernels(dev, parent) -> dict:
    """Each kernel against its plain version at the serving shapes; returns
    the per-kernel measurements for the kernels line.  `parent`: the other
    tree's kernel modules (`--parent`), timed in turns with this tree's, or
    None."""
    import torch

    from repro_torch.kernels.boundary_quant import ops as bq

    g = torch.Generator(device=dev).manual_seed(SEED)
    bf16 = torch.bfloat16
    N, D = BATCH * SEQ, 2560
    res = {}

    def err(a, b) -> float:
        return float((a.float() - b.float()).abs().max())

    res["rmsnorm"] = check_rmsnorm(dev, g, err, parent)
    res["flash_attention"] = check_flash_attention(dev, g, err, parent)

    # boundary quantization: (B*S, 2560) bf16, the boundary activations
    res["quantize"], qv, s = check_quantize(dev, g, parent)
    got, want = bq.dequantize(qv, s, bf16), bq.dequantize_plain(qv, s, bf16)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        raise AssertionError(f"dequantize differs from its plain version by {err(got, want)}")
    b_ms, b_by = bound_ms(bq.dequantize_work(N, D, 2))
    ms, parent_ms = paired_ms(lambda m: m.dequantize(qv, s, bf16), bq, parent)
    res["dequantize"] = dict(
        max_abs_err=err(got, want), tol="bit-equal", ms=ms, parent_ms=parent_ms,
        plain_ms=time_ms(lambda: bq.dequantize_plain(qv, s, bf16)),
        bound_ms=b_ms, bound_by=b_by, library_ms=None,
        host_ms=host_ms(lambda: bq.dequantize(qv, s, bf16)))

    res["decode_attention"] = check_decode_attention(dev, g, err, parent)
    res["ssd_scan"] = check_ssd_scan(dev, g, err, parent)
    res["rmsnorm_backward"] = check_rmsnorm_backward(dev, g, parent)
    res["flash_attention_forward_lse"], res["flash_attention_backward"] = \
        check_flash_backward(dev, g, parent)
    res["ssd_scan_backward"] = check_ssd_backward(dev, g, parent)
    for name, r in res.items():
        lib_us = "none" if r["library_ms"] is None else f"{r['library_ms'] * 1e3:.1f} us"
        log(f"[kernels] {name}: max|err| {r['max_abs_err']:.3g} (tol {r['tol']}), "
            f"{r['ms'] * 1e3:.1f} us{vs_parent(r['parent_ms'])} vs bound "
            f"{r['bound_ms'] * 1e3:.2f} us ({r['bound_by']}), "
            f"plain {r['plain_ms'] * 1e3:.1f} us, library {lib_us}, "
            f"host {r['host_ms'] * 1e3:.1f} us a call")
    return res


# (N, D) of quantize's checks: every launch instance (narrow rows of 1-4
# chunks a lane, D = 1 and 7 element-wise; few narrow rows as blocks of 64,
# 96 and 128 threads of one chunk; block rows of 2, 3, 4 and 8 chunks; the
# two-pass kernel past the widest plan), ragged row counts
QUANT_ROWS = ((1023, 1), (333, 7), (1000, 96), (600, 264), (700, 520), (2000, 1024),
              (77, 264), (129, 520), (64, 1024), (1001, 2560), (9, 8200), (3, 16384),
              (3, 20000), (2, 40000))


# (what, N, D) of quantize's timed bf16 shapes: the serve's boundary
# activations first (the kernels line's time), then a decode step's
# boundary rows, a narrow and a long row count
QUANT_TIMED = (("serve boundary", BATCH * SEQ, 2560),
               ("stablelm-3b decode", DECODE_RUNS[0][1], 2560),
               ("zamba2-2.7b decode", DECODE_RUNS[1][1], 2560),
               ("narrow", 64, 1024), ("few columns", 333, 7), ("long", 4096, 2560))


def check_quantize(dev, g, parent):
    """quantize bit-equal to its plain version in bf16 and f32 at every
    launch instance, on an unaligned view and on zero and tiny rows, then
    timed (and checked again) at each bf16 shape of QUANT_TIMED.  Returns
    the kernels-line entry, whose times are the serve boundary's and whose
    `shapes` holds all, and the serve boundary's (q, scale)."""
    import torch

    from repro_torch.kernels.boundary_quant import ops as bq

    worst = 0

    def same(x, what):
        nonlocal worst
        (q, s), (qp, sp) = bq.quantize(x), bq.quantize_plain(x)
        torch.cuda.synchronize()
        n = int((q != qp).sum())
        if n or not torch.equal(s, sp):
            raise AssertionError(f"quantize ({what}) differs from its plain version: {n} values, "
                                 f"scales equal {torch.equal(s, sp)}")
        worst = max(worst, int((q.int() - qp.int()).abs().max()))
        return q, s

    checked = 0
    for dtype in (torch.float32, torch.bfloat16):
        for N, D in QUANT_ROWS:
            same((torch.randn(N, D, generator=g, device=dev) * 20).to(dtype), f"{N}x{D} {dtype}")
            checked += 1
        base = (torch.randn(300 * 2560 + 3, generator=g, device=dev) * 20).to(dtype)
        same(base[3:].view(300, 2560), f"unaligned view, {dtype}")
        x = (torch.randn(4, 2560, generator=g, device=dev) * 20).to(dtype)
        x[0], x[1], x[2] = 0, x[2] * 1e-10, x[3] * 1e-12
        same(x, f"zero and tiny rows, {dtype}")
        checked += 2
    shapes, qv, s = [], None, None
    for what, N, D in QUANT_TIMED:
        h = (torch.randn(N, D, generator=g, device=dev) * 20).to(torch.bfloat16)
        q, sc = same(h, f"{what} shape")
        if qv is None:
            qv, s = q, sc
        b_ms, b_by = bound_ms(bq.quantize_work(N, D, 2))
        ms, parent_ms = paired_ms(lambda m: m.quantize(h), bq, parent)
        plan = list(bq.launch_plan(D, 2, N, torch.cuda.get_device_properties(dev)
                                   .multi_processor_count))
        r = dict(shape=[N, D], what=what, plan=plan, max_abs_err=float(worst), tol="bit-equal",
                 ms=ms, parent_ms=parent_ms, plain_ms=time_ms(lambda: bq.quantize_plain(h)),
                 bound_ms=b_ms, bound_by=b_by, library_ms=None,
                 host_ms=host_ms(lambda: bq.quantize(h)))
        log(f"[kernels] quantize at the {what} shape ({N}, {D}) bf16, {plan[0]} lanes x "
            f"{plan[1]} chunks a row: {ms * 1e3:.3f} us{vs_parent(parent_ms)} vs bound "
            f"{b_ms * 1e3:.3f} us ({b_by}), plain {r['plain_ms'] * 1e3:.3f} us; host "
            f"{r['host_ms'] * 1e3:.3f} us a call")
        shapes.append(r)
    log(f"[kernels] quantize bit-equal to its plain version at {checked + len(shapes)} (N, D, "
        f"dtype) cases (every launch instance, ragged N, an unaligned view, zero and tiny rows, "
        f"the timed shapes)")
    return dict(shapes[0], max_abs_err=float(worst), shapes=shapes), qv, s


def paired_ms(call, ops, parent, **kw) -> tuple[float, float | None]:
    """Device time of `call(ops)`, `ops` this tree's wrapper module of a
    kernel, and, under `--parent`, of `call` on the other tree's module of
    the same kernel, timed in turns (parent, this, this, parent) and
    averaged; None for the parent where there is none or it lacks the
    kernel."""
    other = (parent or {}).get(ops.__name__.split(".")[-2])
    if other is None:
        return time_ms(lambda: call(ops), **kw), None
    p0, t0, t1, p1 = (time_ms(lambda m=m: call(m), **kw) for m in (other, ops, ops, other))
    return (t0 + t1) / 2, (p0 + p1) / 2


def vs_parent(parent_ms: float | None) -> str:
    return "" if parent_ms is None else f", parent {parent_ms * 1e3:.3f} us"


def kernel_us(fn, calls: int = 20) -> dict[str, float]:
    """Device time a call of each kernel `fn` launches, by kernel name, from
    torch.profiler over `calls` calls (after one warm-up call)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return by_key((e.name(), e.duration_ns() / 1e3 / calls) for e in raw_events(prof)
                  if on_device(e))


def by_key(times) -> dict[str, float]:
    """(profiler kernel name, device time) pairs summed by the name without
    `void`, anonymous namespaces and what follows the first parenthesis."""
    out: dict[str, float] = {}
    for name, t in times:
        key = name.replace("(anonymous namespace)::", "").removeprefix("void ").split("(")[0]
        out[key] = out.get(key, 0.0) + t
    return out


def rmsnorm_shapes() -> list[tuple[str, int, int]]:
    """(what, rows, D) at every shape the smoke paths launch rmsnorm at, and
    qwen3-14b's qk_norm over 8 x 128 tokens of 40 heads, which no smoke path
    runs."""
    from repro_torch.configs import get_config
    from repro_torch.models.model_zoo import batch_text_offset

    _, B, S, _ = DECODE_RUNS[1]
    _, xb, xs, _ = DECODE_RUNS[2]
    _, sb, ss, sn = DECODE_RUNS[3]
    llava, lb, ls, _ = DECODE_RUNS[4]
    patches = batch_text_offset(get_config(llava))
    return [("serve", BATCH * SEQ, 2560), ("stablelm-3b decode", DECODE_RUNS[0][1], 2560),
            ("zamba2-2.7b prefill", B * S, 2560),
            ("zamba2-2.7b prefill, Mamba2 gated norm", B * S, 5120),
            ("zamba2-2.7b decode", B, 2560), ("zamba2-2.7b decode, Mamba2 gated norm", B, 5120),
            ("xlstm-1.3b prefill", xb * xs, 2048), ("xlstm-1.3b prefill, mLSTM norm", xb * xs, 4096),
            ("xlstm-1.3b decode", xb, 2048), ("xlstm-1.3b decode, mLSTM norm", xb, 4096),
            ("seamless-m4t-large-v2 encoder", sb * ss, 1024),
            ("seamless-m4t-large-v2 teacher-forced decoder", sb * (sn + 1), 1024),
            ("seamless-m4t-large-v2 decode", sb, 1024),
            ("llava-next-34b prefill", lb * (patches + ls), 7168),
            ("llava-next-34b decode", lb, 7168)] + moe_rmsnorm_shapes() + [
            train_rows(), small_train_rows(),
            ("qwen3-14b qk_norm (no smoke path)", 8 * 128 * 40, 128)] + [
            (f"serve_pipeline example, batch {bs}", bs * seq, d_model)
            for bs, seq, d_model, _, _ in example_shapes()]


def example_shapes() -> list[tuple[int, int, int, int, int]]:
    """(batch, tokens a request, d_model, heads, head_dim) at which phase 8's
    `repro_torch.examples.serve_pipeline` runs its stages on the card: its
    reduced stablelm-3b at the smallest batch bucket and the largest its
    plans serve (the MILP's h100 pool at batch 16)."""
    from repro_torch.examples.serve_pipeline import REDUCED, SEQ

    d, h = REDUCED["d_model"], REDUCED["n_heads"]
    return [(bs, SEQ, d, h, d // h) for bs in (1, EXAMPLE_MAX_BATCH)]


def moe_rmsnorm_shapes() -> list[tuple[str, int, int]]:
    """The MoE runs' norms: the residual stream's in prefill and decode, and
    MLA's q_a_norm and kv_a_norm (q_lora_rank, kv_lora_rank wide)."""
    from repro_torch.configs import get_config

    out = []
    for arch, B, S, _ in DECODE_RUNS:
        cfg = get_config(arch)
        if cfg.family != "moe":
            continue
        widths = [("", cfg.d_model)]
        if cfg.mla:
            widths += [(", q_a_norm", cfg.q_lora_rank), (", kv_a_norm", cfg.kv_lora_rank)]
        for form, rows in (("prefill", B * S), ("decode", B)):
            out += [(f"{arch} {form}{what}", rows, D) for what, D in widths]
    return out


def check_rmsnorm(dev, g, err, parent) -> dict:
    """bf16 rows at every shape of `rmsnorm_shapes`, held to the plain
    version at `tol(bf16)` and bit-equal run to run, timed beside F.rms_norm.
    The line's times are the serve shape's; `shapes` holds all."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.rmsnorm import ops as rn
    from repro_torch.testing.parity import tol

    bf16 = torch.bfloat16
    shapes = []
    for what, N, D in rmsnorm_shapes():
        x = (torch.randn(N, D, generator=g, device=dev) * 3).to(bf16)
        w = torch.randn(D, generator=g, device=dev).to(bf16)
        got, again, want = rn.rmsnorm(x, w), rn.rmsnorm(x, w), rn.rmsnorm_plain(x, w)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, **tol(bf16))
        if not torch.equal(got, again):
            raise AssertionError(f"rmsnorm ({what}): two calls differ")
        b_ms, b_by = bound_ms(rn.rmsnorm_work(N, D, 2))
        ms, parent_ms = paired_ms(lambda m: m.rmsnorm(x, w), rn, parent)
        r = dict(
            shape=[N, D], what=what, plan=list(rn.launch_plan(D, 2)), max_abs_err=err(got, want),
            tol=tol(bf16), ms=ms, parent_ms=parent_ms,
            plain_ms=time_ms(lambda: rn.rmsnorm_plain(x, w)), bound_ms=b_ms, bound_by=b_by,
            library_ms=time_ms(lambda: F.rms_norm(x, (D,), w, 1e-5)),
            host_ms=host_ms(lambda: rn.rmsnorm(x, w)))
        log(f"[kernels] rmsnorm at the {what} shape ({N}, {D}) bf16, {r['plan'][0]} lanes x "
            f"{r['plan'][1]} vectors a row: {ms * 1e3:.3f} us{vs_parent(parent_ms)} vs bound "
            f"{b_ms * 1e3:.3f} us ({b_by}), F.rms_norm {r['library_ms'] * 1e3:.3f} us, plain "
            f"{r['plain_ms'] * 1e3:.3f} us; host {r['host_ms'] * 1e3:.3f} us a call; max|err| "
            f"{r['max_abs_err']:.3g}; bit-equal run to run")
        shapes.append(r)
    return dict(shapes[0], max_abs_err=max(r["max_abs_err"] for r in shapes), shapes=shapes)


def forward_plan_line(fa, dev, B, H, KH, Sq, Sk, D, Dv, causal) -> tuple[list, str]:
    """The bf16 forward's launch plan at these shapes (`forward_plan`),
    held to the source's (`fa_forward_plan`), and a few words of it."""
    from repro_torch.kernels import _lib

    plan = fa.forward_plan(B, H, KH, Sq, Sk, D, Dv, causal, _lib.sm_count(dev))
    on_card = fa.forward_plan_on_card(B, H, KH, Sq, Sk, D, Dv, causal)
    if on_card != plan.as_tuple():
        raise AssertionError(f"flash_attention bf16 ({B}, {Sq}, {Sk}, {H}/{KH}, {D}, {Dv}): "
                             f"the source launches {on_card}, its plan is {plan.as_tuple()}")
    return list(plan.as_tuple()), (
        f"plan ({plan.dp}, {plan.dvp}), {plan.keys}-key tiles, {plan.stages} stages, "
        f"{plan.smem} B, {plan.items} items on {plan.grid} blocks in chunks of {plan.chunk} "
        f"heads, {'overlapped' if plan.overlap else 'serial'}"
        f"{', turns' if plan.turns else ''}")


def check_flash_attention(dev, g, err, parent) -> dict:
    """In the model layout (B, T, H, D), as served, at both prefill shapes
    of the dense and hybrid paths: the serve's (8, 128, 32, 80) and
    zamba2-2.7b's (4, 512, 32, 80).  Each against its plain version and,
    bit for bit, the same inputs as contiguous (B, H, S, D) copies; timed
    hot L2 and cold (`time_ms(..., cold=True)`; the serve's 21 MB would
    sit in the 50 MB L2), under `--parent` each in turns with the other
    tree's, with SDPA's beside it; its launch plan printed.  Then the f32
    route (`check_flash_f32`) and both routes at the VLM's and the
    enc-dec's shapes (`check_flash_models`).  The line's times are the
    serve shape's; `shapes` holds every timed shape."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.testing.parity import attn_tol

    bf16, H, HD = torch.bfloat16, 32, 80
    shapes = []
    for what, B, S in (("serve", BATCH, SEQ), ("zamba2-2.7b prefill", *DECODE_RUNS[1][1:3])):
        q, k, v = (torch.randn(B, S, H, HD, generator=g, device=dev).to(bf16) for _ in range(3))
        qh, kh, vh = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
        got = fa.attention_bthd(q, k, v)
        want = fa.flash_attention_plain(qh, kh, vh).transpose(1, 2)
        bhsd = fa.flash_attention(qh.contiguous(), kh.contiguous(), vh.contiguous())
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, **attn_tol(bf16))
        torch.testing.assert_close(bhsd.transpose(1, 2), got, atol=0, rtol=0)
        b_ms, b_by = bound_ms(fa.flash_work(B, H, H, S, S, HD, HD, True, 2))
        ms, parent_ms = paired_ms(lambda m: m.attention_bthd(q, k, v), fa, parent)

        def sdpa():
            F.scaled_dot_product_attention(qh, kh, vh, is_causal=True)

        plan, plan_words = forward_plan_line(fa, dev, B, H, H, S, S, HD, HD, True)
        r = dict(
            shape=[B, S, H, HD], what=what, max_abs_err=err(got, want), tol=attn_tol(bf16),
            ms=ms, parent_ms=parent_ms,
            plain_ms=time_ms(lambda: fa.flash_attention_plain(qh, kh, vh)),
            bound_ms=b_ms, bound_by=b_by, library_ms=time_ms(sdpa),
            host_ms=host_ms(lambda: fa.attention_bthd(q, k, v)), plan=plan)
        r["cold_ms"], r["parent_cold_ms"] = paired_ms(
            lambda m: m.attention_bthd(q, k, v), fa, parent, iters=20, cold=True)
        r["library_cold_ms"] = time_ms(sdpa, iters=20, cold=True)
        cold = (f"; cold L2 {r['cold_ms'] * 1e3:.3f} us{vs_parent(r['parent_cold_ms'])}, "
                f"SDPA {r['library_cold_ms'] * 1e3:.3f} us")
        log(f"[kernels] flash_attention at the {what} shape (B, T, H, D) = ({B}, {S}, {H}, "
            f"{HD}): {ms * 1e3:.3f} us{vs_parent(parent_ms)} vs bound {b_ms * 1e3:.3f} us "
            f"({r['bound_by']}), plain {r['plain_ms'] * 1e3:.3f} us, SDPA "
            f"{r['library_ms'] * 1e3:.3f} us{cold}; host {r['host_ms'] * 1e3:.3f} us a call; "
            f"max|err| {r['max_abs_err']:.3g}; bit-equal to the (B, H, S, D) copies; "
            f"{plan_words}")
        shapes.append(r)
    shapes.append(check_flash_f32(dev, g, err, parent))
    shapes += check_flash_models(dev, g, err, parent)
    return dict(shapes[0], max_abs_err=max(r["max_abs_err"] for r in shapes), shapes=shapes)


# ------------------------------------------------- phase 2: backward kernels


def grad_shapes_rmsnorm() -> list[tuple[str, int, int]]:
    """(what, rows, D): the shapes phase 6 launches the backward at, one
    micro-batch a launch (qwen2-1.5b's 4 x 1024 tokens, 4096 rows of 1536;
    `train_small`'s 4 x 128 of 512), and the serve's, where no backward
    runs."""
    return [train_rows(), small_train_rows(), ("serve", BATCH * SEQ, 2560)]


def train_rows() -> tuple[str, int, int]:
    """(what, rows, D) of phase 6a's norms: one micro-batch of qwen2-1.5b."""
    from repro_torch.configs import get_config

    return (f"{TRAIN_ARCH} train", TRAIN_BATCH // TRAIN_ACCUM * TRAIN_SEQ,
            get_config(TRAIN_ARCH).d_model)


def small_train_rows() -> tuple[str, int, int]:
    """(what, rows, D) of phase 6c's norms: one micro-batch of `train_small`."""
    from repro_torch.examples.train_small import ACCUM, BATCH as B, SEQ as S, small_config

    return ("train_small train", B // ACCUM * S, small_config().d_model)


def grad_shapes_flash() -> list[tuple[str, int, int, int, int, int, int, int, bool]]:
    """(what, B, Sq, Sk, H, KH, D, Dv, causal): qwen2-1.5b's micro-batch
    (4, 1024, 12/2, 128), causal, a G = 1 shape, and `train_small`'s
    micro-batch (4, 128, 8/2, 64), which phase 6c's elastic pair launches;
    then seamless-m4t-large-v2's, as phase 6e trains it
    (`ENCDEC_TRAIN_TEXT` tokens over `TRAIN_SEQ` frames a sequence): its
    encoder (4, 1024, 16/16, 64) and its cross-attention (q of 256 rows over
    k and v of 1024), non-causal, and its decoder's self-attention (4, 256,
    16/16, 64), causal; a ragged non-causal (2, 33 over 1000, 8/2, 64); the
    causal Sq < Sk and Sq > Sk of `flash_model_shapes`; then
    deepseek-v3's MLA at a training micro-batch (4, 1024, 128/128, q and k
    192 wide, v 128), causal, as 6b trains it; 16 query heads a KV head (2,
    1024, 32/2, 128), causal; and q, k and v all 192 wide (2, 512, 8/2),
    non-causal, the two-stage dK/dV instance."""
    from repro_torch.configs import get_config
    from repro_torch.examples.train_small import ACCUM, BATCH as SB, SEQ as SS, small_config

    cfg, small, audio = get_config(TRAIN_ARCH), small_config(), get_config(ENCDEC_TRAIN_ARCH)
    mla = get_config(MLA_TRAIN_ARCH)
    mb = TRAIN_BATCH // TRAIN_ACCUM
    heads = (audio.n_heads, audio.kv_heads, audio.hd, audio.hd)
    return [(f"{TRAIN_ARCH} train", mb, TRAIN_SEQ, TRAIN_SEQ, cfg.n_heads, cfg.kv_heads, cfg.hd,
             cfg.hd, True),
            ("G = 1", 2, 1024, 1024, 8, 8, 128, 128, True),
            ("train_small train", SB // ACCUM, SS, SS, small.n_heads, small.kv_heads, small.hd,
             small.hd, True),
            (f"{ENCDEC_TRAIN_ARCH} encoder", mb, TRAIN_SEQ, TRAIN_SEQ, *heads, False),
            (f"{ENCDEC_TRAIN_ARCH} cross-attention", mb, ENCDEC_TRAIN_TEXT, TRAIN_SEQ, *heads,
             False),
            (f"{ENCDEC_TRAIN_ARCH} decoder", mb, ENCDEC_TRAIN_TEXT, ENCDEC_TRAIN_TEXT, *heads,
             True),
            ("ragged, non-causal", 2, 33, 1000, 8, 2, 64, 64, False)] + [
        (what, B, Sq, Sk, H, KH, D, Dv, causal)
        for what, B, Sq, Sk, H, KH, D, Dv, causal in flash_model_shapes()
        if Sq != Sk and causal] + [
        (f"{MLA_TRAIN_ARCH} MLA train", mb, TRAIN_SEQ, TRAIN_SEQ, mla.n_heads, mla.n_heads,
         mla.qk_nope_dim + mla.qk_rope_dim, mla.v_head_dim, True),
        ("G = 16", 2, 1024, 1024, 32, 2, 128, 128, True),
        ("D = Dv = 192", 2, 512, 512, 8, 2, 192, 192, False)]


def check_rmsnorm_backward(dev, g, parent) -> dict:
    """`rmsnorm_backward` at `grad_shapes_rmsnorm`: dx and dw against the
    plain backward run in f32 from the same bf16 inputs, each within
    GRAD_TOL of that result's max |value| (the plain backward in bf16,
    autograd through the plain forward, logged beside it); bit-equal run to
    run; timed (hot L2; under `--parent` in turns with the other tree's)
    beside its bound, the plain backward and F.rms_norm's backward, and at
    qwen2-1.5b's rows also with a cold L2 (`time_ms(cold=True)`), the
    library's too.  The line's numbers are the train shape's."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import _lib
    from repro_torch.kernels.rmsnorm import ops as rn
    from repro_torch.testing.parity import GRAD_TOL, assert_grad_close, grad_gap

    bf16 = torch.bfloat16
    shapes = []
    for what, N, D in grad_shapes_rmsnorm():
        x = (torch.randn(N, D, generator=g, device=dev) * 3).to(bf16)
        w = torch.randn(D, generator=g, device=dev).to(bf16)
        dy = torch.randn(N, D, generator=g, device=dev).to(bf16)
        got, again = rn.rmsnorm_backward(x, w, dy), rn.rmsnorm_backward(x, w, dy)
        want = rn.rmsnorm_backward_plain(x.float(), w.float(), dy.float())
        xr, wr = x.clone().requires_grad_(), w.clone().requires_grad_()
        plain_bf16 = torch.autograd.grad(rn.rmsnorm_plain(xr, wr), (xr, wr), dy)
        torch.cuda.synchronize()
        gaps = [assert_grad_close(a, b, f"rmsnorm_backward {n} ({what})")
                for n, a, b in zip(("dx", "dw"), got, want)]
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            raise AssertionError(f"rmsnorm_backward ({what}): two calls differ")
        plain_gaps = [grad_gap(a, b) for a, b in zip(plain_bf16, want)]
        yl = F.rms_norm(xr, (D,), wr, 1e-5)
        b_ms, b_by = bound_ms(rn.rmsnorm_backward_work(N, D, 2))
        lanes, vpt, threads = rn.backward_shape(D, 2)
        plan = rn.backward_plan(N, D, 2, _lib.sm_count(dev.index), rn.backward_blocks_per_sm(
            D, _lib.dtype_code(x), lanes, vpt, int(rn.vector_loads(x, w, x)), threads, dev.index))
        ms, parent_ms = paired_ms(lambda m: m.rmsnorm_backward(x, w, dy), rn, parent)

        def lib_call():
            torch.autograd.grad(yl, (xr, wr), dy, retain_graph=True)

        r = dict(shape=[N, D], what=what, max_abs_err=max(gaps), tol=GRAD_TOL,
                 ms=ms, parent_ms=parent_ms,
                 # ten calls: fifty of these chains of small kernels would fill
                 # the launch queue behind the device sleep
                 plain_ms=time_ms(lambda: rn.rmsnorm_backward_plain(x, w, dy), iters=10,
                                  warmup=2),
                 bound_ms=b_ms, bound_by=b_by, library_ms=time_ms(lib_call, iters=10),
                 host_ms=host_ms(lambda: rn.rmsnorm_backward(x, w, dy)),
                 plan=list(plan))
        cold = ""
        if what == train_rows()[0]:
            r.update(cold_ms=time_ms(lambda: rn.rmsnorm_backward(x, w, dy), iters=20, cold=True),
                     library_cold_ms=time_ms(lib_call, iters=10, cold=True))
            cold = (f"; cold L2 {r['cold_ms'] * 1e3:.3f} us, F.rms_norm backward "
                    f"{r['library_cold_ms'] * 1e3:.3f} us")
        log(f"[kernels] rmsnorm_backward at the {what} shape ({N}, {D}) bf16, one cooperative "
            f"launch of {plan.grid} blocks of {plan.threads} threads, {plan.lanes} lanes x "
            f"{plan.vectors} vectors a row, {plan.partial_rows} dw partial rows: "
            f"{ms * 1e3:.3f} us{vs_parent(parent_ms)} vs bound {b_ms * 1e3:.3f} us ({b_by}), "
            f"F.rms_norm backward {r['library_ms'] * 1e3:.3f} us, plain "
            f"{r['plain_ms'] * 1e3:.3f} us (hot L2){cold}; host {r['host_ms'] * 1e3:.3f} us a "
            f"call; dx, dw within {gaps[0]:.3g}, {gaps[1]:.3g} of the f32 plain backward's max "
            f"|value| (tol {GRAD_TOL}; the plain backward in bf16: {plain_gaps[0]:.3g}, "
            f"{plain_gaps[1]:.3g}); bit-equal run to run")
        shapes.append(r)
        del x, w, dy, got, again, want, xr, wr, plain_bf16, yl
    return dict(shapes[0], max_abs_err=max(r["max_abs_err"] for r in shapes), shapes=shapes)


def replays_equal(call, eager: list) -> bool:
    """`call(outs)` captured in a CUDA graph, writing into buffers filled
    with NaN, and replayed once: its outputs equal to `eager`, the eager
    call's, bit for bit."""
    import torch

    outs = [torch.full_like(t, float("nan")) for t in eager]
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        call(outs)
    graph.replay()
    torch.cuda.synchronize()
    equal = all(torch.equal(a, b) for a, b in zip(outs, eager))
    del graph
    return equal


def check_flash_backward(dev, g, parent) -> tuple[dict, dict]:
    """At `grad_shapes_flash`, bf16, causal (top-left) or not, Sq and Sk of
    their own, v (and o, dout, dv) Dv <= D wide: the LSE forward's output
    (v at its own width, as `_FlashFn` hands it) equals `fa_forward`'s bit
    for bit and its lse the plain one; dq, dk and dv, written over NaN,
    against the plain backward run in f32, each within GRAD_TOL of that
    result's max |value| (autograd through the plain forward in bf16
    logged beside it); bit-equal run to run, and a CUDA graph's replay
    bit-equal to the eager call.  The LSE forward is timed (hot and cold
    L2) beside `fa_forward` at the same inputs and, under `--parent`, in turns with
    the other tree's (which takes v padded to D where it is narrower, as
    that tree's `_FlashFn` pads it), with its launch plan; the backward (three launches) beside
    its bound (five products over the pairs the mask keeps, `flash_pairs`:
    S^T, dK and dQ D wide, dP^T and dV Dv wide), the plain backward, SDPA's
    backward (`is_causal` as the row, enable_gqa, v at its own width) and,
    under `--parent`, the other tree's backward in turns at the causal Sq
    == Sk rows an older tree takes (D == Dv <= 128, at most 8 query heads
    a KV head); one call's device time is split by launch (Delta, dK/dV,
    dQ) from the profiler, and the achieved rate read against the bound's
    five products.  Returns the rows of both entries, the train shape's
    first."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.testing.parity import GRAD_TOL, assert_grad_close, flash_grads_f32, grad_gap

    bf16 = torch.bfloat16
    fwd, bwd = [], []
    for what, B, Sq, Sk, H, KH, D, Dv, causal in grad_shapes_flash():
        q = torch.randn(B, H, Sq, D, generator=g, device=dev).to(bf16)
        dout = torch.randn(B, H, Sq, Dv, generator=g, device=dev).to(bf16)
        k = torch.randn(B, KH, Sk, D, generator=g, device=dev).to(bf16)
        v = torch.randn(B, KH, Sk, Dv, generator=g, device=dev).to(bf16)
        vf = F.pad(v, (0, D - Dv))  # v as an older tree's `_FlashFn` pads it
        scale = D ** -0.5
        o = torch.empty_like(dout)
        lse = fa.flash_attention_forward_lse(q, k, v, o, scale, causal)
        direct = torch.empty_like(o)
        fa._launch(q, k, v, direct, causal, scale)
        grads = [torch.full_like(t, float("nan")) for t in (q, k, v)]
        again = [torch.full_like(t, float("nan")) for t in (q, k, v)]
        fa.flash_attention_backward(q, k, v, o, dout, lse, *grads, scale, causal)
        fa.flash_attention_backward(q, k, v, o, dout, lse, *again, scale, causal)
        want = flash_grads_f32(q, k, v, dout, causal)
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        plain_bf16 = torch.autograd.grad(fa.flash_attention_plain(
            leaves[0], leaves[1], F.pad(leaves[2], (0, D - Dv)), causal)[..., :Dv], leaves, dout)
        torch.cuda.synchronize()
        if not torch.equal(o, direct):
            raise AssertionError(f"flash_attention_forward_lse ({what}): output differs from "
                                 f"fa_forward's")
        lse_err = float((lse - fa.flash_attention_lse_plain(q, k, causal=causal)).abs().max())
        if lse_err > 1e-3:
            raise AssertionError(f"flash_attention_forward_lse ({what}): lse off by {lse_err}")
        gaps = [assert_grad_close(a, b, f"flash_attention_backward {n} ({what})")
                for n, a, b in zip(("dq", "dk", "dv"), grads, want)]
        if not all(torch.equal(a, b) for a, b in zip(grads, again)):
            raise AssertionError(f"flash_attention_backward ({what}): two calls differ")
        if not replays_equal(lambda outs: fa.flash_attention_backward(
                q, k, v, o, dout, lse, *outs, scale, causal), grads):
            raise AssertionError(f"flash_attention_backward ({what}): a CUDA graph's replay "
                                 f"differs from the eager call")
        plain_gaps = [grad_gap(a, b) for a, b in zip(plain_bf16, want)]
        del want, again, plain_bf16, leaves
        pairs = B * H * fa.flash_pairs(Sq, Sk, causal)
        f_ms, f_by = bound_ms(fa.forward_lse_work(B, H, KH, Sq, Sk, D, Dv, causal))
        b_ms, b_by = bound_ms(fa.backward_work(B, H, KH, Sq, Sk, D, Dv, causal))
        ql, kl, vl = (t.clone().requires_grad_() for t in (q, k, v))
        out = F.scaled_dot_product_attention(ql, kl, vl, is_causal=causal,
                                             enable_gqa=H != KH)
        of = torch.empty_like(q)  # an older tree's D-wide output

        def lse_call(m):
            if m is fa or Dv == D:
                m.flash_attention_forward_lse(q, k, v, o, scale, causal)
            else:
                m.flash_attention_forward_lse(q, k, vf, of, scale, causal)

        lse_ms, lse_parent_ms = paired_ms(lse_call, fa, parent, iters=20)
        lse_cold_ms, lse_parent_cold_ms = paired_ms(lse_call, fa, parent, iters=20, cold=True)
        fwd_ms = time_ms(lambda: fa._launch(q, k, v, direct, causal, scale), iters=20)
        plan, plan_words = forward_plan_line(fa, dev, B, H, KH, Sq, Sk, D, Dv, causal)
        fwd.append(dict(
            shape=[B, Sq, Sk, H, KH, D, Dv], causal=causal, what=what, max_abs_err=lse_err,
            tol=1e-3, ms=lse_ms, parent_ms=lse_parent_ms, cold_ms=lse_cold_ms,
            parent_cold_ms=lse_parent_cold_ms, fa_forward_ms=fwd_ms, plan=plan,
            plain_ms=time_ms(lambda: (fa.flash_attention_plain(q, k, vf, causal),
                                      fa.flash_attention_lse_plain(q, k, causal=causal)),
                             iters=5, warmup=1),
            bound_ms=f_ms, bound_by=f_by,
            library_ms=time_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=causal, enable_gqa=H != KH), iters=20),
            host_ms=host_ms(lambda: fa.flash_attention_forward_lse(q, k, v, o, scale, causal),
                            calls=100)))

        def b_call(m):
            if m is fa:
                m.flash_attention_backward(q, k, v, o, dout, lse, *grads, scale, causal)
            else:  # the other tree's: causal, Sq == Sk
                m.flash_attention_backward(q, k, v, o, dout, lse, *grads, scale)

        older = causal and Sq == Sk and D == Dv <= 128 and H // KH <= 8  # an older tree's route
        ms, parent_ms = paired_ms(b_call, fa, parent if older else None, iters=10)
        split = kernel_us(lambda: b_call(fa))
        launch_us = {part: sum(us for name, us in split.items() if name.startswith(prefix))
                     for part, prefix in (("delta", "fa_bwd_delta"), ("dkdv", "fa_bwd_dkdv"),
                                          ("dq", "fa_bwd_dq"))}
        bwd.append(dict(
            shape=[B, Sq, Sk, H, KH, D, Dv], causal=causal, what=what, max_abs_err=max(gaps),
            tol=GRAD_TOL, ms=ms, parent_ms=parent_ms, launch_us=launch_us,
            tflops=2.0 * pairs * (3 * D + 2 * Dv) / (ms * 1e-3) / 1e12,
            plain_ms=time_ms(lambda: fa.flash_attention_backward_plain(
                q, k, v, o, dout, lse, causal=causal), iters=3, warmup=1),
            bound_ms=b_ms, bound_by=b_by,
            library_ms=time_ms(lambda: torch.autograd.grad(out, (ql, kl, vl), dout,
                                                           retain_graph=True), iters=10),
            host_ms=host_ms(lambda: b_call(fa), calls=20)))
        mask = "causal" if causal else "non-causal"
        log(f"[kernels] flash_attention_forward_lse at the {what} shape (B, Sq, Sk, H/KH, D, "
            f"Dv) = ({B}, {Sq}, {Sk}, {H}/{KH}, {D}, {Dv}) {mask} bf16: {lse_ms * 1e3:.3f} us"
            f"{vs_parent(lse_parent_ms)} (cold L2 {lse_cold_ms * 1e3:.3f} us"
            f"{vs_parent(lse_parent_cold_ms)}) against "
            f"fa_forward's {fwd_ms * 1e3:.3f} us at the same inputs, bound {f_ms * 1e3:.3f} us "
            f"({f_by}), SDPA {fwd[-1]['library_ms'] * 1e3:.3f} us; output bit-equal to "
            f"fa_forward's, lse within {lse_err:.3g} of the plain one; {plan_words}")
        at_once = fa._clusters_at_once(H // KH, D, dev.index, Dv)
        plan = fa.backward_plan(B, H, KH, Sq, Sk, D, torch.cuda.get_device_properties(
            dev).multi_processor_count, at_once, causal)
        heads = fa.backward_heads(B, H, KH, Sq, Sk, D, causal, Dv)
        if heads != plan.heads:
            raise AssertionError(f"flash_attention_backward ({what}): the launch walks "
                                 f"{heads} heads a block, its plan {plan.heads}")
        bwd[-1].update(heads=plan.heads, cluster=plan.cluster, clusters_at_once=dict(at_once))
        log(f"[kernels] flash_attention_backward at the {what} shape ({mask}): "
            f"{ms * 1e3:.3f} us{vs_parent(parent_ms)} (dK/dV: {math.prod(plan.dkdv_grid)} "
            f"blocks of {plan.heads} heads, clusters of {plan.cluster}; the card holds "
            f"{dict(at_once)} clusters of C at once; one call's launches: Delta "
            f"{launch_us['delta']:.3f}, dK/dV {launch_us['dkdv']:.3f}, dQ "
            f"{launch_us['dq']:.3f} us), {bwd[-1]['tflops']:.1f} TFLOP/s of the bound's five "
            f"products ({bwd[-1]['tflops'] / (BF16_FLOP_S / 1e12):.3f} of the peak) vs bound "
            f"{b_ms * 1e3:.3f} us ({b_by}), SDPA backward {bwd[-1]['library_ms'] * 1e3:.3f} us, "
            f"plain {bwd[-1]['plain_ms'] * 1e3:.3f} us; host {bwd[-1]['host_ms'] * 1e3:.3f} us a "
            f"call; dq, dk, dv within {gaps[0]:.3g}, {gaps[1]:.3g}, {gaps[2]:.3g} of the f32 "
            f"plain backward's max |value| (tol {GRAD_TOL}; autograd of the plain forward in "
            f"bf16: {plain_gaps[0]:.3g}, {plain_gaps[1]:.3g}, {plain_gaps[2]:.3g}); bit-equal "
            f"run to run and in a graph's replay")
        del q, k, v, vf, of, o, direct, dout, lse, grads, ql, kl, vl, out
        torch.cuda.empty_cache()
    return (dict(fwd[0], max_abs_err=max(r["max_abs_err"] for r in fwd), shapes=fwd),
            dict(bwd[0], max_abs_err=max(r["max_abs_err"] for r in bwd), shapes=bwd))


# (B, H, KH, S, D) of tests/test_kernels.py's flash attention sweep
FLASH_F32_SHAPES = ((2, 4, 2, 256, 64), (1, 8, 8, 128, 128), (2, 6, 2, 384, 128),
                    (1, 2, 1, 512, 64))


def check_flash_f32(dev, g, err, parent) -> dict:
    """The f32 route (CUDA-core FMAs): held to the plain version in f32
    (TF32 off) at 3e-5, tests/test_kernels.py's f32 bound, at that file's
    four shapes and non-causal at (1, 4, 256, 64), with bf16 non-causal at
    `attn_tol`; then timed in the model layout at the serve shape (8, 128,
    32, 80), the shape phase 5's f32 witness prefills stablelm-3b at (hot
    L2, under `--parent` in turns with the other tree's; and with a cold
    L2, SDPA's too), with its launch plan against the source's.  Returns
    the shapes entry of that time."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.testing.parity import attn_tol, tol

    f32 = torch.float32
    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("TF32 is on: the plain f32 version would not be an f32 oracle")
    worst = 0.0
    cases = [(shape, True, f32) for shape in FLASH_F32_SHAPES]
    cases += [((1, 4, 4, 256, 64), False, f32), ((1, 4, 4, 256, 64), False, torch.bfloat16)]
    for (B, H, KH, S, D), causal, dtype in cases:
        q = torch.randn(B, H, S, D, generator=g, device=dev).to(dtype)
        k, v = (torch.randn(B, KH, S, D, generator=g, device=dev).to(dtype) for _ in range(2))
        got = fa.flash_attention(q, k, v, causal=causal)
        want = fa.flash_attention_plain(q, k, v, causal=causal)
        torch.cuda.synchronize()
        bound = tol(dtype) if dtype == f32 else attn_tol(dtype)
        torch.testing.assert_close(got, want, **bound)
        if dtype == f32:
            worst = max(worst, err(got, want))
        log(f"[kernels] flash_attention {'f32' if dtype == f32 else 'bf16'} "
            f"{'causal' if causal else 'non-causal'} (B, H, KH, S, D) = ({B}, {H}, {KH}, {S}, "
            f"{D}): max|err| {err(got, want):.3g} (tol {bound})")
    B, S, H, HD = BATCH, SEQ, 32, 80
    q, k, v = (torch.randn(B, S, H, HD, generator=g, device=dev) for _ in range(3))
    qh, kh, vh = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    got = fa.attention_bthd(q, k, v)
    want = fa.flash_attention_plain(qh, kh, vh).transpose(1, 2)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, **tol(f32))
    worst = max(worst, err(got, want))
    plan = fa.f32_plan(S, HD, HD)
    if fa.f32_plan_on_card(S, HD, HD) != (plan.rows, plan.keys, plan.stages, plan.smem,
                                          plan.v_chunks):
        raise AssertionError(f"flash_attention f32: the source launches "
                             f"{fa.f32_plan_on_card(S, HD, HD)}, its plan is {plan}")
    b_ms, b_by = bound_ms(fa.flash_work(B, H, H, S, S, HD, HD, True, 4))
    ms, parent_ms = paired_ms(lambda m: m.attention_bthd(q, k, v), fa, parent)

    def sdpa():
        F.scaled_dot_product_attention(qh, kh, vh, is_causal=True)

    r = dict(
        shape=[B, S, H, HD], what="serve shape in f32 (phase 5's f32 witness)", dtype="f32",
        max_abs_err=worst, tol=tol(f32), ms=ms, parent_ms=parent_ms,
        cold_ms=time_ms(lambda: fa.attention_bthd(q, k, v), iters=20, cold=True),
        plain_ms=time_ms(lambda: fa.flash_attention_plain(qh, kh, vh)),
        bound_ms=b_ms, bound_by=b_by, library_ms=time_ms(sdpa),
        library_cold_ms=time_ms(sdpa, iters=20, cold=True),
        host_ms=host_ms(lambda: fa.attention_bthd(q, k, v)),
        plan=[plan.rows, plan.keys, plan.stages, plan.smem, plan.v_chunks])
    log(f"[kernels] flash_attention f32 at the serve shape (B, T, H, D) = ({B}, {S}, {H}, "
        f"{HD}), {plan.rows} rows a block, {plan.keys}-key tiles, {plan.smem} B of shared "
        f"memory: {ms * 1e3:.3f} us{vs_parent(parent_ms)} vs bound {b_ms * 1e3:.3f} us "
        f"({b_by}), plain {r['plain_ms'] * 1e3:.3f} us, SDPA f32 {r['library_ms'] * 1e3:.3f} us "
        f"(hot L2); cold L2 {r['cold_ms'] * 1e3:.3f} us, SDPA f32 "
        f"{r['library_cold_ms'] * 1e3:.3f} us; host {r['host_ms'] * 1e3:.3f} us a call; worst "
        f"f32 max|err| {worst:.3g} (tol {tol(f32)})")
    return r


def decode_shapes() -> list[tuple[str, int, int, int, int, int]]:
    """(what, B, cache length, query heads, KV heads, head_dim) of every
    decode attention phase 5's runs launch (the enc-dec's self- and
    cross-attention; llama4's G = 5; not deepseek-v3's absorbed MLA), then
    qwen3-14b's one sequence over a 4096-key cache, which no smoke path
    runs."""
    from repro_torch.configs import get_config
    from repro_torch.models.model_zoo import batch_text_offset

    out = []
    for arch, B, S, n in DECODE_RUNS:
        cfg = get_config(arch)
        if (cfg.ssm_pattern and "a" not in cfg.ssm_pattern) or cfg.mla:
            continue  # no attention layer, or MLA's absorbed decode (einsums)
        heads = (cfg.n_heads, cfg.kv_heads, cfg.hd)
        if cfg.family == "audio":
            out += [(f"{arch} self-attention", B, 1 + n, *heads),
                    (f"{arch} cross-attention", B, S, *heads)]
        else:
            what = arch + (" (split path)" if cfg.family == "vlm" else "")
            out.append((what, B, batch_text_offset(cfg) + S + n, *heads))
    return out + [("qwen3-14b, one sequence (split path, no smoke path)", 1, 4096, 40, 8, 128)]


def flash_model_shapes() -> list[tuple]:
    """(what, B, Sq, Sk, H, KH, D, Dv, causal) of the flash attention the
    VLM, enc-dec and MoE runs of phase 5 launch, with their configs' heads,
    and a causal Sq != Sk either way: seamless-m4t-large-v2's encoder
    (non-causal) and its teacher-forced decoder's cross-attention (the
    serving invariant's [bos] + the steps' tokens over the frames),
    llava-next-34b's prefill (G = 7, D = 128, patches + text tokens, no
    multiple of the kernel's 128-row item), llama4-maverick-400b-a17b's
    (G = 5) and deepseek-v3's MLA prefill (128 heads of q and k at
    qk_nope + qk_rope = 192, v at 128); then phase 8's serve_pipeline
    example's prefill at its two batches (`example_shapes`: 32 tokens, 4
    heads of 64, causal)."""
    from repro_torch.configs import get_config
    from repro_torch.models.model_zoo import batch_text_offset

    out = []
    for arch, B, S, n in DECODE_RUNS:
        cfg = get_config(arch)
        heads = (cfg.n_heads, cfg.kv_heads, cfg.hd, cfg.hd)
        if cfg.family == "audio":
            out += [(f"{arch} encoder", B, S, S, *heads, False),
                    (f"{arch} cross-attention", B, n + 1, S, *heads, False)]
        elif cfg.family == "vlm":
            T = batch_text_offset(cfg) + S
            out.append((f"{arch} prefill", B, T, T, *heads, True))
        elif cfg.mla:
            out.append((f"{arch} MLA prefill", B, S, S, cfg.n_heads, cfg.n_heads,
                        cfg.qk_nope_dim + cfg.qk_rope_dim, cfg.v_head_dim, True))
        elif cfg.family == "moe":
            out.append((f"{arch} prefill", B, S, S, *heads, True))
    return out + [("causal, Sq < Sk", 2, 300, 1000, 16, 4, 128, 128, True),
                  ("causal, Sq > Sk", 2, 1000, 300, 16, 4, 64, 64, True)] + [
        (f"serve_pipeline example, batch {bs}", bs, seq, seq, h, h, hd, hd, True)
        for bs, seq, _, h, hd in example_shapes()]


def check_flash_models(dev, g, err, parent) -> list[dict]:
    """Flash attention at `flash_model_shapes` in the model layout, bf16 and
    f32 (TF32 off), each against its plain version (bf16 at `attn_tol`; f32
    at 3e-5) and bit-equal to the (B, H, S, D) copies, and each timed
    beside its bound, its plain version and SDPA (top-left causal, as
    `is_causal` aligns it), under `--parent` in turns with the other
    tree's; the bf16 rows also cold (`time_ms(..., cold=True)`, in turns
    likewise) and with their launch plan.  Where v is narrower than
    q and k (MLA), both kernels read it as it is (an older tree's bf16
    wrapper pads it inside the timed call); the plain version and the (B,
    H, S, D) copy take it padded, the copy bit-equal all the same (each
    output column is the same sum whatever v's width), and SDPA takes it as
    it is (its value head_dim Ev may differ from q's)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.testing.parity import attn_tol, tol

    out = []
    for what, B, Sq, Sk, H, KH, D, Dv, causal in flash_model_shapes():
        for dtype in (torch.bfloat16, torch.float32):
            name = "bf16" if dtype == torch.bfloat16 else "f32"
            q = torch.randn(B, Sq, H, D, generator=g, device=dev).to(dtype)
            k = torch.randn(B, Sk, KH, D, generator=g, device=dev).to(dtype)
            v = torch.randn(B, Sk, KH, Dv, generator=g, device=dev).to(dtype)
            qh, kh, vh = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
            vp = F.pad(vh, (0, D - Dv))  # v padded, for the plain version and the copy
            before = fa.flash_attention.launches
            got = fa.attention_bthd(q, k, v, causal=causal)
            if fa.flash_attention.launches != before + 1:
                raise AssertionError(f"flash_attention {name} ({what}): "
                                     f"{fa.flash_attention.launches - before} launches a call")
            want = fa.flash_attention_plain(qh, kh, vp, causal=causal)[..., :Dv].transpose(1, 2)
            bhsd = fa.flash_attention(qh.contiguous(), kh.contiguous(), vp.contiguous(),
                                      causal=causal)[..., :Dv]
            torch.cuda.synchronize()
            bound = attn_tol(dtype) if dtype == torch.bfloat16 else tol(dtype)
            torch.testing.assert_close(got, want, **bound)
            torch.testing.assert_close(bhsd.transpose(1, 2), got, atol=0, rtol=0)
            b_ms, b_by = bound_ms(fa.flash_work(B, H, KH, Sq, Sk, D, Dv, causal,
                                                q.element_size()))
            gqa = {"enable_gqa": True} if H != KH else {}
            iters = 50 if B * H * Sq * Sk < 2 ** 28 else 10
            ms, parent_ms = paired_ms(lambda m: m.attention_bthd(q, k, v, causal=causal), fa,
                                      parent, iters=iters)
            plan, plan_words = (None, "") if dtype == torch.float32 else forward_plan_line(
                fa, dev, B, H, KH, Sq, Sk, D, Dv, causal)
            r = dict(
                shape=[B, Sq, Sk, H, KH, D, Dv], what=what, dtype=name, causal=causal,
                max_abs_err=err(got, want), tol=bound, ms=ms, parent_ms=parent_ms,
                plain_ms=time_ms(lambda: fa.flash_attention_plain(qh, kh, vp, causal=causal),
                                 iters=min(iters, 10), warmup=2),
                bound_ms=b_ms, bound_by=b_by,
                library_ms=time_ms(lambda: F.scaled_dot_product_attention(
                    qh, kh, vh, is_causal=causal, **gqa), iters=iters),
                host_ms=host_ms(lambda: fa.attention_bthd(q, k, v, causal=causal), calls=100),
                plan=plan)
            cold = ""
            if dtype == torch.bfloat16:
                r["cold_ms"], r["parent_cold_ms"] = paired_ms(
                    lambda m: m.attention_bthd(q, k, v, causal=causal), fa, parent,
                    iters=min(iters, 20), cold=True)
                cold = f"; cold L2 {r['cold_ms'] * 1e3:.3f} us{vs_parent(r['parent_cold_ms'])}"
            log(f"[kernels] flash_attention {name} at the {what} shape q ({B}, {Sq}, {H}, {D}), "
                f"k ({B}, {Sk}, {KH}, {D}), v ({B}, {Sk}, {KH}, {Dv}), "
                f"{'causal' if causal else 'non-causal'}: "
                f"{r['ms'] * 1e3:.3f} us{vs_parent(parent_ms)} vs bound {b_ms * 1e3:.3f} us "
                f"({b_by}){cold}, plain "
                f"{r['plain_ms'] * 1e3:.3f} us, SDPA {r['library_ms'] * 1e3:.3f} us; host "
                f"{r['host_ms'] * 1e3:.3f} us a call; max|err| {r['max_abs_err']:.3g} (tol "
                f"{bound}); one launch a call; bit-equal to the (B, H, S, D) copies"
                + (f"; {plan_words}" if plan_words else ""))
            out.append(r)
            del q, k, v, qh, kh, vh, vp, got, want, bhsd
    return out


def check_decode_attention(dev, g, err, parent) -> dict:
    """At every decode shape of phase 5 (`decode_shapes`: llava-next-34b's
    and qwen3-14b's take the split path), with kv_len = the full cache read
    from a device int32; garbage at and past kv_len must not change the
    output, and two calls must agree bit for bit; the f32 route at the same
    shape at 3e-5.  The line's times are those at the stablelm-3b shape;
    `shapes` holds all, each with the time of one split beside
    `split_plan`'s choice where that splits."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.decode_attention import ops as da
    from repro_torch.testing.parity import attn_tol, tol

    bf16 = torch.bfloat16
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    shapes = []
    for what, B, L, H, KH, HD in decode_shapes():
        q = torch.randn(B, 1, H, HD, generator=g, device=dev).to(bf16)
        kc, vc = (torch.randn(B, L, KH, HD, generator=g, device=dev).to(bf16) for _ in range(2))
        lens = torch.tensor(L, dtype=torch.int32, device=dev)
        got, want = da.decode_attention_bthd(q, kc, vc, lens), da.decode_attention_plain(
            q, kc, vc, lens)
        again = da.decode_attention_bthd(q, kc, vc, lens)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, **attn_tol(bf16))
        if not torch.equal(got, again):
            raise AssertionError(f"decode_attention ({what} shape): two calls differ")
        short = torch.tensor(L - 37, dtype=torch.int32, device=dev)
        before = da.decode_attention_bthd(q, kc, vc, short)
        kg, vg = kc.clone(), vc.clone()
        kg[:, L - 37:], vg[:, L - 37:] = 1e4, -1e4
        after = da.decode_attention_bthd(q, kg, vg, short)
        torch.cuda.synchronize()
        if not torch.equal(before, after):
            raise AssertionError(f"decode_attention ({what} shape): values past kv_len leak "
                                 f"into the output ({err(before, after):.3g})")
        q32, k32, v32 = q.float(), kc.float(), vc.float()
        got32 = da.decode_attention_bthd(q32, k32, v32, lens)
        want32 = da.decode_attention_plain(q32, k32, v32, lens)
        torch.cuda.synchronize()
        torch.testing.assert_close(got32, want32, **tol(torch.float32))
        qh, kh, vh = q.transpose(1, 2), kc.transpose(1, 2), vc.transpose(1, 2)
        gqa = {"enable_gqa": True} if H != KH else {}
        b_ms, b_by = bound_ms(da.decode_work(B, H, KH, L, HD, 2))
        plan = da.split_plan(B, KH, L, n_sm)
        ms, parent_ms = paired_ms(lambda m: m.decode_attention_bthd(q, kc, vc, lens), da, parent)
        r = dict(
            shape=[B, L, H, KH, HD], what=what, splits=list(plan), max_abs_err=err(got, want),
            tol=attn_tol(bf16), ms=ms, parent_ms=parent_ms,
            plain_ms=time_ms(lambda: da.decode_attention_plain(q, kc, vc, lens)),
            bound_ms=b_ms, bound_by=b_by,
            library_ms=time_ms(lambda: F.scaled_dot_product_attention(qh, kh, vh, **gqa)),
            host_ms=host_ms(lambda: da.decode_attention_bthd(q, kc, vc, lens)))
        note = ""
        if plan[0] > 1:  # the split path against one split of the same block shape
            one = (1, L, plan[2])
            r["one_split_ms"] = time_ms(
                lambda: da.decode_attention_bthd(q, kc, vc, lens, plan=one))
            note = f"; one split {r['one_split_ms'] * 1e3:.3f} us"
        log(f"[kernels] decode_attention at the {what} shape q ({B}, 1, {H}, {HD}), cache "
            f"({B}, {L}, {KH}, {HD}), {plan[0]} split(s) of {plan[1]} keys, "
            f"{da.RINGS[plan[2]]}: "
            f"{ms * 1e3:.3f} us{vs_parent(parent_ms)} vs bound {b_ms * 1e3:.3f} us, plain "
            f"{r['plain_ms'] * 1e3:.3f} us, SDPA {r['library_ms'] * 1e3:.3f} us{note}; host "
            f"{r['host_ms'] * 1e3:.3f} us a call; max|err| {r['max_abs_err']:.3g}; "
            f"bit-equal run to run; tail past kv_len masked; f32 max|err| "
            f"{err(got32, want32):.3g} (tol {tol(torch.float32)})")
        shapes.append(r)
    return dict(shapes[0], max_abs_err=max(r["max_abs_err"] for r in shapes), shapes=shapes)


def check_ssd_scan(dev, g, err, parent) -> dict:
    """zamba2-2.7b's Mamba2 scan: q and k one (B, T, 64) tensor broadcast over
    80 heads (head stride 0), v (B, T, 80, 64), chunk 256.  Held to the plain
    version in f32 (atol 5e-4, rtol 2e-3, tests/test_kernels.py's SSD bound)
    on y and the final state at T = 512 and at a ragged T = 300, with q and
    k broadcast or per head, with and without log_i, with gates log_g =
    -0.05 softplus(N(0, 1)) so that a 256-step chunk decays by about e^-9
    and the carried state matters; then in bf16, the model's dtype (y at
    `tol(bf16)`, the state at the f32 bound, two calls bit-equal), and
    timed there.  Then the mLSTM's scan at xlstm-1.3b's prefill
    (`check_ssd_wide`).  The line's numbers are the Mamba2 bf16 shape's;
    `shapes` holds every timed shape."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.ssd_scan import ops as ssd
    from repro_torch.testing.parity import tol

    _, B, S, _ = DECODE_RUNS[1]
    NH, DS, HD, chunk = 80, 64, 64, 256
    tol_f32 = dict(atol=5e-4, rtol=2e-3)

    def inputs(T, dtype, broadcast=True, with_i=False):
        shape = (B, T, DS) if broadcast else (B, T, NH, DS)
        c, bm = ((torch.randn(*shape, generator=g, device=dev) * 0.5).to(dtype)
                 for _ in range(2))
        if broadcast:
            c, bm = c[:, :, None].expand(B, T, NH, DS), bm[:, :, None].expand(B, T, NH, DS)
        v = (torch.randn(B, T, NH, HD, generator=g, device=dev) * 0.5).to(dtype)
        log_g = -0.05 * F.softplus(torch.randn(B, T, NH, generator=g, device=dev))
        log_i = (-F.softplus(torch.randn(B, T, NH, generator=g, device=dev)) if with_i
                 else None)
        return c, bm, v, log_g, log_i

    worst = 0.0
    for T in (S, 300):
        for broadcast in (True, False):
            for with_i in (False, True):
                args = inputs(T, torch.float32, broadcast, with_i)
                (y, st), (y0, st0) = (ssd.ssd_scan_bthd(*args, chunk=chunk),
                                      ssd.chunked_linear_attention_plain(*args, chunk=chunk))
                torch.cuda.synchronize()
                torch.testing.assert_close(y, y0, **tol_f32)
                torch.testing.assert_close(st, st0, **tol_f32)
                worst = max(worst, err(y, y0), err(st, st0))
                log(f"[kernels] ssd_scan f32 T={T}, q/k "
                    f"{'broadcast' if broadcast else 'per head'}, "
                    f"{'with' if with_i else 'no'} log_i: y max|err| {err(y, y0):.3g} at scale "
                    f"{float(y0.abs().max()):.3g}, state max|err| {err(st, st0):.3g} at scale "
                    f"{float(st0.abs().max()):.3g} (tol atol 5e-4, rtol 2e-3)")
    args = inputs(S, torch.bfloat16)[:4]
    y, st = ssd.ssd_scan_bthd(*args, chunk=chunk)
    y1, st1 = ssd.ssd_scan_bthd(*args, chunk=chunk)
    y0, st0 = ssd.chunked_linear_attention_plain(*args, chunk=chunk)
    torch.cuda.synchronize()
    torch.testing.assert_close(y, y0, **tol(torch.bfloat16))
    torch.testing.assert_close(st, st0, **tol_f32)
    if not (torch.equal(y, y1) and torch.equal(st, st1)):
        raise AssertionError("ssd_scan: two bf16 calls differ")
    log(f"[kernels] ssd_scan bf16 T={S}: y max|err| {err(y, y0):.3g}, state max|err| "
        f"{err(st, st0):.3g} at scale {float(st0.abs().max()):.3g}; bit-equal run to run")
    b_ms, b_by = bound_ms(ssd.scan_work(B, S, NH, DS, HD, chunk, 2, broadcast=True,
                                        with_i=False))
    ms, parent_ms = paired_ms(lambda m: m.ssd_scan_bthd(*args, chunk=chunk), ssd, parent)
    r = dict(
        shape=[B, S, NH, DS, HD], what="zamba2-2.7b Mamba2, q/k broadcast", dtype="bf16",
        chunk=chunk, max_abs_err=worst, tol=tol_f32, ms=ms, parent_ms=parent_ms,
        # ~80 launches a call: few calls, or the launch queue fills and the
        # host waits on the card
        plain_ms=time_ms(lambda: ssd.chunked_linear_attention_plain(*args, chunk=chunk),
                         iters=5, warmup=2),
        bound_ms=b_ms, bound_by=b_by, library_ms=None,
        host_ms=host_ms(lambda: ssd.ssd_scan_bthd(*args, chunk=chunk), calls=100))
    r["per_kernel_us"] = kernel_us(lambda: ssd.ssd_scan_bthd(*args, chunk=chunk))
    log(f"[kernels] ssd_scan's launches a call, device time each (profiler, 20 calls): "
        + ", ".join(f"{name} {us:.3f} us" for name, us in r["per_kernel_us"].items()))
    log(f"[kernels] ssd_scan at zamba2-2.7b's prefill (B, T, NH, D) = ({B}, {S}, {NH}, {HD}), "
        f"chunk {chunk}, bf16: {ms * 1e3:.3f} us{vs_parent(parent_ms)} vs bound "
        f"{b_ms * 1e3:.3f} us ({b_by}), plain {r['plain_ms'] * 1e3:.3f} us; host {r['host_ms'] * 1e3:.3f} us a call")
    # the line's max|err| is the Mamba2 checks' (states of scale ~5); the
    # mLSTM's, whose states reach e^30 scales, are in its `shapes` entries
    return dict(r, shapes=[dict(r)] + check_ssd_wide(dev, g, err, parent))


def check_ssd_wide(dev, g, err, parent) -> list[dict]:
    """The mLSTM's scan at xlstm-1.3b's prefill and at its train
    micro-batch: q and k (B, T, 4, 1024) per head, v (B, T, 4, 1025) with
    its ones column, the mLSTM's gates (log_f = log_sigmoid(N(0, 1) + 4),
    log_i uniform over its clip range [-30, 10], so decay terms reach
    e^30), chunk 256; in bf16 at both shapes and in f32 at the prefill's.
    Held to the plain version at the card tests' bounds scaled by max |ref|
    (y: `tol(bf16)` in bf16, atol 5e-4 / rtol 2e-3 in f32; the state at the
    latter in both), two calls bit-equal; in bf16 the share of y's elements
    that differ from the plain version's f32 y rounded to bf16 is logged
    (and the other tree's under `--parent`).  Timed beside its bound, its
    plain version and its host time, and under `--parent` in turns with the
    other tree's `ssd_scan_bthd` at the same inputs (parent, this, this,
    parent); each tree's call split by launch (profiler)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.ssd_scan import ops as ssd
    from repro_torch.testing.parity import tol

    _, B, T, _ = DECODE_RUNS[2]
    NH, DK, chunk = 4, 1024, 256
    tol_f32 = dict(atol=5e-4, rtol=2e-3)
    other = (parent or {}).get("ssd_scan")
    out = []
    for dtype, rows in ((torch.bfloat16, T), (torch.bfloat16, TRAIN_SEQ), (torch.float32, T)):
        q, k = ((torch.randn(B, rows, NH, DK, generator=g, device=dev) * 0.5).to(dtype)
                for _ in range(2))
        v = (torch.randn(B, rows, NH, DK + 1, generator=g, device=dev) * 0.5).to(dtype)
        v[..., -1] = 1.0
        log_f = F.logsigmoid(torch.randn(B, rows, NH, generator=g, device=dev) + 4.0)
        log_i = torch.rand(B, rows, NH, generator=g, device=dev) * 40.0 - 30.0
        args = (q, k, v, log_f, log_i)
        (y, st), (y1, st1), (y0, st0) = (ssd.ssd_scan_bthd(*args, chunk=chunk),
                                         ssd.ssd_scan_bthd(*args, chunk=chunk),
                                         ssd.chunked_linear_attention_plain(*args, chunk=chunk))
        torch.cuda.synchronize()
        y_tol = tol(dtype) if dtype == torch.bfloat16 else tol_f32
        sy, ss = float(y0.float().abs().max()), float(st0.abs().max())
        torch.testing.assert_close(y.float(), y0.float(), atol=y_tol["atol"] * sy,
                                   rtol=y_tol["rtol"])
        torch.testing.assert_close(st, st0, atol=tol_f32["atol"] * ss, rtol=tol_f32["rtol"])
        if not (torch.equal(y, y1) and torch.equal(st, st1)):
            raise AssertionError(f"ssd_scan at the mLSTM's widths, T={rows}: two calls differ")
        name = "bf16" if dtype == torch.bfloat16 else "f32"
        what = "prefill" if rows == T else "train micro-batch"
        # where y rounds otherwise than the f32 result does (bf16 only)
        rounded = y0.to(dtype).float()
        misround = None if dtype != torch.bfloat16 else float((y.float() != rounded).float().mean())
        parent_misround = None
        if misround is not None and other is not None:
            py = other.ssd_scan_bthd(*args, chunk=chunk)[0]
            parent_misround = float((py.float() != rounded).float().mean())
            del py
        b_ms, b_by = bound_ms(ssd.scan_work(B, rows, NH, DK, DK + 1, chunk, q.element_size(),
                                            broadcast=False, with_i=True))
        ms, parent_ms = paired_ms(lambda m: m.ssd_scan_bthd(*args, chunk=chunk), ssd, parent,
                                  iters=20)
        call = lambda: ssd.ssd_scan_bthd(*args, chunk=chunk)  # noqa: E731
        x = dict(shape=[B, rows, NH, DK, DK + 1],
                 what=f"xlstm-1.3b mLSTM {what}, log_i in [-30, 10]",
                 dtype=name, chunk=chunk, max_abs_err=max(err(y, y0), err(st, st0)),
                 max_rel_err=max(err(y, y0) / sy, err(st, st0) / ss),
                 misrounded=misround, parent_misrounded=parent_misround,
                 tol={"y": y_tol, "state": tol_f32, "atol_scaled_by": "max|ref|"},
                 ms=ms, parent_ms=parent_ms,
                 plain_ms=time_ms(lambda: ssd.chunked_linear_attention_plain(*args, chunk=chunk),
                                  iters=3, warmup=1),
                 bound_ms=b_ms, bound_by=b_by, library_ms=None, host_ms=host_ms(call, calls=20),
                 per_kernel_us=kernel_us(call),
                 parent_per_kernel_us=None if other is None else kernel_us(
                     lambda: other.ssd_scan_bthd(*args, chunk=chunk)))
        log(f"[kernels] ssd_scan at xlstm-1.3b's mLSTM {what} (B, T, NH, DK, DV) = "
            f"({B}, {rows}, {NH}, {DK}, {DK + 1}), chunk {chunk}, log_i in [-30, 10], {name}: "
            f"y max|err| {err(y, y0):.3g} at scale {sy:.3g}, state max|err| {err(st, st0):.3g} "
            f"at scale {ss:.3g}, bit-equal run to run"
            + ("" if misround is None else f"; y rounded otherwise than the f32 result in "
               f"{misround:.4%} of its elements" + ("" if parent_misround is None else
                                                   f" (the parent's {parent_misround:.4%})"))
            + f"; {ms * 1e3:.3f} us{vs_parent(parent_ms)}"
            + (f" (this {ms / parent_ms:.3f}x)" if parent_ms else "")
            + f" vs bound {b_ms * 1e3:.3f} us ({b_by}), "
            f"plain {x['plain_ms'] * 1e3:.3f} us; host {x['host_ms'] * 1e3:.3f} us a call; "
            f"launches: " + ", ".join(f"{n} {us:.3f} us" for n, us in x["per_kernel_us"].items())
            + ("" if other is None else "; the parent's: " + ", ".join(
                f"{n} {us:.3f} us" for n, us in x["parent_per_kernel_us"].items())))
        out.append(x)
        del q, k, v, args, y, st, y1, st1, y0, st0, rounded
    return out


def ssd_grad_shapes() -> list[tuple]:
    """(what, B, T, NH, DK, DV, chunk, broadcast, with_i, final): the
    backward at one micro-batch of phase 6d's zamba2-2.7b (4 x 1024 tokens;
    80 heads of 64, q and k one (B, T, 64) tensor broadcast over them, no
    log_i), of xlstm-1.3b's mLSTM (4 heads, DK 1024, DV 1025 with the
    ones column, log_i over its clip range [-30, 10]; phase 6b's), and at
    zamba2's widths with a ragged T and a nonzero final-state cotangent."""
    mb = TRAIN_BATCH // TRAIN_ACCUM
    return [("zamba2-2.7b train", mb, TRAIN_SEQ, 80, 64, 64, 256, True, False, False),
            ("xlstm-1.3b mLSTM train", mb, TRAIN_SEQ, 4, 1024, 1025, 256, False, True, False),
            ("ragged T, final-state cotangent", 2, 1000, 80, 64, 64, 256, True, False, True)]


def check_ssd_backward(dev, g, parent) -> dict:
    """`ssd_scan_backward` at `ssd_grad_shapes`: dq, dk, dv, dlog_g (and
    dlog_i) against the plain backward run in f32 from the same bf16
    inputs, each within GRAD_TOL of that result's max |value| (the plain
    backward from the bf16 inputs, its dq, dk and dv rounded to bf16,
    logged beside it); bit-equal run to run, and with the forward's
    scratch kept (`forward_saved`, as `_ScanFn` keeps it on either route)
    bit-equal to without.  A broadcast q and k go in as one head,
    (B, T, 1, DK), as Mamba2 hands them over, and their gradients come
    back summed over the heads.  Timed as a train step runs it (on the
    forward's kept scratch) beside its bound, the
    call that makes that scratch itself, the plain backward (one call
    between events, `once_ms`), the forward at the same inputs and the
    wrapper's host time; one call's device time split by launch
    (profiler).  Under `--parent`, timed in turns with the other tree's
    backward at the same inputs as its train step runs it, on its own
    forward's kept scratch where its route takes it (parent, this, this,
    parent), its launches split too.  No PyTorch call computes it
    (library: none).  The line's numbers are zamba2-2.7b's shape."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.ssd_scan import ops as ssd
    from repro_torch.testing.parity import GRAD_TOL, assert_grad_close, grad_gap

    other = (parent or {}).get("ssd_scan")
    bf16 = torch.bfloat16
    names = ("dq", "dk", "dv", "dlog_g", "dlog_i")
    rows = []
    for what, B, T, NH, DK, DV, chunk, broadcast, with_i, final in ssd_grad_shapes():
        heads = 1 if broadcast else NH
        q, k = ((torch.randn(B, T, heads, DK, generator=g, device=dev) * 0.5).to(bf16)
                for _ in range(2))
        v = (torch.randn(B, T, NH, DV, generator=g, device=dev) * 0.5).to(bf16)
        if with_i:  # the mLSTM's gates and its ones column
            v[..., -1] = 1.0
            log_g = F.logsigmoid(torch.randn(B, T, NH, generator=g, device=dev) + 4.0)
            log_i = torch.rand(B, T, NH, generator=g, device=dev) * 40.0 - 30.0
        else:
            log_g = -0.05 * F.softplus(torch.randn(B, T, NH, generator=g, device=dev))
            log_i = None
        dy = torch.randn(B, T, NH, DV, generator=g, device=dev).to(bf16)
        dstate = torch.randn(B, NH, DK, DV, generator=g, device=dev) if final else None
        args = (q, k, v, log_g, log_i, dy, dstate)
        route = ssd.backward_plan(B, T, NH, heads, DK, DV, chunk)
        saved = ssd.forward_saved(q, k, v, log_g, log_i, chunk=chunk)

        def unsaved():
            return ssd.ssd_scan_backward(*args, chunk=chunk)

        def call():  # as a train step's backward runs
            return ssd.ssd_scan_backward(*args, chunk=chunk, saved=saved)

        got, again, kept = unsaved(), unsaved(), call()
        want = ssd.chunked_linear_attention_backward_plain(
            *(None if t is None else t.float() for t in args), chunk=chunk)
        plain = ssd.chunked_linear_attention_backward_plain(*args, chunk=chunk)
        torch.cuda.synchronize()
        gaps, plain_gaps = {}, {}
        for n, a, b, c, d, pl in zip(names, got, want, again, kept, plain):
            if b is None:
                continue
            if a.shape != b.shape:
                raise AssertionError(f"ssd_scan_backward {n} ({what}): shape {tuple(a.shape)}, "
                                     f"want {tuple(b.shape)}")
            gaps[n] = assert_grad_close(a, b, f"ssd_scan_backward {n} ({what})")
            plain_gaps[n] = grad_gap(pl.to(a.dtype), b)
            if not (torch.equal(a, c) and torch.equal(a, d)):
                raise AssertionError(f"ssd_scan_backward ({what}): two calls (or the call with "
                                     f"the forward's scratch kept) differ in {n}")
        del got, again, kept, want, plain
        b_ms, b_by = bound_ms(ssd.scan_backward_work(B, T, NH, DK, DV, chunk, broadcast,
                                                     with_i, final))
        parent_ms = parent_split = None
        if other is None:
            ms = time_ms(call, iters=10)
        else:
            psaved = other.forward_saved(q, k, v, log_g, log_i, chunk=chunk)

            def pcall():
                return other.ssd_scan_backward(*args, chunk=chunk, saved=psaved)

            p0, t0, t1, p1 = (time_ms(f, iters=10) for f in (pcall, call, call, pcall))
            ms, parent_ms = (t0 + t1) / 2, (p0 + p1) / 2
            parent_split = kernel_us(pcall, calls=5)
            del psaved
        r = dict(shape=[B, T, NH, DK, DV], what=what, chunk=chunk, route=route[0],
                 groups=route[1], heads_a_group=route[2], max_abs_err=max(gaps.values()),
                 gaps=gaps, plain_bf16_gaps=plain_gaps, tol=GRAD_TOL,
                 ms=ms, parent_ms=parent_ms,
                 unsaved_ms=time_ms(unsaved, iters=10),
                 forward_ms=time_ms(lambda: ssd.ssd_scan_bthd(q, k, v, log_g, log_i, chunk=chunk),
                                    iters=10),
                 forward_bound_ms=bound_ms(ssd.scan_work(B, T, NH, DK, DV, chunk, 2, broadcast,
                                                         with_i))[0],
                 # a chain of large einsums whose host work outruns the card
                 plain_ms=once_ms(lambda: ssd.chunked_linear_attention_backward_plain(
                     *args, chunk=chunk)),
                 bound_ms=b_ms, bound_by=b_by, library_ms=None,
                 host_ms=host_ms(call, calls=20), per_kernel_us=kernel_us(call, calls=5),
                 parent_per_kernel_us=parent_split)
        log(f"[kernels] ssd_scan_backward at the {what} shape (B, T, NH, DK, DV) = "
            f"({B}, {T}, {NH}, {DK}, {DV}), chunk {chunk}, q/k "
            f"{'one head broadcast' if broadcast else 'per head'}, "
            f"{'with' if with_i else 'no'} log_i, "
            f"{'a' if final else 'no'} final-state cotangent, bf16, {route[0]} route"
            + (f" ({route[1]} head groups of {route[2]})" if route[0] == "heads" else "")
            + f": {r['ms'] * 1e3:.3f} us{vs_parent(parent_ms)}"
            + (f" (this {r['ms'] / parent_ms:.3f}x)" if parent_ms else "")
            + f" vs bound {b_ms * 1e3:.3f} us ({b_by}); making the forward's scratch itself "
            f"{r['unsaved_ms'] * 1e3:.3f} us; the forward {r['forward_ms'] * 1e3:.3f} us (bound "
            f"{r['forward_bound_ms'] * 1e3:.3f} us), "
            f"plain {r['plain_ms'] * 1e3:.3f} us; host {r['host_ms'] * 1e3:.3f} us a call; "
            + ", ".join(f"{n} within {x:.3g}" for n, x in gaps.items())
            + f" of the f32 plain backward's max |value| (tol {GRAD_TOL}; the plain backward "
            f"from the bf16 inputs: " + ", ".join(f"{x:.3g}" for x in plain_gaps.values())
            + "); bit-equal run to run; launches: "
            + ", ".join(f"{n} {us:.3f} us" for n, us in r["per_kernel_us"].items())
            + ("" if parent_split is None else "; the parent's: "
               + ", ".join(f"{n} {us:.3f} us" for n, us in parent_split.items())))
        rows.append(r)
        del q, k, v, log_g, log_i, dy, dstate, args, saved
    return dict(rows[0], max_abs_err=max(r["max_abs_err"] for r in rows), shapes=rows)


# ----------------------------------------------------------------- phase 3


def serve_config(slo_scale: float, feedback: str = "planned"):
    """The deployment of every serve act: full-width stablelm-3b (random
    weights from SEED) on one h100 and L4_COUNT l4 stand-ins, the shape of
    examples/serve_pipeline.py's {"tpu-hi": 1, "tpu-lo": 8}.  Every pool is
    co-resident on the one card."""
    from repro_torch.api import ClusterSpec, ModelSpec, ServeConfig

    return ServeConfig(cluster=ClusterSpec(counts={"h100": 1, "l4": L4_COUNT}),
                       models=(ModelSpec(arch=MODEL, n_blocks=N_BLOCKS, seq_len=SEQ,
                                         slo_scale=slo_scale),),
                       feedback=feedback, serve_seq_len=SEQ, seed=SEED)


def staged_plan(session, bs: int, cut: int, n_lo: int = 3):
    """A hand-pinned 2-stage pooled plan: blocks [0, cut) on an n_lo-member
    l4 pool, [cut, n) on the h100 (examples/serve_pipeline.py's act 3)."""
    from repro_torch.core import costmodel as cm
    from repro_torch.core.plan import ClusterPlan, PipelinePlan, StagePlan

    prof = session.store.profiles[MODEL]
    tbl = session.store.analytic_table(MODEL)
    cluster = session.config.cluster
    n = prof.n_blocks
    return ClusterPlan(cluster=cluster, pipelines=[PipelinePlan(
        model_name=MODEL, batch_size=bs,
        stages=(StagePlan(0, cut, "l4", 1, n_lo, tbl.partition(0, cut, "l4", 1, bs)),
                StagePlan(cut, n, "h100", 1, 1, tbl.partition(cut, n, "h100", 1, bs))),
        xfer_latency_s=(cm.transfer_latency(prof, cluster, "l4", "h100", cut, bs),),
    )])


def plan_line(plan) -> str:
    return "; ".join(
        f"bs {p.batch_size}: " + " -> ".join(
            f"blocks [{s.block_start}, {s.block_end}) on {s.accel_class} x{s.n_vdev}"
            for s in p.stages) for p in plan.pipelines)


def trace_of(gen, rate: float, slo_s: float, seed: int, start_id: int = 0,
             n: int = N_REQUESTS) -> list:
    """The first `n` arrivals of `gen(rate, ...)`, drawn over a span long
    enough for them: a trace sized by count, so its p99 ranks n latencies
    however bursty the arrivals."""
    span = n / rate
    while True:
        trace = gen(rate, span, slo_s, MODEL, seed=seed, start_id=start_id)
        if len(trace) >= n:
            return trace[:n]
        span *= 2


def offset_trace(trace, dt: float) -> list:
    """`trace` with every arrival and deadline moved `dt` later."""
    from repro_torch.core.types import replace

    return [replace(r, arrival_s=r.arrival_s + dt, deadline_s=r.deadline_s + dt) for r in trace]


def serve_workload(session, name: str, trace) -> dict:
    """Submit a trace, drain it, and log its attainment and latency from
    the request handles (on the session's virtual clock, which calibration
    makes the wall clock).  Fails unless every request was served and the
    session's executors never failed: the data plane drops the batch of an
    executor that raised (a kernel that refused its shape or failed to
    launch), so a failed launch shows only here."""
    import numpy as np
    import torch

    from repro_torch.data.requests import describe

    handles = [session.submit(r) for r in trace]
    t0 = time.perf_counter()
    session.drain()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    tel = session.telemetry
    lats = np.array([h.latency_s for h in handles if h.latency_s is not None])
    if len(lats) != len(trace) or tel.exec_failures or tel.retries:
        raise AssertionError(
            f"[{name}] served {len(lats)}/{len(trace)} (unresolved "
            f"{sum(not h.done for h in handles)}); executor failures {tel.exec_failures}, "
            f"retries {tel.retries}, drops {tel.snapshot()['drops']}")
    st = describe(trace)
    r = dict(n=len(trace), served=len(lats), wall_s=wall,
             attainment=sum(h.ok for h in handles) / len(trace),
             p50_ms=float(np.percentile(lats, 50)) * 1e3,
             p99_ms=float(np.percentile(lats, 99)) * 1e3)
    log(f"[serve] {name}: {st.n} requests at {st.mean_rps:.1f} rps (peak {st.peak_rps:.1f}), "
        f"SLO {st.slo_s * 1e3:.3f} ms; served {r['served']}/{r['n']} in {wall:.2f} s wall, "
        f"attainment {r['attainment']:.4f}, latency p50 {r['p50_ms']:.3f} ms "
        f"p99 {r['p99_ms']:.3f} ms; executor failures 0")
    return r


def release(session) -> None:
    """Close a session and give its parameters' memory back to the card."""
    import gc

    import torch

    session.shutdown()
    del session
    gc.collect()
    torch.cuda.empty_cache()


def act_milp(dev) -> int:
    """Act 1: profile -> MILP plan -> deploy("real"), then a Poisson and a
    bursty trace on the one deployment, planned feedback: the analytic
    clock schedules, the card executes underneath.  A session serves one
    monotonic virtual clock, so the bursty trace starts where the Poisson
    one's served horizon ends.  Returns the batches dispatched."""
    from repro_torch.api import Session
    from repro_torch.data.requests import bursty_trace, poisson_trace

    session = Session.from_config(serve_config(MILP_SLO_SCALE), device=dev)
    t0 = time.perf_counter()
    session.profile()
    t1 = time.perf_counter()
    plan = session.plan()
    t2 = time.perf_counter()
    log(f"[serve] MILP plan: {plan_line(plan)}; planned throughput {plan.throughput:.1f} rps, "
        f"chips {plan.chips_used()}; profile {(t1 - t0) * 1e3:.3f} ms, solve "
        f"{(t2 - t1) * 1e3:.3f} ms")
    t0 = time.perf_counter()
    before = graph_snapshot()
    session.deploy(mode="real")
    log(f"[serve] deploy(mode=\"real\") in {time.perf_counter() - t0:.2f} s")
    log_captures("MILP plan's deploy", before)
    slo_s = session.store.profiles[MODEL].slo_s
    rate = plan.throughput * 0.6
    poisson = trace_of(poisson_trace, rate, slo_s, seed=7)
    serve_workload(session, "MILP plan, poisson", poisson)
    bursty = trace_of(bursty_trace, rate, slo_s, seed=7, start_id=len(poisson))
    serve_workload(session, "MILP plan, bursty",
                   offset_trace(bursty, session.telemetry.horizon_s))
    batches = len(session.telemetry.dispatches)
    release(session)
    return batches


def act_pinned(dev):
    """Act 2: the hand-pinned 2-stage plan through use_plan, measured
    feedback: deploy calibrates every stage on the card, so the virtual
    clock is the wall clock and the feedback keeps the reservations in
    step.  Returns the live session (its executors serve phases 4 and 5)."""
    import numpy as np

    from repro_torch.api import Session
    from repro_torch.configs import get_config
    from repro_torch.data.requests import poisson_trace
    from repro_torch.serving.engine import layer_block_map_from_profile

    session = Session.from_config(serve_config(PINNED_SLO_SCALE, feedback="measured"),
                                  device=dev)
    session.profile()
    plan = staged_plan(session, BATCH, CUT)
    session.use_plan(plan)
    t0 = time.perf_counter()
    before = graph_snapshot()
    session.deploy(mode="real")
    log_captures("pinned plan's deploy (before calibration)", before)
    cfg = get_config(MODEL)
    executors = session.dataplane.dispatcher.executors
    params = executors[0][0].params
    n_params = sum(p.numel() for p in params.parameters())
    lbm = layer_block_map_from_profile(session.store.profiles[MODEL], cfg.n_layers)
    stages = plan.pipelines[0].stages
    layers = [(lbm[s.block_start][0], lbm[s.block_end - 1][1]) for s in stages]
    log(f"[serve] {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, {cfg.n_heads} heads "
        f"x {cfg.hd}, {n_params / 1e9:.3f} B params bf16 on {dev}; pinned plan "
        f"{plan_line(plan)} -> layers {layers}; deploy with calibration in "
        f"{time.perf_counter() - t0:.1f} s")
    p0 = session.runtime.pipelines[0]
    for si, stage in enumerate(p0.stages):
        for bs, sec in sorted(stage.latency_by_batch.items()):
            log(f"[serve] calibrated stage {si} batch {bs}: {sec * 1e3:.3f} ms")
    e2e = sum(s.latency(1) for s in p0.stages)
    thr = min(len(s.vdevs) * p0.unified_batch / s.latency(p0.unified_batch) for s in p0.stages)
    rate = thr * 0.5
    trace = trace_of(poisson_trace, rate, e2e * 6, seed=11)
    log(f"[serve] calibrated batch-1 e2e {e2e * 1e3:.3f} ms, pipeline throughput {thr:.1f} rps")
    r = serve_workload(session, "pinned 2-stage plan, measured feedback", trace)
    tel = session.telemetry
    disp, fb = session.dataplane.dispatcher, session.dataplane.fb
    if fb.observations <= 0:
        raise AssertionError("measured feedback made no observation")
    if disp.submitted <= 0:
        raise AssertionError("no batch was dispatched")
    log(f"[serve] served {tel.served}/{len(trace)}, attainment {tel.attainment:.4f}, latency "
        f"p50 {r['p50_ms']:.3f} ms p99 {r['p99_ms']:.3f} ms, batches {disp.submitted} (mean "
        f"size {tel.mean_batch_size:.2f}), inflight_hwm {tel.inflight_hwm}, feedback "
        f"observations {fb.observations}, lat_scale {[round(s.lat_scale, 4) for s in p0.stages]}")
    for (e, pid, si), ws in sorted(tel.stage_wall_s.items()):
        log(f"[serve] measured stage {si} wall: median {np.median(ws) * 1e3:.3f} ms over "
            f"{len(ws)} batches")
    return session


def act_swap(dev) -> int:
    """Act 3: a live swap to another partitioning on a fresh deployment of
    the MILP plan: prepare_swap builds and warms the new ranges' executors,
    capturing their graphs, on a background thread (its own CUDA stream)
    from the trace's second arrival while the old plan serves; the swap
    installs them mid-trace, at the first arrival that finds the warm done
    (at the last arrival whatever it finds), in-flight batches drain on
    the retired epoch, which is garbage-collected.  The trace is
    SWAP_REQUESTS long: served from graphs, the device sets the pace (a
    batch of 2 through 32 layers takes ~7.5 ms, so 480 requests take ~2 s),
    and the warm, sharing the host with the serving thread, took 0.3-0.9 s
    on the card's host.  Returns the batches dispatched."""
    from repro_torch.api import Session
    from repro_torch.data.requests import poisson_trace

    session = Session.from_config(serve_config(SWAP_SLO_SCALE), device=dev)
    plan_a = session.plan()
    plan_b = staged_plan(session, 2, 1)
    before = graph_snapshot()
    session.deploy(mode="real")
    log_captures("swap act's deploy", before)
    old = [ex for execs in session.dataplane.dispatcher.executors.values() for ex in execs]
    log(f"[serve] live swap: from the MILP plan {plan_line(plan_a)} to {plan_line(plan_b)}")
    prof = session.store.profiles[MODEL]
    rate = plan_a.throughput * 0.5
    trace = trace_of(poisson_trace, rate, prof.slo_s, seed=13, n=SWAP_REQUESTS)
    first, last = trace[0].arrival_s, trace[-1].arrival_s
    state = {}

    def hook(req, t):
        if "prep" not in state and t > first:
            state["prep_at"] = req.req_id  # the trace starts at id 0
            state["prep"] = session.prepare_swap(plan_b)
        elif "rec" not in state and "prep" in state and (state["prep"].ready() or t >= last):
            state["inflight"] = len(session.dataplane.jobs)
            state["at"] = req.req_id
            state["rec"] = session.swap(plan_b, now=t, reason="live repartition")

    session.on_arrival(hook)
    before = graph_snapshot()
    serve_workload(session, "live swap", trace)
    log_captures("live swap's background warm (prepare_swap's thread)", before, memory=False)
    tel, rec, prep = session.telemetry, state["rec"], state["prep"]
    log(f"[serve] live swap at arrival {state['at']} of {len(trace)} (prepared from arrival "
        f"{state['prep_at']}), with {state['inflight']} batch(es) in flight: swap wall "
        f"{rec.swap_wall_s * 1e3:.3f} ms, background warm {prep.warm_wall_s * 1e3:.3f} ms, "
        f"waited for it in the swap {rec.compile_wall_s * 1e3:.3f} ms, prepared {rec.prepared}, "
        f"{rec.reused_executors} executor(s) reused, new_ranges {list(rec.new_ranges)}, "
        f"virtual transient {tel.swap_transient_s[-1] * 1e3:.3f} ms; retired epoch GC'd "
        f"({tel.epochs_gcd}/{tel.plan_swaps})")
    if not (rec.prepared and tel.plan_swaps == 1 and tel.epochs_gcd == 1 and rec.new_ranges):
        raise AssertionError(f"live swap: {rec}, swaps {tel.plan_swaps}, GC'd {tel.epochs_gcd}")
    live = {id(ex) for execs in session.dataplane.dispatcher.executors.values() for ex in execs}
    held = [len(ex.graphs) for ex in old if id(ex) not in live]
    if any(held):
        raise AssertionError(f"the GC'd epoch's executors still hold graphs: {held}")
    log(f"[serve] the GC'd epoch released the graphs of its {len(held)} executor(s) that the "
        f"new plan does not serve with")
    batches = len(tel.dispatches)
    release(session)
    return batches


# the host's calls that put work on the card: a kernel, a graph, a copy
HOST_LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                     "cuLaunchKernelEx", "cudaGraphLaunch", "cudaMemcpyAsync",
                     "cudaMemsetAsync")


def raw_events(prof) -> list:
    """The events of a finished torch.profiler window, the profiler's own
    records (`_KinetoEvent`s), less those `key_averages` leaves out (hidden
    events, the profiler's utility ops) and GPU user annotations: reading
    them builds no Python event object a record, as `key_averages` does
    (~100 us a record: minutes for a graph of 1.4 M kernels)."""
    from torch.autograd.profiler_util import _filter_name

    def left_out(e) -> bool:
        return any(getattr(e, test, lambda: False)()
                   for test in ("is_user_annotation", "is_hidden_event"))

    return [e for e in prof.profiler.kineto_results.events()
            if not (left_out(e) or _filter_name(e.name()))]


def on_device(e) -> bool:
    import torch

    return e.device_type() == torch.autograd.DeviceType.CUDA


def host_self_us(events) -> dict[str, list]:
    """[calls, self us] by name of the host's synchronous events (ops and
    runtime calls): each one's time less its children's, the events it
    encloses on its thread, as `key_averages`' `self_cpu_time_total`."""
    out: dict[str, list] = {}
    threads: dict[int, list] = {}
    for e in events:
        if not (on_device(e) or e.is_async() or e.start_thread_id() != e.end_thread_id()):
            threads.setdefault(e.start_thread_id(), []).append(e)
    for evs in threads.values():
        evs.sort(key=lambda e: (e.start_ns(), -e.end_ns()))
        stack: list = []  # [event, its children's ns]
        for e in evs + [None]:
            while stack and (e is None or stack[-1][0].end_ns() <= e.start_ns()):
                done, children = stack.pop()
                row = out.setdefault(done.name(), [0, 0.0])
                row[0] += 1
                row[1] += (done.duration_ns() - children) / 1e3
            if e is not None:
                if stack:
                    stack[-1][1] += e.duration_ns()
                stack.append([e, 0])
    return out


def busy_share(run, tag: str, top: int = 8, out: dict | None = None) -> float | None:
    """Share of the wall time of `run()` (work that ends on the card) during
    which the card ran kernels, from torch.profiler (`raw_events`); logs the
    `top` kernels and host ops (by self time, `host_self_us`).  None if the
    profiler recorded no device time.  `out`, if given, takes the window's
    device and wall ms, the host's calls of `HOST_LAUNCH_CALLS`, by name
    (`host_launches`), and the device us by kernel (`kernels`, summed by
    `by_key`)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    events = raw_events(prof)
    kernels: dict[str, list] = {}
    for e in events:
        if on_device(e):
            row = kernels.setdefault(e.name(), [0, 0.0])
            row[0] += 1
            row[1] += e.duration_ns() / 1e3
    busy_us = sum(us for _, us in kernels.values())
    if busy_us <= 0:
        return None
    host = host_self_us(events)
    host_us = sum(us for _, us in host.values())
    read_s = time.perf_counter() - t0 - wall_us / 1e6
    for name, (n, us) in sorted(kernels.items(), key=lambda kv: -kv[1][1])[:top]:
        log(f"[{tag}] profile: {us / busy_us:7.2%} of device time, {n:5d} calls: {name[:90]}")
    for name, (n, us) in sorted(host.items(), key=lambda kv: -kv[1][1])[:top]:
        log(f"[{tag}] profile: {us / host_us:7.2%} of host op time, {n:5d} calls: {name[:90]}")
    log(f"[{tag}] profile: {len(kernels)} kernel names, {busy_us / 1e3:.3f} ms device time, "
        f"{host_us / 1e3:.3f} ms host op time, in {wall_us / 1e3:.3f} ms wall (the profile "
        f"read in {read_s:.1f} s)")
    if out is not None:
        out.update(device_ms=busy_us / 1e3, wall_ms=wall_us / 1e3, host_launches={
            name: n for name, (n, _) in host.items() if name in HOST_LAUNCH_CALLS},
            kernels=by_key((name, us) for name, (_, us) in kernels.items()))
    return busy_us / wall_us


def graph_snapshot() -> tuple:
    from repro_torch.serving.engine import GRAPH_STATS as G

    return G.captures, G.capture_s, G.allocated_bytes, G.reserved_bytes


def log_captures(what: str, before: tuple, memory: bool = True) -> None:
    """The stage graphs captured since `before` (a `graph_snapshot`), with
    the device memory they hold where nothing else allocated meanwhile."""
    n, sec, alloc, res = (a - b for a, b in zip(graph_snapshot(), before))
    held = (f"they hold {res / 2**20:.1f} MiB of device memory reserved, "
            f"{alloc / 2**20:.1f} MiB allocated" if memory else
            "their memory is not told apart from the serving thread's, which allocated "
            "meanwhile")
    log(f"[serve] {what}: captured {n} stage graphs in {sec * 1e3:.3f} ms (host time inside "
        f"capture_begin .. capture_end); {held}")


class EagerStage:
    """A StageExecutor's stage run eagerly (`stage_fn`, no graph), for the
    comparison with the replays of its captured graphs."""

    def __init__(self, ex):
        self.ex = ex

    def transfer(self, x):
        return self.ex.transfer(x)

    def __call__(self, x):
        import torch

        with torch.inference_mode():
            return self.ex.stage_fn(self.ex.params, x)


def graphs_vs_eager(executors, dev, n_batches: int = 4) -> dict:
    """The pinned plan's stages as served (graph replays) and run eagerly,
    in turns (graphs, eager, eager, graphs), each over a window of
    `n_batches` back-to-back pipelined batches of BATCH: the device busy
    share of the window (profiler) and the median device time of each stage
    (the dispatcher's events around it).  Also the device time of the copy
    each replay hands out (its static output cloned)."""
    import numpy as np
    import torch

    from repro_torch.dataplane import PoolDispatcher

    tokens = torch.ones((BATCH, SEQ), dtype=torch.int64, device=dev)
    variants = {"graphs": executors[0], "eager": [EagerStage(ex) for ex in executors[0]]}
    res = {k: dict(share=[], walls=[[] for _ in executors[0]]) for k in variants}
    for i, name in enumerate(("graphs", "eager", "eager", "graphs")):
        disp = PoolDispatcher({0: variants[name]}, max_inflight=n_batches)

        def run():
            for _ in range(n_batches):
                disp.submit_chain(0, tokens)
            disp.drain_all()

        run()  # outside the window: allocator pools warm for this variant
        disp.take_completed()
        res[name]["share"].append(busy_share(run, f"serve, {name}", top=8 if i < 2 else 0))
        for done in disp.take_completed():
            for si, w in enumerate(done.stage_wall_s):
                res[name]["walls"][si].append(w)
    for name, r in res.items():
        r["median_stage_ms"] = [float(np.median(w)) * 1e3 for w in r["walls"]]
        shares = ", ".join("not measured" if x is None else f"{x:.4f}" for x in r["share"])
        log(f"[serve] {name}: device busy share over {n_batches} back-to-back batches of "
            f"{BATCH}: {shares}; median stage device time "
            + ", ".join(f"stage {si} {ms:.3f} ms" for si, ms in enumerate(r["median_stage_ms"]))
            + f" (over {len(r['walls'][0])} batches)")
    r = res["graphs"]
    r["clone_us"] = []
    for si, ex in enumerate(executors[0]):
        g = max(ex.graphs.values(), key=lambda g: g.static_in.shape[0])
        r["clone_us"].append(time_ms(lambda g=g: g.static_out.clone()) * 1e3)
        log(f"[serve] stage {si}: the copy a replay hands out, "
            f"{tuple(g.static_out.shape)} {g.static_out.dtype}, takes "
            f"{r['clone_us'][-1]:.3f} us of device time")
    return res


def phase_serve(dev):
    """The three serve acts through `repro_torch.api.Session`, counted
    together: every kernel launch from the first deploy to the last drain
    (stage programs, calibration, the swap's warm).  The stages replay
    captured graphs: the kernel wrappers count a graph's launches once,
    when it is captured, so the launches served are the counters' advance,
    less what was recorded into graphs, plus each graph's launches times its
    replays.  Every stage call on the serving path must replay a graph.
    Returns the model's config, the pinned act's live session and the
    launch counts."""
    from repro_torch.configs import get_config
    from repro_torch.serving.engine import GRAPH_STATS as G

    reset_counts()
    G.reset()
    batches = act_milp(dev)
    session = act_pinned(dev)
    batches += len(session.telemetry.dispatches)
    batches += act_swap(dev)
    counted = read_counts()
    launches = {k: n - G.captured.get(k, 0) + G.replayed.get(k, 0) for k, n in counted.items()}
    log(f"[serve] stage graphs over the three acts: {G.captures} captured in "
        f"{G.capture_s * 1e3:.3f} ms, {G.replays} replays, {G.misses} calls without a graph; "
        f"the kernel counters advanced by {counted}, of which {G.captured} at capture; the "
        f"replays launched {G.replayed}")
    if G.misses:
        raise AssertionError(f"{G.misses} stage calls found no graph and ran eagerly")
    cfg = get_config(MODEL)
    for name in ("rmsnorm", "flash_attention"):
        if launches[name] < cfg.n_layers * batches:
            raise AssertionError(f"{name} launched {launches[name]} times for {batches} "
                                 f"batches of {cfg.n_layers} layers")
    log(f"[serve] launches while serving: {launches} ({batches} batches over the three acts; "
        f"on one card every stage shares the device, so transfer() skips the boundary "
        f"kernels)")
    graphs_vs_eager(session.dataplane.dispatcher.executors, dev)
    return cfg, session, launches


# ----------------------------------------------------------------- phase 4


def phase_parity(cfg, executors, dev) -> None:
    """The full-width stage split through the kernels against the same
    program through the plain PyTorch math (`common.PLAIN`: the reference's
    rms_norm and chunked attention, op for op), on the same parameters and
    device.

    With the reference's init the activations are large and attention is
    nearly one-hot, so one-ulp bf16 differences grow chaotically over 32
    layers and two correct forwards disagree elementwise at the logits.
    The check is therefore made where it is meaningful: every layer (and
    the head) from the same input, with max |err| <= 5e-2 x max |ref| (the
    bf16 tolerance of tests/test_kernels.py, relative to the tensor's
    scale); the whole forward must be finite and agree on top-1 wherever
    the reference's top-2 margin exceeds twice the observed error."""
    import numpy as np
    import torch

    from repro_torch.models import transformer as tfm
    from repro_torch.models.common import KERNELS, PLAIN as plain

    s0, s1 = executors[0]
    params = s0.params
    tokens = torch.from_numpy(np.random.default_rng(SEED).integers(0, cfg.vocab, (2, SEQ)))
    tokens = tokens.to(dev)

    worst = 0.0
    with torch.inference_mode():
        x = tfm.embed_tokens(cfg, params, tokens)
        positions = tfm.positions_for(x)
        for i, lp in enumerate(params["layers"]):
            got, _ = tfm.layer_full(cfg, KERNELS, lp, x, positions)
            want, _ = tfm.layer_full(cfg, plain, lp, x, positions)
            rel = float((got - want).abs().max()) / float(want.abs().max())
            worst = max(worst, rel)
            if not rel <= 5e-2:
                raise AssertionError(f"layer {i}: max|err| / max|ref| = {rel:.4g}")
            x = got
        got = tfm.unembed(cfg, params, KERNELS.rms_norm(x, params["final_norm"], cfg.norm_eps))
        want = tfm.unembed(cfg, params, plain.rms_norm(x, params["final_norm"], cfg.norm_eps))
        head_rel = float((got - want).abs().max()) / float(want.abs().max())
        if not head_rel <= 5e-2:
            raise AssertionError(f"head: max|err| / max|ref| = {head_rel:.4g}")

        got = s1(s1.transfer(s0(tokens))).float()
        want = tfm.forward(cfg, plain, params, tokens).float()
    torch.cuda.synchronize()
    if not torch.equal(s1(s1.transfer(s0(tokens))).float(), got):
        raise AssertionError("the stage split is not deterministic")
    err = float((got - want).abs().max())
    within = float(((got - want).abs() <= 5e-2 + 5e-2 * want.abs()).float().mean())
    top2 = want.topk(2, dim=-1).values
    decisive = (top2[..., 0] - top2[..., 1]) > 2 * err
    agree = got.argmax(-1) == want.argmax(-1)
    log(f"[parity] per layer (same input): worst max|err|/max|ref| {worst:.4g} over "
        f"{cfg.n_layers} layers, head {head_rel:.4g} (limit 5e-2)")
    log(f"[parity] whole forward, stage split (kernels) vs plain math: logits max|err| "
        f"{err:.4f} at scale {float(want.abs().max()):.2f}, share within 5e-2 abs+rel "
        f"{within:.6f}; top-1 agrees at {int(agree.sum())}/{agree.numel()} positions, "
        f"{int(decisive.sum())} decisive")
    if got.shape != (2, SEQ, cfg.padded_vocab) or not torch.isfinite(got).all():
        raise AssertionError(f"logits of shape {tuple(got.shape)}, finite "
                             f"{bool(torch.isfinite(got).all())}")
    if not bool(agree[decisive].all()):
        raise AssertionError("top-1 disagrees at a decisive position")


# ----------------------------------------------------------------- phase 5


def reset_counts() -> None:
    from repro_torch.kernels import reset_counts as reset

    reset()


def read_counts() -> dict:
    from repro_torch.kernels import launch_counts

    return launch_counts()


def path_kernels(cfg) -> list[str]:
    """The kernels a model's serving path must launch: rmsnorm always,
    flash_attention and decode_attention where it has attention layers
    (flash_attention alone for MLA, whose decode is einsums), ssd_scan where
    it has Mamba2 or mLSTM blocks."""
    pattern = cfg.ssm_pattern
    attention = ["flash_attention", "decode_attention"] if not pattern or "a" in pattern else []
    if cfg.mla:
        attention = ["flash_attention"]
    return ["rmsnorm"] + attention + (["ssd_scan"] if set(pattern) & set("mM") else [])


def expected_launches(cfg) -> dict:
    """The launches a prefill and a decode step must make: flash attention
    for each attention layer of the prefill (the enc-dec's encoder layers;
    its decoder runs the BOS step), decode attention for each attention
    layer of a step (the enc-dec's self- and cross-attention: two a decoder
    layer, in its prefill's BOS step too; none for MLA) and ssd_scan for
    each Mamba2 or mLSTM block of the prefill."""
    if cfg.family == "audio":
        step = 2 * cfg.n_layers
        return dict(flash=cfg.encoder_layers, prefill_decode=step, step=step, scan=0)
    n_attn = cfg.ssm_pattern.count("a") if cfg.ssm_pattern else cfg.n_layers
    return dict(flash=n_attn, prefill_decode=0, step=0 if cfg.mla else n_attn,
                scan=sum(cfg.ssm_pattern.count(c) for c in "mM"))


def decode_inputs(cfg, B: int, S: int, dev, seed: int = SEED + 1) -> tuple[dict, int]:
    """The prefill's batch for B requests, made from `seed`, and the cache's
    valid length after the prefill: S prompt tokens (the VLM's after its
    frontend_tokens patch embeddings, normal x 0.1 as tests/test_models.py
    draws them), or for the enc-dec S frame embeddings (normal) and the
    BOS step's one position."""
    import numpy as np
    import torch

    from repro_torch.models.model_zoo import batch_text_offset

    g = torch.Generator(device=dev).manual_seed(seed)
    if cfg.family == "audio":
        return {"frames": torch.randn(B, S, cfg.d_model, generator=g, device=dev).to(cfg.dtype)}, 1
    prompts = torch.from_numpy(np.random.default_rng(seed).integers(0, cfg.vocab, (B, S)))
    batch = {"tokens": prompts.to(dev)}
    if cfg.family == "vlm":
        batch["patches"] = (torch.randn(B, cfg.frontend_tokens, cfg.d_model, generator=g,
                                        device=dev) * 0.1).to(cfg.dtype)
    return batch, batch_text_offset(cfg) + S


def forward_batch(cfg, batch: dict, fed: list) -> dict:
    """The teacher-forced forward's batch over the prefill's inputs and the
    tokens fed to the decode steps: the prompts then the fed tokens, or for
    the enc-dec the frames and the decoder tokens [bos, fed...].  Its
    logits from position (the prefill's valid length - 1) on are the
    prefill's and the steps'."""
    import torch

    from repro_torch.models.encdec import BOS_TOKEN

    if cfg.family == "audio":
        bos = torch.full_like(fed[0], BOS_TOKEN)
        return {"tokens": torch.cat([bos, *fed], dim=1), "frames": batch["frames"]}
    return dict(batch, tokens=torch.cat([batch["tokens"], *fed], dim=1))


def embed_inputs(cfg, params, batch: dict):
    """The embeddings the first layer of a (decoder-only) model reads."""
    from repro_torch.models import transformer as tfm

    return tfm.embed_tokens(cfg, params, batch["tokens"], batch.get("patches"))


def recurrent_kinds(cfg) -> tuple[str, str | None, str]:
    """A recurrent model's inner block kind ('m' or 'M'), its outer kind
    ('a', 's' or None) and the inner block's name in the lines."""
    from repro_torch.models import hybrid

    period, _ = hybrid.parse_pattern(cfg)
    return period[0], hybrid._outer_kind(period), {"m": "Mamba2", "M": "mLSTM"}[period[0]]


def rel_err(got, want) -> float:
    return float((got.float() - want.float()).abs().max()) / float(want.float().abs().max())


def check_layer(what: str, got, want, worst: dict) -> None:
    """Two forms of one layer from the same input: max |err| <= 5e-2 x
    max |ref| (as phase 4)."""
    rel = rel_err(got, want)
    worst[what] = max(worst.get(what, 0.0), rel)
    if not rel <= 5e-2:
        raise AssertionError(f"{what}: max|err| / max|ref| = {rel:.4g}")


def layer_cache(cfg, cache, i) -> tuple:
    """Layer i's two cache tensors: (k, v), or MLA's (c_kv, k_rope)."""
    return tuple(cache[n][i] for n in (("c_kv", "k_rope") if cfg.mla else ("k", "v")))


def tally_routing(flips: dict, what: str, a, b):
    """Two sets of routing decisions (`moe.ffn_routing`: each token's
    expert ids and the choices capacity kept, (B, T, k)) for the same tokens:
    tallies in flips[what] the tokens, those whose expert ids differ (a
    flip) and those whose ids agree but not which choices capacity kept;
    returns the (B, T) mask of the tokens routed alike (the same ids, the
    same choices kept)."""
    (ids_a, keep_a), (ids_b, keep_b) = a, b
    same = (ids_a == ids_b).all(-1)
    alike = same & (keep_a == keep_b).all(-1)
    t = flips.setdefault(what, [0, 0, 0])
    t[0] += same.numel()
    t[1] += int((~same).sum())
    t[2] += int((same & ~alike).sum())
    return alike


def check_alike(what: str, got, want, alike, worst: dict) -> None:
    """`check_layer` at the tokens routed alike (where there are any)."""
    if bool(alike.any()):
        check_layer(what, got[alike], want[alike], worst)


def check_flips(arch: str, flips: dict, limit: float, what: str = "") -> None:
    """Logs each walk's routing tally and holds the flips over all of them
    to `limit` of the decisions."""
    tokens = sum(t[0] for t in flips.values())
    flipped = sum(t[1] for t in flips.values())
    log(f"[decode] {arch}{what}: routing decisions (token, layer) the walks compared: "
        + ", ".join(f"{k} {t[0]}, {t[1]} flipped, {t[2]} kept apart by capacity"
                    for k, t in flips.items())
        + f"; {flipped}/{tokens} flipped in all (limit {limit:g} of them)")
    if flipped > limit * tokens:
        raise AssertionError(f"{arch}{what}: {flipped} of {tokens} routing decisions flip, "
                             f"more than {limit:g} of them")


def moe_parity(cfg, params, x, xd, positions, cache, cur_len, worst: dict,
               flips: dict) -> None:
    """`layer_parity` of the MoE family: each layer's attention block
    through the kernels against the plain math from the same input, then
    its FFN block from each one's output, held at the tokens both route
    alike (the MoE blocks) or whole (deepseek's dense MLPs); the kernels'
    output goes on.  Both forms: the prefill over x, the decode step of xd
    on a copy of the layer's cache."""
    from repro_torch.models import moe
    from repro_torch.models.common import KERNELS, PLAIN
    from repro_torch.models.model_zoo import build_model

    mod = build_model(cfg).mod
    both = (KERNELS, PLAIN)
    for i, lp in enumerate(mod.layers(params)):
        caches = layer_cache(cfg, cache, i)
        for form in ("prefill", "decode"):
            if form == "prefill":
                hk, hp = (mod.attn_block_full(cfg, ops, lp, x, positions)[0] for ops in both)
            else:
                hk, hp = (mod.attn_block_decode(cfg, ops, lp, xd, *(c.clone() for c in caches),
                                                cur_len)[0] for ops in both)
            check_layer(f"attention block ({form})", hk, hp, worst)
            out, ref = mod.ffn_block(cfg, KERNELS, lp, hk), mod.ffn_block(cfg, PLAIN, lp, hp)
            if "moe" in lp:
                alike = tally_routing(flips, f"MoE block ({form})",
                                      moe.ffn_routing(cfg, KERNELS, lp, hk),
                                      moe.ffn_routing(cfg, PLAIN, lp, hp))
                check_alike(f"MoE block ({form}, tokens routed alike)", out, ref, alike, worst)
            else:
                check_layer(f"dense MLP block ({form})", out, ref, worst)
            if form == "prefill":
                x = out
            else:
                xd = out


def moe_invariant(cfg, params, x, positions, S: int, worst: dict, flips: dict) -> None:
    """`layer_invariant` of the MoE family, through the kernels: each
    layer's attention block in decode form at position S, from the cache
    its full form left over the first S positions, against its full form
    at S; then the FFN block over the last position alone against the same
    block over all S + 1, from the full form's output, held at the tokens
    both route alike (the full form's capacity is that of its B (S + 1)
    tokens, the step's of B, so a choice the full form drops is routed
    apart).

    MLA's decode form is another algorithm than its full form: absorbed
    into the latent space, against expanded keys through flash attention.
    At the reference's init its scores spread over hundreds, so the softmax
    is nearly one-hot and bf16's rounding (2^-9 of a score) swaps near-tied
    keys, on either side: in bf16 the two forms' gap is logged beside the
    plain math's own, and held in f32 (the f32 witness runs this walk), where
    no key swaps.  That the kernels compute each form is held by
    `layer_parity`."""
    import torch

    from repro_torch.models import moe
    from repro_torch.models.common import KERNELS, PLAIN
    from repro_torch.models.model_zoo import build_model

    mod = build_model(cfg).mod
    B = x.shape[0]
    mla_bf16 = cfg.mla and cfg.dtype == torch.bfloat16
    gaps = {"kernels": 0.0, "plain math": 0.0}

    def decode_vs_full(ops, lp, x):
        full, _ = mod.attn_block_full(cfg, ops, lp, x, positions)
        _, pre = mod.attn_block_full(cfg, ops, lp, x[:, :S].contiguous(), positions[:, :S])
        caches = [torch.zeros((B, S + 1) + a.shape[2:], dtype=a.dtype, device=a.device)
                  for a in pre]
        for c, a in zip(caches, pre):
            c[:, :S] = a
        step, _ = mod.attn_block_decode(cfg, ops, lp, x[:, S:].contiguous(), *caches, S)
        return full, step

    for i, lp in enumerate(mod.layers(params)):
        full, step = decode_vs_full(KERNELS, lp, x)
        if mla_bf16:
            if i == 0:
                mla_score_spread(cfg, lp, x, positions)
            plain_full, plain_step = decode_vs_full(PLAIN, lp, x)
            gaps["kernels"] = max(gaps["kernels"], rel_err(step[:, 0], full[:, S]))
            gaps["plain math"] = max(gaps["plain math"],
                                     rel_err(plain_step[:, 0], plain_full[:, S]))
        else:
            check_layer("attention block (decode vs full)", step[:, 0], full[:, S], worst)
        x = mod.ffn_block(cfg, KERNELS, lp, full)
        last = full[:, S:].contiguous()
        y = mod.ffn_block(cfg, KERNELS, lp, last)
        if "moe" in lp:
            ids, keep = moe.ffn_routing(cfg, KERNELS, lp, full)
            alike = tally_routing(flips, "MoE block (last position vs all)",
                                  (ids[:, S:], keep[:, S:]),
                                  moe.ffn_routing(cfg, KERNELS, lp, last))
            check_alike("MoE block (last position vs all, tokens routed alike)", y, x[:, S:],
                        alike, worst)
        else:
            check_layer("dense MLP block (last position vs all)", y[:, 0], x[:, S], worst)
    if mla_bf16:
        log(f"[decode] {cfg.name}: MLA's decode (absorbed) vs full (expanded) form in bf16, "
            f"not held (near-tied keys swap; held in f32), worst max|err|/max|ref| over the "
            f"layers: " + ", ".join(f"{k} {v:.4g}" for k, v in gaps.items()))


def mla_score_spread(cfg, lp, x, positions) -> None:
    """Logs the spread of an MLA layer's attention scores at the last
    position (expanded form, the plain math, the scores in f32): their
    standard deviation and the median gap between the two largest of each
    (batch, head), beside 2^-9 of the largest, a bf16 rounding of it."""
    import math

    import torch

    from repro_torch.models import deepseek
    from repro_torch.models.common import PLAIN

    p, nope = lp["attn"], cfg.qk_nope_dim
    B, T, _ = x.shape
    h = PLAIN.rms_norm(x, lp["attn_norm"], cfg.norm_eps)
    q_nope, q_rope = deepseek._mla_q(cfg, PLAIN, p, h, positions)
    c_kv, k_rope = deepseek._mla_kv_latent(cfg, PLAIN, p, h, positions)
    k_nope = (c_kv @ p["kv_b"].reshape(cfg.kv_lora_rank, -1)).reshape(B, T, cfg.n_heads, -1)
    s = (torch.einsum("bhd,bthd->bht", q_nope[:, -1].float(), k_nope[..., :nope].float())
         + torch.einsum("bhr,btr->bht", q_rope[:, -1].float(), k_rope.float()))
    s = s / math.sqrt(nope + cfg.qk_rope_dim)
    top2 = s.topk(2, dim=-1).values
    gap = float((top2[..., 0] - top2[..., 1]).median())
    log(f"[decode] {cfg.name}: MLA scores of the last position over {T} keys, layer 0: std "
        f"{float(s.std()):.4g}, median gap of the two largest {gap:.4g}, 2^-9 of the largest "
        f"{float(s.abs().max()) / 512:.4g}")


def layer_parity(cfg, params, batch, fed, cache, tok, cur_len, flips=None) -> dict:
    """Single layers through `KERNELS` against `PLAIN`, each from the same
    input (and a copy of the same cache): the prefill and the decode form of
    every attention layer (stablelm-3b, llava-next-34b), or of every group's
    inner blocks (Mamba2, mLSTM) and its outer block (the shared attention
    block, an sLSTM block), each on its own group's slice of the cache
    (zamba2-2.7b, xlstm-1.3b), or every encoder layer and the decoder's
    self-attention, cross-attention and MLP blocks, teacher-forced and in
    decode form on the decode cache (seamless-m4t-large-v2), or the MoE
    family's attention and FFN blocks (`moe_parity`; its routing tallied in
    `flips`)."""
    import torch

    from repro_torch.models import encdec, hybrid, transformer as tfm
    from repro_torch.models.common import KERNELS, PLAIN

    worst: dict = {}
    xd = tfm.embed_tokens(cfg, params, tok)
    if cfg.family == "audio":
        x = batch["frames"]
        positions = tfm.positions_for(x)
        for lp in params["enc_layers"]:
            got = encdec.enc_layer(cfg, KERNELS, lp, x, positions)
            check_layer("encoder layer", got, encdec.enc_layer(cfg, PLAIN, lp, x, positions),
                        worst)
            x = got
        enc_out = KERNELS.rms_norm(x, params["enc_norm"], cfg.norm_eps)
        x = tfm.embed_tokens(cfg, params, forward_batch(cfg, batch, fed)["tokens"])
        positions = tfm.positions_for(x)
        for i, lp in enumerate(params["dec_layers"]):
            k_c, v_c, ck, cv = (cache[name][i] for name in ("k", "v", "cross_k", "cross_v"))
            blocks = (
                ("decoder self-attention",
                 lambda ops, x, lp=lp: encdec.self_block_full(cfg, ops, lp, x, positions)[0],
                 lambda ops, x, lp=lp, k_c=k_c, v_c=v_c: encdec.self_block_decode(
                     cfg, ops, lp, x, k_c.clone(), v_c.clone(), cur_len)[0]),
                ("cross-attention",
                 lambda ops, x, lp=lp: encdec.cross_block_full(cfg, ops, lp, x, enc_out),
                 lambda ops, x, lp=lp, ck=ck, cv=cv: encdec.cross_block_decode(
                     cfg, ops, lp, x, ck, cv)),
                ("decoder MLP", lambda ops, x, lp=lp: encdec.mlp_block(cfg, ops, lp, x),
                 lambda ops, x, lp=lp: encdec.mlp_block(cfg, ops, lp, x)))
            for what, full, step in blocks:
                got = full(KERNELS, x)
                check_layer(f"{what} (teacher-forced)", got, full(PLAIN, x), worst)
                outs = [step(ops, xd) for ops in (KERNELS, PLAIN)]
                check_layer(f"{what} (decode)", *outs, worst)
                x, xd = got, outs[0]
        torch.cuda.synchronize()
        return worst
    x = embed_inputs(cfg, params, batch)
    positions = tfm.positions_for(x)
    if cfg.family == "moe":
        moe_parity(cfg, params, x, xd, positions, cache, cur_len, worst, flips)
        torch.cuda.synchronize()
        return worst

    def attn_pair(lp, k_cache, v_cache, x, xd, tag):
        got, _ = tfm.layer_full(cfg, KERNELS, lp, x, positions)
        check_layer(f"{tag} (prefill)", got, tfm.layer_full(cfg, PLAIN, lp, x, positions)[0],
                    worst)
        outs = [tfm.layer_decode(cfg, ops, lp, xd, k_cache.clone(), v_cache.clone(), cur_len)[0]
                for ops in (KERNELS, PLAIN)]
        check_layer(f"{tag} (decode)", *outs, worst)
        return got, outs[0]

    if cfg.family in ("dense", "vlm"):
        for i, lp in enumerate(params["layers"]):
            x, xd = attn_pair(lp, cache["k"][i], cache["v"][i], x, xd, "attention layer")
        return worst
    inner, outer, block = recurrent_kinds(cfg)
    for g, group in enumerate(params["inner"]):
        for j, lp in enumerate(group):
            got, _ = hybrid._apply_inner_full(cfg, KERNELS, inner, lp, x)
            check_layer(f"{block} block (prefill)", got,
                        hybrid._apply_inner_full(cfg, PLAIN, inner, lp, x)[0], worst)
            state = {name: a[g, j] for name, a in cache["inner"].items()}
            outs = [hybrid._apply_inner_step(cfg, ops, inner, lp, xd, state)[0]
                    for ops in (KERNELS, PLAIN)]
            check_layer(f"{block} block (decode)", *outs, worst)
            x, xd = got, outs[0]
        if outer == "a":
            x, xd = attn_pair(params["shared_attn"], cache["attn_k"][g], cache["attn_v"][g], x,
                              xd, "shared attention block")
        elif outer == "s":
            lp = params["outer"][g]
            got, _ = hybrid._apply_slstm_full(cfg, KERNELS, lp, x)
            check_layer("sLSTM block (prefill)", got,
                        hybrid._apply_slstm_full(cfg, PLAIN, lp, x)[0], worst)
            state = {name: a[g] for name, a in cache["outer"].items()}
            outs = [hybrid._apply_slstm_step(cfg, ops, lp, xd, state)[0]
                    for ops in (KERNELS, PLAIN)]
            check_layer("sLSTM block (decode)", *outs, worst)
            x, xd = got, outs[0]
    torch.cuda.synchronize()
    return worst


def layer_invariant(cfg, params, batch, fed, flips=None) -> dict:
    """The serving invariant one layer at a time, through the kernels: a
    layer's decode form at the last position S, from the state its prefill
    form left after S positions, against its full form over the S + 1
    positions at S, from the same input (limit 5e-2 of the output's scale).
    The input runs through the full forms from the embeddings, over every
    layer of the model: the prompts (after the VLM's patches) and the first
    fed token, or the enc-dec decoder's [bos, fed...], whose self- and
    cross-attention blocks are held (the encoder has no decode form, the
    MLP acts on each position alone), or the MoE family's attention and
    FFN blocks (`moe_invariant`; its routing tallied in `flips`)."""
    import torch

    from repro_torch.models import encdec, hybrid, transformer as tfm
    from repro_torch.models.common import KERNELS

    worst: dict = {}
    if cfg.family == "audio":
        x = tfm.embed_tokens(cfg, params, forward_batch(cfg, batch, fed)["tokens"])
    else:
        x = embed_inputs(cfg, params, forward_batch(cfg, batch, fed[:1]))
    B, S = x.shape[0], x.shape[1] - 1
    positions = tfm.positions_for(x)

    def split(x):  # the prefix and the last position, as the model paths see them
        return x[:, :S].contiguous(), x[:, S:].contiguous()

    def self_attn(lp, x, full_form, step_form):
        full, _ = full_form(lp, x, positions)
        prefix, last = split(x)
        _, (k, v) = full_form(lp, prefix, positions[:, :S])
        kc, vc = (torch.zeros((B, S + 1) + a.shape[2:], dtype=a.dtype, device=a.device)
                  for a in (k, v))
        kc[:, :S], vc[:, :S] = k, v
        step, _ = step_form(lp, last, kc, vc, S)
        return full, step

    def attn(lp, x):
        full, step = self_attn(lp, x, lambda lp, x, pos: tfm.layer_full(cfg, KERNELS, lp, x, pos),
                               lambda lp, x, kc, vc, n: tfm.layer_decode(cfg, KERNELS, lp, x,
                                                                         kc, vc, n))
        check_layer("attention (decode vs full)", step[:, 0], full[:, S], worst)
        return full

    if cfg.family in ("dense", "vlm"):
        for lp in params["layers"]:
            x = attn(lp, x)
        return worst
    if cfg.family == "moe":
        moe_invariant(cfg, params, x, positions, S, worst, flips)
        torch.cuda.synchronize()
        return worst
    if cfg.family == "audio":
        enc_out = encdec.encode(cfg, KERNELS, params, batch["frames"])
        for lp in params["dec_layers"]:
            full, step = self_attn(
                lp, x, lambda lp, x, pos: encdec.self_block_full(cfg, KERNELS, lp, x, pos),
                lambda lp, x, kc, vc, n: encdec.self_block_decode(cfg, KERNELS, lp, x, kc, vc, n))
            check_layer("decoder self-attention (decode vs full)", step[:, 0], full[:, S], worst)
            ck, cv = encdec.cross_kv(cfg, lp["cross"], enc_out)
            x = encdec.cross_block_full(cfg, KERNELS, lp, full, enc_out)
            step = encdec.cross_block_decode(cfg, KERNELS, lp, split(full)[1], ck, cv)
            check_layer("cross-attention (decode vs full)", step[:, 0], x[:, S], worst)
            x = encdec.mlp_block(cfg, KERNELS, lp, x)
        torch.cuda.synchronize()
        return worst
    hidden = []
    inner, outer, block = recurrent_kinds(cfg)
    for g, group in enumerate(params["inner"]):
        for lp in group:
            full, _ = hybrid._apply_inner_full(cfg, KERNELS, inner, lp, x)
            prefix, last = split(x)
            _, st = hybrid._apply_inner_full(cfg, KERNELS, inner, lp, prefix, return_state=True)
            step, _ = hybrid._apply_inner_step(cfg, KERNELS, inner, lp, last, st)
            check_layer(f"{block} block (decode vs full)", step[:, 0], full[:, S], worst)
            x = full
        hidden.append(float(x.float().abs().max()))
        if outer == "a":
            x = attn(params["shared_attn"], x)
        elif outer == "s":
            lp = params["outer"][g]
            full, _ = hybrid._apply_slstm_full(cfg, KERNELS, lp, x)
            prefix, last = split(x)
            _, st = hybrid._apply_slstm_full(cfg, KERNELS, lp, prefix)
            step, _ = hybrid._apply_slstm_step(cfg, KERNELS, lp, last, st)
            check_layer("sLSTM block (decode vs full)", step[:, 0], full[:, S], worst)
            x = full
    log(f"[decode] {cfg.name}: max |hidden| into each group's outer block "
        + ", ".join(f"{h:.4g}" for h in hidden))
    torch.cuda.synchronize()
    return worst


def invariant(got, full) -> tuple[float, float, object, object]:
    """The serving invariant's reading: max |err| of the decode logits
    against the teacher-forced forward's, the logits' scale, and per
    position whether the forward's top-2 margin exceeds twice that error
    (decisive) and whether top-1 agrees."""
    err = float((got - full).abs().max())
    top2 = full.topk(2, dim=-1).values
    decisive = (top2[..., 0] - top2[..., 1]) > 2 * err
    return err, float(full.abs().max()), decisive, got.argmax(-1) == full.argmax(-1)


def teacher_forced(model, params, batch, n0: int, fed, ops):
    """Prefill `batch` (valid length n0 after it), then decode the tokens
    `fed` one at a time through `ops`.  Returns the logits of the prefill's
    last position and of every step (B, n + 1, V) and the forward's at the
    same positions, both f32."""
    import torch

    logits, cache = model.prefill(params, batch, max_len=n0 + len(fed), ops=ops)
    steps = [logits[:, -1]]
    for i, tok in enumerate(fed):
        lg, cache = model.decode_step(params, tok, cache, n0 + i, ops=ops)
        steps.append(lg[:, 0])
    full = model.forward(params, forward_batch(model.cfg, batch, fed), ops=ops)[:, n0 - 1:]
    return torch.stack(steps, dim=1).float(), full.float()


def plain_witness(cfg, params, batch, n0: int, fed, got) -> None:
    """The serving invariant's reading through the plain math in bf16, from
    the same inputs and tokens as the kernels' bf16 one: does it miss its
    own forward as the kernels do, and how far are the kernels' decode
    logits from its?"""
    from repro_torch.models.common import PLAIN
    from repro_torch.models.model_zoo import build_model

    plain, full = teacher_forced(build_model(cfg), params, batch, n0, fed, PLAIN)
    err, scale, decisive, agree = invariant(plain, full)
    log(f"[decode] {cfg.name} plain math, bf16: vs its own forward max|err| {err:.4f} at logit "
        f"scale {scale:.3f} ({err / scale:.4g} of scale); top-1 agrees at "
        f"{int(agree.sum())}/{agree.numel()}, {int(decisive.sum())} decisive; the kernels' "
        f"decode logits vs the plain math's: max|err| {float((got - plain).abs().max()):.4f}")


def f32_witness(cfg, params32, batch, n0: int, fed, what: str = "", model32=None) -> None:
    """The serving invariant through the kernels in f32 (every kernel's f32
    route, flash attention's CUDA-core one and ssd_scan's three-part one
    included; each the model's layers call must launch): it must hold at
    the decisive positions, and an attention model (dense, VLM, enc-dec)
    must have some, so the check can fail; the recurrent models' f32
    forwards are themselves too sensitive for that, which the last reading
    shows: the f32 forward's move when the embeddings are scaled by
    1 + 2^-22 (two ulps).  Their whole-model check is `cache_walk`'s.  The
    MoE family's forward drops other tokens at capacity than its prefill
    and steps do, so it need have no decisive position either; its walks
    run in f32 too, where no routing decision may flip between the kernels
    and the plain math, or between a block's decode and full forms.
    `params32` are f32 parameters of `cfg` (scaled in place), `model32`
    their model where it is not `build_model` of `cfg` in f32 (a depth
    cut)."""
    import dataclasses

    import torch

    from repro_torch.models.common import KERNELS
    from repro_torch.models.model_zoo import build_model

    arch = cfg.name
    if model32 is None:
        model32 = build_model(dataclasses.replace(cfg, dtype=torch.float32))
    cfg32 = model32.cfg
    before = read_counts()
    got32, full32 = teacher_forced(model32, params32, batch, n0, fed, KERNELS)
    if cfg.family == "moe":
        _, cache = model32.prefill(params32, batch, max_len=n0 + 1)
        flips: dict = {}
        worst = layer_invariant(cfg32, params32, batch, fed, flips)
        worst.update(layer_parity(cfg32, params32, batch, fed, cache, fed[0],
                                  torch.tensor(n0, device=fed[0].device), flips))
        log(f"[decode] {arch} kernels, f32{what}: per block, decode vs full and kernels vs "
            f"plain, worst max|err|/max|ref|: "
            + ", ".join(f"{k} {v:.4g}" for k, v in worst.items()) + " (limit 5e-2)")
        check_flips(arch, flips, 0.0, f" f32{what}")
        del cache
    params32["embed"].mul_(1 + 2.0 ** -22)
    nudged = model32.forward(params32, forward_batch(cfg, batch, fed), ops=KERNELS)[:, n0 - 1:]
    nudged = nudged.float()
    torch.cuda.synchronize()
    launches = {k: v - before[k] for k, v in read_counts().items() if k in path_kernels(cfg)}
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"{arch} f32: {name}'s f32 route was not launched")
    log(f"[decode] {arch} kernels, f32{what}: f32 routes launched "
        + ", ".join(f"{k} {v} times" for k, v in launches.items()))
    err, scale, decisive, agree = invariant(got32, full32)
    log(f"[decode] {arch} kernels, f32{what}: vs the teacher-forced forward max|err| {err:.4g} "
        f"at logit scale {scale:.3f} ({err / scale:.4g} of scale); top-1 agrees at "
        f"{int(agree.sum())}/{agree.numel()}, {int(decisive.sum())} decisive; the f32 "
        f"forward moves by {rel_err(nudged, full32):.4g} of scale when the embeddings are "
        f"scaled by 1 + 2^-22")
    if not torch.isfinite(got32).all():
        raise AssertionError(f"{arch} f32: non-finite decode logits")
    if cfg.family in ("dense", "vlm", "audio") and not bool(decisive.any()):
        raise AssertionError(f"{arch} f32: no decisive position")
    if not bool(agree[decisive].all()):
        raise AssertionError(f"{arch} f32: top-1 disagrees with the forward at a decisive "
                             f"position")


def model_for(arch: str, n_layers: int | None = None, dtype=None):
    """(config, model) of `arch` at full width: at its full depth, or at its
    first `n_layers` layers (deepseek-v3's dense ones first, then as many
    MoE layers as the cut leaves, none for a cut within its dense layers;
    the enc-dec's first `n_layers` encoder and first `n_layers` decoder
    layers), whose templates keep the full model's per-layer init formulas
    (the stacked fan-in of all its layers); in `dtype` where given."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models.model_zoo import Model, build_model

    cfg = get_config(arch)
    if dtype is not None:
        cfg = dataclasses.replace(cfg, dtype=dtype)
    model = build_model(cfg)
    if n_layers is None or n_layers == cfg.n_layers:
        return cfg, model
    cut = dataclasses.replace(cfg, n_layers=n_layers)
    defs = dict(model.defs)
    if "layers" in defs:
        defs["layers"] = defs["layers"][:n_layers]
    elif "enc_layers" in defs:
        cut = dataclasses.replace(cut, encoder_layers=n_layers)
        defs["enc_layers"] = defs["enc_layers"][:n_layers]
        defs["dec_layers"] = defs["dec_layers"][:n_layers]
    elif "inner" in defs:  # the hybrid and xLSTM: whole groups of the pattern
        period = len(defs["inner"][0]) + ("shared_attn" in defs or "outer" in defs)
        if n_layers % period:
            raise ValueError(f"{arch}: a cut to {n_layers} layers splits a group of {period}")
        cut = dataclasses.replace(cut, ssm_pattern=cfg.ssm_pattern[:n_layers])
        defs["inner"] = defs["inner"][:n_layers // period]
        if "outer" in defs:
            defs["outer"] = defs["outer"][:n_layers // period]
    elif n_layers > cfg.dense_layers:
        defs["moe_layers"] = defs["moe_layers"][:n_layers - cfg.dense_layers]
    else:
        cut = dataclasses.replace(cut, dense_layers=n_layers)
        defs["dense_layers"] = defs["dense_layers"][:n_layers]
        defs["moe_layers"] = []
    return cut, Model(cfg=cut, defs=defs, mod=model.mod)


def f32_witness_cut(cfg, n_layers: int, batch, n0: int, fed, dev) -> None:
    """`f32_witness` at full width and `n_layers` layers, for a model whose
    f32 copy does not fit on the card beside its bf16 weights: run after
    those are freed, on an f32 init of its own from SEED, with the full
    model's per-layer init formulas (the stacked fan-in of all its
    layers)."""
    import torch

    from repro_torch.configs import get_config

    cut, model32 = model_for(cfg.name, n_layers, torch.float32)
    params32 = model32.init(torch.Generator(device=dev).manual_seed(SEED))
    n_params = sum(p.numel() for p in params32.parameters())
    log(f"[decode] {cfg.name} f32 witness: {n_layers} of {get_config(cfg.name).n_layers} "
        f"layers at full width ({n_params / 1e9:.3f} B params in f32, "
        f"{n_params * 4 / 1e9:.2f} GB), an init of its own")
    f32_witness(cut, params32, batch, n0, fed, what=f" ({n_layers} layers)", model32=model32)


def cache_walk(cfg, model, params, batch, n0: int, tok) -> dict:
    """The model's bookkeeping at full width, a whole-model check that can
    fail where the invariant cannot: a fresh `prefill` and one
    `decode_step` of `tok`, through the kernels, against the same layer
    functions walked in order with each layer's state kept apart (the dense
    and VLM layer l; group g's inner block j (Mamba2, mLSTM) and its outer
    block, the shared attention block or its sLSTM block; the enc-dec's
    encoder, each decoder layer's cross K/V and its BOS step; the MoE
    family's layers, MLA's compressed cache).
    Both take the same trajectory, so they agree to rounding: every cache
    slot after the prefill and after the step, and both logits, within 1e-3
    of their scale."""
    import torch

    from repro_torch.models import encdec, hybrid, transformer as tfm
    from repro_torch.models.common import KERNELS

    logits, cache = model.prefill(params, batch, max_len=n0 + 1)
    pre = {k: ({n: a.clone() for n, a in v.items()} if isinstance(v, dict) else v.clone())
           for k, v in cache.items()}
    step, cache = model.decode_step(params, tok, cache, n0)
    worst: dict = {}

    def same(what, got, want):
        rel = rel_err(got, want)
        worst[what] = max(worst.get(what, 0.0), rel)
        if not rel <= 1e-3:
            raise AssertionError(f"{cfg.name} {what}: the model's is {rel:.4g} of scale from "
                                 f"the layer walk's")

    def head(h):
        return tfm.unembed(cfg, params, KERNELS.rms_norm(h, params["final_norm"], cfg.norm_eps))

    xd = tfm.embed_tokens(cfg, params, tok)
    if cfg.family == "audio":
        enc_out = batch["frames"]
        positions = tfm.positions_for(enc_out)
        for lp in params["enc_layers"]:
            enc_out = encdec.enc_layer(cfg, KERNELS, lp, enc_out, positions)
        enc_out = KERNELS.rms_norm(enc_out, params["enc_norm"], cfg.norm_eps)
        x = tfm.embed_tokens(cfg, params, torch.full_like(tok, encdec.BOS_TOKEN))
        for i, lp in enumerate(params["dec_layers"]):
            ck, cv = encdec.cross_kv(cfg, lp["cross"], enc_out)
            same("cross K/V after prefill", pre["cross_k"][i], ck)
            same("cross K/V after prefill", pre["cross_v"][i], cv)
            kc, vc = torch.zeros_like(pre["k"][i]), torch.zeros_like(pre["v"][i])
            x, _ = encdec.dec_layer_decode(cfg, KERNELS, lp, x, kc, vc, ck, cv, 0)
            same("KV cache after prefill (the BOS step)", pre["k"][i], kc)
            same("KV cache after prefill (the BOS step)", pre["v"][i], vc)
            xd, _ = encdec.dec_layer_decode(cfg, KERNELS, lp, xd, kc, vc, ck, cv, n0)
            same("KV cache after the step", cache["k"][i], kc)
            same("KV cache after the step", cache["v"][i], vc)
            same("cross K/V after the step", cache["cross_k"][i], ck)
        same("prefill logits", logits, head(x))
        same("step logits", step, head(xd))
        torch.cuda.synchronize()
        return worst

    x = embed_inputs(cfg, params, batch)
    positions = tfm.positions_for(x)
    S = x.shape[1]

    def attn(lp, x, xd, k_pre, v_pre, k_post, v_post):
        x, (k, v) = tfm.layer_full(cfg, KERNELS, lp, x, positions)
        same("KV cache after prefill", k_pre[:, :S], k)
        same("KV cache after prefill", v_pre[:, :S], v)
        kc, vc = torch.zeros_like(k_post), torch.zeros_like(v_post)
        kc[:, :S], vc[:, :S] = k, v
        xd, _ = tfm.layer_decode(cfg, KERNELS, lp, xd, kc, vc, S)
        same("KV cache after the step", k_post, kc)
        same("KV cache after the step", v_post, vc)
        return x, xd

    if cfg.family in ("dense", "vlm"):
        for i, lp in enumerate(params["layers"]):
            x, xd = attn(lp, x, xd, pre["k"][i], pre["v"][i], cache["k"][i], cache["v"][i])
    elif cfg.family == "moe":
        for i, lp in enumerate(model.mod.layers(params)):
            x, kv = model.mod.layer_full(cfg, KERNELS, lp, x, positions)
            fresh = []
            for c_pre, a in zip(layer_cache(cfg, pre, i), kv):
                same("cache after prefill", c_pre[:, :S], a)
                fresh.append(torch.zeros_like(c_pre))
                fresh[-1][:, :S] = a
            xd, _ = model.mod.layer_decode(cfg, KERNELS, lp, xd, *fresh, S)
            for c_post, c in zip(layer_cache(cfg, cache, i), fresh):
                same("cache after the step", c_post, c)
    else:
        inner, outer, block = recurrent_kinds(cfg)
        for g, group in enumerate(params["inner"]):
            for j, lp in enumerate(group):
                x, st = hybrid._apply_inner_full(cfg, KERNELS, inner, lp, x, return_state=True)
                for name, a in st.items():
                    same(f"{block} state after prefill", pre["inner"][name][g, j], a)
                xd, st = hybrid._apply_inner_step(cfg, KERNELS, inner, lp, xd, st)
                for name, a in st.items():
                    same(f"{block} state after the step", cache["inner"][name][g, j], a)
            if outer == "a":
                x, xd = attn(params["shared_attn"], x, xd, pre["attn_k"][g], pre["attn_v"][g],
                             cache["attn_k"][g], cache["attn_v"][g])
            elif outer == "s":
                lp = params["outer"][g]
                x, st = hybrid._apply_slstm_full(cfg, KERNELS, lp, x)
                for name, a in st.items():
                    same("sLSTM state after prefill", pre["outer"][name][g], a)
                xd, st = hybrid._apply_slstm_step(cfg, KERNELS, lp, xd, st)
                for name, a in st.items():
                    same("sLSTM state after the step", cache["outer"][name][g], a)

    same("prefill logits", logits, head(x[:, -1:].contiguous()))
    same("step logits", step, head(xd))
    torch.cuda.synchronize()
    return worst


def decode_run(arch: str, B: int, S: int, n: int, params, dev, parent) -> dict:
    """Prefill B requests of S prompt tokens (S frames for the enc-dec),
    then n greedy decode steps, through the kernels; hold each step to the
    teacher-forced forward.  A model in `DEPTH_CUTS` runs at that depth.
    Returns the path's launch counts and what the f32 witness needs if
    `F32_WITNESS_LAYERS` cuts it (run after the caller frees the
    parameters)."""
    import copy

    import torch

    from repro_torch.configs import get_config

    cfg, model = model_for(arch, DEPTH_CUTS.get(arch))
    t0 = time.perf_counter()
    if params is None:
        params = model.init(torch.Generator(device=dev).manual_seed(SEED))
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in params.parameters())
    batch, n0 = decode_inputs(cfg, B, S, dev)
    inputs = ("frame embeddings" if cfg.family == "audio" else
              f"tokens after {cfg.frontend_tokens} patch embeddings" if cfg.family == "vlm"
              else "tokens")
    log(f"[decode] {arch}: {cfg.n_layers} layers"
        + (f" of {get_config(arch).n_layers} (DEPTH_CUTS: the depth that fits on the card)"
           if arch in DEPTH_CUTS else "")
        + (f" ({cfg.dense_layers} dense, {cfg.n_layers - cfg.dense_layers} MoE, the MTP module)"
           if cfg.mla else "")
        + (f", {cfg.n_experts} experts top-{cfg.top_k} + {cfg.n_shared_experts} shared"
           if cfg.n_experts else "")
        + (f" + {cfg.encoder_layers} encoder layers" if cfg.encoder_layers else "")
        + f", d_model {cfg.d_model}, {n_params / 1e9:.3f} B params on {dev} "
        f"({n_params * params['embed'].element_size() / 1e9:.2f} GB, "
        f"{time.perf_counter() - t0:.1f} s); {B} requests x {S} {inputs}, {n} greedy steps "
        f"from cache position {n0}"
        + (f"; its f32 witness at {F32_WITNESS_LAYERS[arch]} layers (these {cfg.n_layers} in "
           f"f32: {n_params * 4 / 1e9:.2f} GB)" if arch in F32_WITNESS_LAYERS else ""))
    want = expected_launches(cfg)

    with torch.inference_mode():
        # warm-up: one short prefill and one decode step
        warm, w0 = decode_inputs(cfg, B, 16, dev, seed=SEED + 2)
        lg, wc = model.prefill(params, warm, max_len=w0 + 1)
        model.decode_step(params, lg[:, -1].argmax(-1, keepdim=True), wc, w0)
        del lg, wc
        torch.cuda.synchronize()
        reset_counts()
        with (measured(f"{arch} prefill", (params, batch), prefill_trace(model, batch, n0 + n))
              if arch in DRY_RUN_PREFILLS else contextlib.nullcontext()):
            t0 = time.perf_counter()
            logits, cache = model.prefill(params, batch, max_len=n0 + n)
            torch.cuda.synchronize()
            prefill_s = time.perf_counter() - t0
        pre = read_counts()
        reset_counts()
        tok = logits[:, -1].argmax(-1, keepdim=True)
        cur = torch.tensor(n0, dtype=torch.int32, device=dev)
        fed, steps = [], [logits[:, -1]]
        t0 = time.perf_counter()
        for _ in range(n):
            fed.append(tok)
            lg, cache = model.decode_step(params, tok, cache, cur)
            steps.append(lg[:, 0])
            tok = lg[:, 0].argmax(-1, keepdim=True)
            cur = cur + 1
        torch.cuda.synchronize()
        decode_s = time.perf_counter() - t0
        dec = read_counts()
        sync_free_step(model, params, fed[-1], cache, cur - 1)

        got_counts = dict(flash=pre["flash_attention"], prefill_decode=pre["decode_attention"],
                          step=dec["decode_attention"] / n, scan=pre["ssd_scan"])
        if got_counts != want:
            raise AssertionError(f"{arch}: launches {got_counts} (flash attention and decode "
                                 f"attention in the prefill, decode attention a step, ssd_scan "
                                 f"in the prefill), expected {want}")
        for name in path_kernels(cfg):
            if pre[name] + dec[name] <= 0:
                raise AssertionError(f"{name} was not launched on the decode path")
        profile_prefill(model, params, batch, n0 + n, arch, parent)

        # the serving invariant: prefill + step-by-step decode equals the
        # teacher-forced forward over the same tokens
        full = model.forward(params, forward_batch(cfg, batch, fed))[:, n0 - 1:].float()
        got = torch.stack(steps, dim=1).float()
        torch.cuda.synchronize()
        if got.shape != full.shape or not torch.isfinite(got).all():
            raise AssertionError(f"decode logits {tuple(got.shape)} (forward "
                                 f"{tuple(full.shape)}), finite {bool(torch.isfinite(got).all())}")
        err, scale, decisive, agree = invariant(got, full)
        log(f"[decode] {arch}: prefill {prefill_s * 1e3:.3f} ms, decode {decode_s * 1e3:.3f} ms "
            f"= {decode_s / n * 1e3:.3f} ms a step ({B / (decode_s / n):.1f} tokens/s)")
        log(f"[decode] {arch}: launches in prefill {pre}, in the decode loop {dec}")
        log(f"[decode] {arch}: vs the teacher-forced forward, max|err| {err:.4f} at logit "
            f"scale {scale:.3f} ({err / scale:.4g} of scale); top-1 agrees at "
            f"{int(agree.sum())}/{agree.numel()} positions, {int(decisive.sum())} decisive; "
            f"greedy tokens {torch.cat(fed, dim=1)[0, :8].tolist()}...")
        if not bool(agree[decisive].all()):
            raise AssertionError(f"{arch}: top-1 disagrees with the forward at a decisive "
                                 f"position")
        del full
        plain_witness(cfg, params, batch, n0, fed, got)
        if arch not in F32_WITNESS_LAYERS:
            f32_witness(cfg, copy.deepcopy(params).float(), batch, n0, fed)

        flips: dict = {}  # the MoE family's routing decisions, tallied by the walks
        worst = layer_invariant(cfg, params, batch, fed, flips)
        log(f"[decode] {arch}: serving invariant per layer through the kernels, worst "
            f"max|err|/max|ref|: " + ", ".join(f"{k} {v:.4g}" for k, v in worst.items())
            + " (limit 5e-2)")
        last = torch.tensor(n0 + n - 1, dtype=torch.int32, device=dev)
        worst = layer_parity(cfg, params, batch, fed, cache, fed[-1], last, flips)
        log(f"[decode] {arch}: per layer through the kernels vs plain math, same input, "
            f"worst max|err|/max|ref|: "
            + ", ".join(f"{k} {v:.4g}" for k, v in worst.items()) + " (limit 5e-2)")
        if flips:
            check_flips(arch, flips, FLIP_LIMIT)
        worst = cache_walk(cfg, model, params, batch, n0, fed[0])
        log(f"[decode] {arch}: prefill + one step vs the layer walk, every cache slot and "
            f"both logits, worst max|err|/max|ref|: "
            + ", ".join(f"{k} {v:.4g}" for k, v in worst.items()) + " (limit 1e-3)")
        if cfg.mtp:
            mtp_check(model, params, forward_batch(cfg, batch, fed))

        # device busy share of the decode loop: replay the last steps, their
        # positions on the card before the window (a position made from a
        # host int inside it would be a blocking copy, a host wait a step)
        first = n0 + n - PROFILED_STEPS
        positions = [torch.tensor(first + i, dtype=torch.int32, device=dev)
                     for i in range(PROFILED_STEPS)]

        def replay():
            for i in range(PROFILED_STEPS):
                model.decode_step(params, fed[first - n0 + i], cache, positions[i])

        share = busy_share(replay, "decode")
        log(f"[decode] {arch}: device busy share over {PROFILED_STEPS} decode steps: "
            + ("not measured (profiler recorded no device time)" if share is None
               else f"{share:.4f}"))
    return {k: pre[k] + dec[k] for k in pre}, (cfg, batch, n0, fed)


def sync_free_step(model, params, tok, cache, cur) -> None:
    """A decode step (the last one again: it rewrites the same cache row)
    with CUDA's sync debug mode at "error": an op that makes the host wait
    for the card (a read of a value to the host, a mask index, a blocking
    copy) raises, so the loop can queue its steps ahead of the card."""
    import torch

    torch.cuda.set_sync_debug_mode("error")
    try:
        model.decode_step(params, tok, cache, cur)
    finally:
        torch.cuda.set_sync_debug_mode(0)


def mtp_check(model, params, batch) -> None:
    """The MTP head's forward (`deepseek.forward_with_mtp`) through the
    kernels over the teacher-forced tokens: its next-token logits are the
    model's forward (1e-3 of scale), its MTP logits finite, of one position
    fewer, and its MTP layer runs flash attention once more."""
    import torch

    from repro_torch.models import deepseek
    from repro_torch.models.common import KERNELS

    cfg, tokens = model.cfg, batch["tokens"]
    before = read_counts()["flash_attention"]
    logits, mtp = deepseek.forward_with_mtp(cfg, KERNELS, params, tokens)
    flash = read_counts()["flash_attention"] - before
    full = model.forward(params, batch)
    torch.cuda.synchronize()
    rel = rel_err(logits, full)
    B, T = tokens.shape
    log(f"[decode] {cfg.name} MTP head over {tuple(tokens.shape)} tokens: logits "
        f"{tuple(mtp.shape)}, max |logit| {float(mtp.float().abs().max()):.4g}; its next-token "
        f"logits vs the forward's {rel:.4g} of scale (limit 1e-3); flash attention {flash} "
        f"launches ({cfg.n_layers} layers + the MTP layer)")
    if tuple(mtp.shape) != (B, T - 1, cfg.padded_vocab) or not torch.isfinite(mtp).all():
        raise AssertionError(f"MTP logits {tuple(mtp.shape)}, finite "
                             f"{bool(torch.isfinite(mtp).all())}")
    if not rel <= 1e-3 or flash != cfg.n_layers + 1:
        raise AssertionError(f"MTP forward: next-token logits {rel:.4g} of scale from the "
                             f"forward's, {flash} flash attention launches")


def profile_prefill(model, params, batch, max_len: int, arch: str, parent) -> None:
    """The device busy share and top kernels of one prefill (after the timed
    one, so nothing is built or warmed inside the window); with `--parent`,
    the same prefill through the other tree's kernels, in turns (this
    tree's, the parent's, twice)."""
    from repro_torch.models.common import KERNELS

    variants = [("this tree's kernels", lambda: contextlib.nullcontext(KERNELS))]
    gap = None if parent is None else parent_gap(parent, model)
    if gap is not None:
        log(f"[prefill] {arch}: not run through the parent's kernels: {gap}")
    elif parent is not None:
        variants.append(("the parent's kernels", lambda: parent_kernels(parent)))
    shape = {k: tuple(v.shape) for k, v in batch.items()}
    for what, swap in variants * (2 if len(variants) > 1 else 1):
        with swap() as ops:
            model.prefill(params, batch, max_len=max_len, ops=ops)  # warm
            share = busy_share(lambda: model.prefill(params, batch, max_len=max_len, ops=ops),
                               "prefill")
        log(f"[prefill] {arch}, {what}: device busy share over one prefill of {shape}: "
            + ("not measured (profiler recorded no device time)" if share is None
               else f"{share:.4f}"))


def parent_gap(parent: dict, model) -> str | None:
    """Why the other tree's kernels cannot run `model`'s prefill, or None.
    The enc-dec is the one family whose path calls `Ops.noncausal_attention`,
    which needs flash attention's `causal` keyword (and Sq != Sk); a tree
    from before that has its kernel without it."""
    import inspect

    fn = getattr(parent.get("flash_attention"), "attention_bthd", None)
    if (model.cfg.family == "audio" and fn is not None
            and "causal" not in inspect.signature(fn).parameters):
        return ("its flash_attention.attention_bthd takes no `causal`, which the enc-dec's "
                "non-causal attention needs")
    return None


@contextlib.contextmanager
def parent_kernels(parent: dict):
    """Within: every function of this tree's kernel wrapper modules that
    the other tree's module of the same kernel also defines is the other's.
    Yields `KERNELS` with each field that is such a function swapped the
    same way (a field that calls a wrapper through its module, as the
    attention does, follows by itself).  The other tree's `ssd_scan_bthd`
    gets q and k expanded to v's heads (a view): Mamba2 hands this tree's
    one head, which a tree before the one-head route refuses, and its own
    model expanded them so."""
    import dataclasses
    import inspect

    from repro_torch.models.common import KERNELS

    saved = []
    try:
        for name, other in parent.items():
            mine = sys.modules.get(f"repro_torch.kernels.{name}.ops")
            for attr, fn in list(vars(mine).items()) if mine else []:
                if (inspect.isfunction(fn) and fn.__module__ == mine.__name__
                        and inspect.isfunction(getattr(other, attr, None))):
                    saved.append((mine, attr, fn))
                    setattr(mine, attr, getattr(other, attr) if attr != "ssd_scan_bthd"
                            else heads_expanded(getattr(other, attr)))
        fields = {f.name: getattr(KERNELS, f.name) for f in dataclasses.fields(KERNELS)}
        yield dataclasses.replace(KERNELS, **{
            k: getattr(sys.modules[fn.__module__], fn.__name__) for k, fn in fields.items()
            if fn.__module__.startswith("repro_torch.kernels.")})
    finally:
        for mod, attr, fn in reversed(saved):
            setattr(mod, attr, fn)


def heads_expanded(scan):
    """`scan` (an `ssd_scan_bthd`) called with q and k expanded to v's heads."""
    def call(q, k, v, *args, **kwargs):
        B, T, NH = v.shape[:3]
        return scan(q.expand(B, T, NH, q.shape[-1]), k.expand(B, T, NH, k.shape[-1]), v, *args,
                    **kwargs)

    return call


# a run's peak memory before a call measured on its own (`measured`),
# which resets the card's peak statistics: `run_peak` is the larger
_PEAKS_BEFORE = {"allocated": 0, "reserved": 0}
# the calls measured for phase 7, by name: their peak on the card, launches
# and the meta trace of the same call (`measured`)
DRY_RUN: dict = {}


def reset_peak() -> None:
    import torch

    torch.cuda.reset_peak_memory_stats()
    _PEAKS_BEFORE.update(allocated=0, reserved=0)


def run_peak(kind: str = "allocated") -> int:
    """The card's peak memory (allocated or reserved) since `reset_peak`,
    across any call `measured` in between."""
    import torch

    now = (torch.cuda.max_memory_allocated() if kind == "allocated"
           else torch.cuda.max_memory_reserved())
    return max(now, _PEAKS_BEFORE[kind])


@contextlib.contextmanager
def measured(name: str, inputs, trace):
    """The block's calls measured for phase 7 as `name`: their peak
    allocated memory on the card, less what was allocated before them and
    is none of their `inputs` (earlier phases' leftovers, cached buffers),
    so that it compares with the meta trace's peak, which starts from the
    inputs alone; and each kernel's launches.  `trace()` runs the same
    call on the meta device (`hlo_analysis.analyze_traced`).  The card's
    peak statistics are reset for the block; `run_peak` keeps the run's."""
    import torch

    from repro_torch.launch import hlo_analysis

    torch.cuda.synchronize()
    for kind in _PEAKS_BEFORE:
        _PEAKS_BEFORE[kind] = run_peak(kind)
    held = hlo_analysis.storage_bytes(hlo_analysis.tree_tensors(inputs))
    before, counts = torch.cuda.memory_allocated(), read_counts()
    torch.cuda.reset_peak_memory_stats()
    yield
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    DRY_RUN[name] = dict(measured=peak - (before - held), peak=peak, before=before, held=held,
                         launches={k: v - counts[k] for k, v in read_counts().items()
                                   if v != counts[k]}, trace=trace)


def meta_like(batch: dict) -> dict:
    import torch

    return {k: torch.empty_like(v, device="meta") for k, v in batch.items()}


def prefill_trace(model, batch: dict, max_len: int):
    """The meta trace of `model.prefill(params, batch, max_len=max_len)`
    under inference mode, on `model.shapes()`."""
    import torch

    from repro_torch.launch import hlo_analysis

    shapes = meta_like(batch)

    def prefill(params, b):
        with torch.inference_mode():
            return model.prefill(params, b, max_len=max_len)

    return lambda: hlo_analysis.analyze_traced(prefill, model.shapes(), shapes)


def train_trace(model, opt_cfg, batch: dict):
    """The meta trace of one eager step of phase 6's train step (remat,
    `TRAIN_ACCUM` micro-batches) on `model.shapes()` and its zero moments."""
    from repro_torch.launch import hlo_analysis
    from repro_torch.training import init_opt_state, make_train_step

    shapes = meta_like(batch)

    def trace():
        params = model.shapes()
        step = make_train_step(model, opt_cfg, remat=True, accum_steps=TRAIN_ACCUM)
        return hlo_analysis.analyze_traced(step, params, init_opt_state(params, opt_cfg),
                                           shapes)

    return trace


def memory_line(arch: str, what: str) -> str:
    import torch

    peak = run_peak()
    total = torch.cuda.get_device_properties(torch.cuda.current_device()).total_memory
    return (f"[decode] {arch}: peak device memory {what} {peak / 2**30:.2f} GiB allocated of "
            f"the card's {total / 2**30:.2f} GiB ({peak / total:.1%})")


def phase_decode(serving: list, dev, parent) -> dict:
    """Every run of DECODE_RUNS; returns the decode path's launch counts
    (each run counted from 0 before its prefill to after its decode loop).
    `serving` holds the serve phase's live session, whose stablelm-3b
    parameters the first run reuses; the session is taken out of it and
    released after that run, so nothing of it stays on the card.  A model in
    `F32_WITNESS_LAYERS` has its f32 witness after its bf16 parameters are
    freed.  Logs each run's peak device memory."""
    import gc

    import torch

    total: dict = {}
    for arch, B, S, n in DECODE_RUNS:
        reset_peak()
        params = (serving[0].dataplane.dispatcher.executors[0][0].params if arch == MODEL
                  else None)
        counts, witness = decode_run(arch, B, S, n, params, dev, parent)
        log(memory_line(arch, "over the run"))
        total = {k: total.get(k, 0) + v for k, v in counts.items()}
        del params
        if arch == MODEL and serving:
            release(serving.pop())
            log(f"[decode] the serve phase's session released: "
                f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated, "
                f"{torch.cuda.memory_reserved() / 2**30:.2f} GiB reserved")
        gc.collect()
        torch.cuda.empty_cache()
        if arch in F32_WITNESS_LAYERS:
            reset_peak()
            with torch.inference_mode():
                f32_witness_cut(witness[0], F32_WITNESS_LAYERS[arch], *witness[1:], dev)
            log(memory_line(arch, "over the f32 witness"))
            gc.collect()
            torch.cuda.empty_cache()
    return total


# ----------------------------------------------------------------- phase 6


def train_pipe(cfg, global_batch: int, seed: int):
    """The `TokenPipeline` of a train run of `cfg`: sequences of TRAIN_SEQ
    tokens, or the enc-dec's text of ENCDEC_TRAIN_TEXT (its TRAIN_SEQ are
    frames)."""
    from repro_torch.data.tokens import TokenPipeline

    seq = ENCDEC_TRAIN_TEXT if cfg.family == "audio" else TRAIN_SEQ
    return TokenPipeline(vocab=cfg.vocab, seq_len=seq, global_batch=global_batch, seed=seed)


def train_batch(cfg, pipe, step: int, dev) -> dict:
    """Step `step`'s batch on the card: the pipeline's tokens, and for the
    enc-dec TRAIN_SEQ frame embeddings a sequence, normal in bf16 from a
    generator on the card seeded with the pipeline's seed plus the step (as
    phase 5 makes its frames)."""
    import torch

    batch = {k: torch.as_tensor(v, device=dev) for k, v in pipe.batch_for(step).items()}
    if cfg.family == "audio":
        g = torch.Generator(device=dev).manual_seed(pipe.seed + step)
        batch["frames"] = torch.randn(pipe.global_batch, TRAIN_SEQ, cfg.d_model, generator=g,
                                      device=dev).to(cfg.dtype)
    return batch


def train_expect(cfg) -> dict:
    """The kernel launches of one train step, from the config: each
    micro-batch runs every block's forward twice (remat's recompute, a
    layer or a group at a time) and each backward kernel once.  Every block
    has two norms (a dense layer's and the shared attention block's before
    attention and the MLP; a Mamba2 block's pre-norm and gated norm; an
    mLSTM or sLSTM block's pre-norm and output norm; an enc-dec encoder
    layer's), an enc-dec decoder layer three (before its self-attention,
    cross-attention and MLP), and the final norm (and the enc-dec's encoder
    norm) one outside the remat; each attention layer (or application of
    the shared block; the enc-dec's encoder layer, and its decoder layer's
    self- and cross-attention, two) one flash forward with its LSE and one
    flash backward; each Mamba2 or mLSTM block one ssd_scan forward and one
    backward."""
    if cfg.family == "audio":
        E, L = cfg.encoder_layers, cfg.n_layers
        norms, outer, n_attn, n_scan = 2 * E + 3 * L, 2, E + 2 * L, 0
    else:
        L = cfg.n_layers
        pattern = cfg.ssm_pattern or "a" * L
        norms, outer = 2 * L, 1
        n_attn, n_scan = pattern.count("a"), sum(pattern.count(c) for c in "mM")
    return {"rmsnorm": TRAIN_ACCUM * (2 * norms + outer),
            "rmsnorm_backward": TRAIN_ACCUM * (norms + outer),
            "flash_attention_forward_lse": TRAIN_ACCUM * 2 * n_attn,
            "flash_attention_backward": TRAIN_ACCUM * n_attn,
            "flash_attention": 0,
            "ssd_scan": TRAIN_ACCUM * 2 * n_scan,
            "ssd_scan_backward": TRAIN_ACCUM * n_scan}


def train_run(what: str, model, step, opt_cfg, batches, dev, steps: int = TRAIN_STEPS,
              measure: str | None = None, trace=None, profile: bool = True) -> dict:
    """One run of phase 6a: the state built on the card from `SEED`,
    `steps` steps of `step` over `batches`, then, where `profile`, one
    more step under the profiler.  Logs each step's loss, gradient norm
    and time, the peak memory, ms a step and tokens/s (and the enc-dec's
    frames/s) over the steps after the first, the launches of each kernel a
    step and the profiled step's busy share and host launch calls.  Returns
    the losses and gradient norms (every step's, the profiled one's last),
    the final parameters copied to the host, the launch counters' advance
    over the counted steps, the memory reserved at the end and the
    readings (with the profiled step's device time by kernel).  `measure`:
    the name under which its second step is `measured` for phase 7,
    against `trace` (by default `train_trace` of that step)."""
    import math

    import torch

    from repro_torch.training import init_opt_state
    from repro_torch.training.tree import leaves, paths

    reset_peak()
    params = model.init(torch.Generator(device=dev).manual_seed(SEED))
    opt = init_opt_state(params, opt_cfg)
    torch.cuda.synchronize()
    reset_counts()
    times, losses, gnorms = [], [], []
    for i in range(steps):
        with (measured(measure, (params, opt, batches[i]),
                       trace or train_trace(model, opt_cfg, batches[i]))
              if measure and i == 1 else contextlib.nullcontext()):
            t0 = time.perf_counter()
            params, opt, metrics = step(params, opt, batches[i])
            loss, gnorm = float(metrics["loss"]), float(metrics["grad_norm"])
            times.append(time.perf_counter() - t0)
        losses.append(loss)
        gnorms.append(gnorm)
        log(f"[train] {what} step {i}: loss {loss:.4f}, grad norm {gnorm:.4f}, "
            f"{times[-1] * 1e3:.1f} ms")
        if not (math.isfinite(loss) and math.isfinite(gnorm)):
            raise AssertionError(f"{what} step {i}: loss {loss}, grad norm {gnorm}")
    counts = read_counts()
    tokens = batches[0]["tokens"].numel()
    frames = math.prod(batches[0]["frames"].shape[:2]) if "frames" in batches[0] else 0
    # over the steps after the first, and after the second (in the graphed
    # run, the replays alone: its second step also captures)
    steady, replays = times[1:], times[2:]
    r = dict(ms=sum(steady) / len(steady) * 1e3, tok_s=tokens * len(steady) / sum(steady),
             ms2=sum(replays) / len(replays) * 1e3, tok_s2=tokens * len(replays) / sum(replays),
             frames_s2=frames * len(replays) / sum(replays),
             peak=run_peak(), reserved=run_peak("reserved"))
    rates = (f"{r['tok_s']:.0f} tokens/s" + (f", {frames * len(steady) / sum(steady):.0f} "
                                              f"frames/s" if frames else ""))
    rates2 = f"{r['tok_s2']:.0f}" + (f", {r['frames_s2']:.0f}" if frames else "")
    log(f"[train] {what}: peak device memory {r['peak'] / 2**30:.2f} GiB allocated, "
        f"{r['reserved'] / 2**30:.2f} GiB reserved; {rates} over steps 1-"
        f"{steps - 1} ({r['ms']:.1f} ms a step), {rates2} over steps 2-"
        f"{steps - 1} ({r['ms2']:.1f} ms a step); step 0 {times[0] * 1e3:.1f} ms, "
        f"step 1 {times[1] * 1e3:.1f} ms")
    state = [params, opt]

    def one_step():
        state[0], state[1], m = step(state[0], state[1], batches[steps])
        state.append(m)

    r.update(losses=losses, gnorms=gnorms, counts=counts, times=times, share=None,
             host_launches=None, device_ms=None, wall_ms=None, kernels={})
    if profile:
        prof: dict = {}
        share = busy_share(one_step, f"train, {what}", out=prof)
        last = state.pop()
        losses.append(float(last["loss"]))
        gnorms.append(float(last["grad_norm"]))
        launches = prof.get("host_launches", {})
        r.update(share=share, host_launches=sum(launches.values()), launch_calls=launches,
                 device_ms=prof.get("device_ms"), wall_ms=prof.get("wall_ms"),
                 kernels=prof.get("kernels", {}))
        log(f"[train] {what}: device busy share of one step "
            f"{'not measured' if share is None else f'{share:.3f}'}; host launch calls in it "
            f"{r['host_launches']} ({launches})")
    r["reserved_end"] = torch.cuda.memory_reserved()
    r["params"] = [t.detach().to("cpu", copy=True) for t in leaves(state[0])]
    r["names"] = paths(state[0])
    r["step"] = int(state[1]["step"])
    return r


def out_of_memory_fails(arch: str, run):
    """`run()`, a card that runs out of memory failing the phase with what
    it held, not shortening the run."""
    import torch

    try:
        return run()
    except torch.cuda.OutOfMemoryError as e:
        total = torch.cuda.get_device_properties(torch.cuda.current_device()).total_memory
        raise AssertionError(
            f"{arch}: the card cannot hold the train run: peak "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB allocated, "
            f"{torch.cuda.max_memory_reserved() / 2**30:.2f} GiB reserved of "
            f"{total / 2**30:.2f} GiB ({e})") from e


def phase_train(dev, arch: str = TRAIN_ARCH, trace=None) -> dict:
    """6a (qwen2-1.5b), 6d (zamba2-2.7b, `HYBRID_TRAIN_ARCH`), 6e
    (seamless-m4t-large-v2, `ENCDEC_TRAIN_ARCH`, over frame embeddings and
    text, `train_batch`) and 6f (xlstm-1.3b, `XLSTM_TRAIN_ARCH`): `arch` at
    full width and depth, built on the card from a seed, trained through
    the port's `make_train_step` (AdamW at lr 1e-3, remat, `TRAIN_ACCUM`
    micro-batches) on `TokenPipeline` data in two runs from the same seed
    and batches (`train_run`): the step run eagerly, then the step compiled
    (`compile_train_step`: a warm-up step run eagerly, one CUDA graph
    captured, replayed every later step).  Every loss and gradient norm
    must be finite, and the graphed run's losses, gradient norms and final
    parameters bit-equal to the eager run's (else the first step or leaf
    that differs is named).  The eager run's kernel launches must be as
    many a step as the layers make (`train_expect`); the graphed run's
    warm-up must make a step's, its graph record a step's, and the card run
    them once a replay.  The eager run's state is freed before the graphed
    run starts.  The eager run's second step is `measured` for phase 7
    against `trace` (by default its own `train_trace`).  Logs the graph's
    nodes, its record and instantiation seconds, its pool and the memory
    reserved after the compared steps.

    6f runs `XLSTM_TRAIN_STEPS` steps in each run, none of them profiled:
    its sLSTM makes ~1.4 M launches a step, so an eager step takes tens of
    seconds of host time and is not profiled; the graphed run's profiled
    step is one more replay after the compared steps.  Its eager busy
    share is that replay's device time over the eager step's wall, and
    its host launch calls are read as the graph's nodes (each node one
    launch of the eager step); the replay's device time is split by
    `xlstm_step_groups`.

    Returns the graphed run's launches (the counters' advance, less what
    the graph recorded, plus its replays).  A card that cannot hold a run
    fails the phase, naming the memory it held."""
    import gc

    import torch

    from repro_torch.models.common import count_params
    from repro_torch.models.hybrid import parse_pattern
    from repro_torch.training import AdamWConfig, compile_train_step, make_train_step
    from repro_torch.training.train_lib import TRAIN_GRAPH_STATS as G

    recurrent = arch == XLSTM_TRAIN_ARCH
    steps = XLSTM_TRAIN_STEPS if recurrent else TRAIN_STEPS
    cfg, model = model_for(arch)
    opt_cfg = AdamWConfig(lr=1e-3)
    step = make_train_step(model, opt_cfg, remat=True, accum_steps=TRAIN_ACCUM)
    pipe = train_pipe(cfg, TRAIN_BATCH, SEED)
    n_params = count_params(model.defs)
    mb = TRAIN_BATCH // TRAIN_ACCUM
    if cfg.family == "audio":
        layers = f"{cfg.encoder_layers} encoder and {cfg.n_layers} decoder layers"
        data = f"{mb} x {TRAIN_SEQ} frame embeddings and {mb} x {pipe.seq_len} tokens"
    else:
        blocks = ("pattern {} x {}, ".format(*parse_pattern(cfg)) if cfg.ssm_pattern else "")
        layers = (f"{cfg.n_layers} layers ({blocks}"
                  f"{train_expect(cfg)['ssd_scan_backward'] // TRAIN_ACCUM} scanned blocks)")
        data = f"{mb} x {TRAIN_SEQ} tokens"
    log(f"[train] {arch} at full width and depth: {layers}, d_model "
        f"{cfg.d_model}, {cfg.n_heads}/{cfg.kv_heads} heads of {cfg.hd}, d_ff {cfg.d_ff}, vocab "
        f"{cfg.vocab}; {n_params / 1e9:.3f} B parameters ({n_params * 2 / 1e9:.2f} GB bf16, f32 "
        f"moments {n_params * 8 / 1e9:.2f} GB; a checkpoint of both would write "
        f"{n_params * 10 / 1e9:.2f} GB); AdamW lr 1e-3, remat, {TRAIN_ACCUM} micro-batches of "
        f"{data} a step; {steps} steps" + ("" if recurrent else " and one more, profiled")
        + ", eager, then graphed")
    batches = [train_batch(cfg, pipe, i, dev) for i in range(steps + 1)]
    expect = train_expect(cfg)
    eager = out_of_memory_fails(arch, lambda: train_run(
        f"{arch} eager", model, step, opt_cfg, batches, dev, steps, f"{arch} train step", trace,
        profile=not recurrent))
    gc.collect()
    torch.cuda.empty_cache()
    for name, n in expect.items():
        if eager["counts"].get(name, 0) != n * steps:
            raise AssertionError(f"eager {name}: {eager['counts'].get(name, 0)} launches in "
                                 f"{steps} steps, expected {n} a step")
    G.reset()
    compiled = compile_train_step(step)
    graphed = out_of_memory_fails(arch, lambda: train_run(
        f"{arch} graphs", model, compiled, opt_cfg, batches, dev, steps,
        profile=not recurrent))
    if recurrent:  # one more replay under the profiler, past the compared steps
        prof: dict = {}
        share = busy_share(lambda: compiled(compiled.params, compiled.opt_state, batches[steps]),
                           f"train, {arch} graphs", out=prof)
        launches = prof.get("host_launches", {})
        graphed.update(share=share, host_launches=sum(launches.values()),
                       **{k: prof.get(k) for k in ("device_ms", "wall_ms", "kernels")})
        log(f"[train] {arch} graphs: device busy share of one replay "
            f"{'not measured' if share is None else f'{share:.3f}'} under the profiler; its "
            f"device time over the unprofiled replays' wall (steps 2-{steps - 1}, "
            f"{graphed['ms2']:.1f} ms) "
            + ("not measured" if share is None else f"{prof['device_ms'] / graphed['ms2']:.3f}")
            + f"; host launch calls in it {graphed['host_launches']} ({launches})")
    graph = next(iter(compiled.graphs.values()))
    log(f"[train] {arch} graphs: {G.misses} warm-up step(s) run eagerly, {G.captures} graph(s) "
        f"captured: {graph.nodes} nodes, recorded in {graph.capture_s:.3f} s and instantiated "
        f"in {graph.instantiate_s:.3f} s (host time), its pool {G.reserved_bytes / 2**30:.2f} "
        f"GiB reserved, {G.allocated_bytes / 2**30:.2f} GiB allocated; "
        f"{graphed['reserved_end'] / 2**30:.2f} GiB reserved after the compared steps; "
        f"{G.replays} replays ({steps - 1} counted, one profiled); {G.copy_ins} copy-ins")
    replays = steps - 1
    if (G.misses, G.captures, G.replays) != (1, 1, replays + 1):
        raise AssertionError(f"expected one warm-up, one capture and {replays + 1} replays: {G}")
    for name, n in expect.items():
        warm = graphed["counts"].get(name, 0) - G.captured.get(name, 0)
        if warm != n or G.captured.get(name, 0) != n:
            raise AssertionError(f"graphs {name}: {warm} launches in the warm-up step and "
                                 f"{G.captured.get(name, 0)} recorded, expected {n} each")
    launched = {name: graphed["counts"].get(name, 0) - G.captured.get(name, 0)
                + G.captured.get(name, 0) * replays for name in graphed["counts"]}
    per_step = {k: v / steps for k, v in launched.items() if v}
    log(f"[train] {arch} graphs: kernel launches a step (the warm-up's, and the graph's once a "
        f"replay): {per_step}")
    compared = len(eager["losses"])
    for i, (a, b) in enumerate(zip(eager["losses"], graphed["losses"], strict=True)):
        if a != b or eager["gnorms"][i] != graphed["gnorms"][i]:
            raise AssertionError(f"step {i}: the graphed step's loss {b!r} and grad norm "
                                 f"{graphed['gnorms'][i]!r} differ from the eager step's "
                                 f"{a!r}, {eager['gnorms'][i]!r}")
    for name, a, b in zip(eager["names"], eager["params"], graphed["params"], strict=True):
        if not torch.equal(a, b):
            raise AssertionError(f"parameter {name} after {compared} steps: the graphed "
                                 f"run's differs from the eager run's at "
                                 f"{int((a != b).sum())} of {a.numel()} elements")
    if not eager["step"] == graphed["step"] == compared:
        raise AssertionError(f"step counters {eager['step']}, {graphed['step']}")
    if recurrent and graphed["device_ms"] is not None:
        eager.update(share=graphed["device_ms"] / eager["ms"], host_launches=graph.nodes)
        log(f"[train] {arch} eager (not profiled): busy share "
            f"{eager['share']:.3f} from the profiled replay's {graphed['device_ms']:.3f} ms of "
            f"device time over the eager step's {eager['ms']:.1f} ms (steps 1-{steps - 1}); "
            f"host launch calls read as the graph's {graph.nodes} nodes")

    def vs(key: str) -> str:
        return " vs ".join("not measured" if r[key] is None else f"{r[key]:.3f}"
                           for r in (graphed, eager))

    log(f"[train] {arch} graphs vs eager: losses and grad norms bit-equal at all {compared} "
        f"steps, the {len(eager['names'])} parameter leaves byte-equal after them; over steps "
        f"2-{steps - 1} {graphed['ms2']:.1f} vs {eager['ms2']:.1f} ms a step, "
        f"{graphed['tok_s2']:.0f} vs {eager['tok_s2']:.0f} tokens/s"
        + (f", {graphed['frames_s2']:.0f} vs {eager['frames_s2']:.0f} frames/s"
           if cfg.family == "audio" else "") + "; one step's busy share "
        f"{vs('share')}, device time {vs('device_ms')} ms in {vs('wall_ms')} ms wall; host "
        f"launch calls a step {graphed['host_launches']} vs "
        f"{eager['host_launches']}; "
        f"peak {graphed['peak'] / 2**30:.2f} vs {eager['peak'] / 2**30:.2f} GiB allocated, "
        f"{graphed['reserved'] / 2**30:.2f} vs {eager['reserved'] / 2**30:.2f} GiB reserved"
        + ("; the graphed step before the flash backward's redesign (PERF.md section 2): "
           "508.5 ms a step, 16111 tokens/s" if arch == TRAIN_ARCH else ""))
    del compiled, graph, eager
    gc.collect()
    torch.cuda.empty_cache()
    if recurrent:
        xlstm_step_groups(cfg, model, graphed, dev)
        gc.collect()
        torch.cuda.empty_cache()
    return launched


def slstm_kernels(cfg, model, dev) -> dict[str, float]:
    """Device us by kernel (`kernel_us`) of one sLSTM block's work in one
    micro-batch of 6f's step: its forward under remat (`remat_call`),
    remat's recompute and the backward to its parameters and its input, at
    6f's micro-batch (TRAIN_BATCH // TRAIN_ACCUM x TRAIN_SEQ tokens), on the
    first sLSTM block's init and normal inputs, captured as one CUDA graph
    (after a warm-up on a side stream) and replayed once under the
    profiler."""
    import torch

    from repro_torch.models import hybrid
    from repro_torch.models.common import KERNELS, init_params, remat_call
    from repro_torch.training.tree import leaves

    g = torch.Generator(device=dev).manual_seed(SEED)
    p = init_params(model.defs["outer"][0], g)
    shape = (TRAIN_BATCH // TRAIN_ACCUM, TRAIN_SEQ, cfg.d_model)
    x = torch.randn(shape, generator=g, device=dev).to(cfg.dtype).requires_grad_(True)
    dy = torch.randn(shape, generator=g, device=dev).to(cfg.dtype)
    trained = leaves(p)

    def block():
        for t in trained:
            t.requires_grad_(True)
        y = remat_call(lambda h: hybrid._apply_slstm_full(cfg, KERNELS, p, h)[0], x)
        torch.autograd.grad(y, [x, *trained], dy)
        for t in trained:
            t.requires_grad_(False)

    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        block()
    torch.cuda.current_stream(dev).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        block()
    return kernel_us(graph.replay, calls=1)


def xlstm_step_groups(cfg, model, graphed: dict, dev) -> dict:
    """6f's graphed step's device time (its profiled replay) in three
    groups: the mLSTM's wide route (every kernel of `ssd_scan.cu`:
    `ssd_scan` and `ssd_scan_backward`), the sLSTM's elementwise kernels
    (PyTorch's own, `at::native::`, of `slstm_kernels` times the step's
    sLSTM blocks and micro-batches) and the rest; logs each one's ms and
    share of the step, and the sLSTM block's top kernels.  Returns the
    groups' ms."""
    if graphed["device_ms"] is None:
        raise AssertionError("the profiled replay recorded no device time to split")
    src = (ROOT / KERNEL_SOURCES["ssd_scan"][0]).read_text()
    scan = set(re.findall(r"(\w+)\(const __grid_constant__", src))
    step_ms = graphed["device_ms"]
    wide = sum(us for k, us in graphed["kernels"].items() if k.split("<")[0] in scan) / 1e3
    block = slstm_kernels(cfg, model, dev)
    n = cfg.ssm_pattern.count("s") * TRAIN_ACCUM
    elementwise = n * sum(us for k, us in block.items() if k.startswith("at::native::")) / 1e3
    whole = n * sum(block.values()) / 1e3
    groups = {"the mLSTM's wide route": wide, "the sLSTM's elementwise kernels": elementwise,
              "the rest": step_ms - wide - elementwise}
    log(f"[train] {cfg.name} graphs: the profiled replay's {step_ms:.3f} ms of device time: "
        + "; ".join(f"{k} {v:.3f} ms ({v / step_ms:.2%})" for k, v in groups.items())
        + f"; the sLSTM blocks' kernels in all {whole:.3f} ms ({whole / step_ms:.2%}; one "
        f"block in one micro-batch, replayed alone: {sum(block.values()) / 1e3:.3f} ms, "
        f"times {n})")
    for k, us in sorted(block.items(), key=lambda kv: -kv[1])[:8]:
        log(f"[train] {cfg.name} one sLSTM block a micro-batch: {us / 1e3:9.3f} ms {k[:90]}")
    return groups


def scan_recorder(calls: list):
    """KERNELS' linear attention (`ssd_scan_bthd`), recording each call
    whose output takes part in the backward: its inputs, y's cotangent and
    the gradient autograd delivers to each input that needs one (hooks; a
    call remat only recomputes gets none)."""
    from repro_torch.kernels.ssd_scan import ops as ssd

    def linear_attention(q, k, v, log_g, log_i=None, chunk=256):
        y, state = ssd.ssd_scan_bthd(q, k, v, log_g, log_i, chunk)
        if y.requires_grad:
            args = (q, k, v, log_g, log_i)
            rec = {"args": tuple(None if t is None else t.detach() for t in args), "chunk": chunk,
                   "need": [i for i, t in enumerate(args) if t is not None and t.requires_grad],
                   "grads": {}}
            y.register_hook(lambda dy: rec.__setitem__("dy", dy.detach()))
            for i in rec["need"]:
                args[i].register_hook(lambda g, i=i: rec["grads"].__setitem__(i, g.detach()))
            calls.append(rec)
        return y, state

    return linear_attention


def check_scan_calls(arch: str, calls: list) -> None:
    """`ssd_scan_backward` at the inputs and cotangents the model gave each
    scan call of a loss's backward (Mamba2's gates, the mLSTM's log_i and
    normaliser column as the model makes them): what autograd delivered to
    each of the call's inputs bit-equal to the kernel's gradients there
    (the autograd route's wiring, whatever the model's bf16 noise), and
    each gradient within GRAD_TOL of the max |value| of the plain backward
    run in f32 from the same inputs."""
    import torch

    from repro_torch.kernels.ssd_scan import ops as ssd
    from repro_torch.testing.parity import GRAD_TOL, assert_grad_close

    names = ("dq", "dk", "dv", "dlog_g", "dlog_i")
    worst = dict.fromkeys(names, 0.0)
    used = [c for c in calls if "dy" in c]
    for i, c in enumerate(used):
        got = ssd.ssd_scan_backward(*c["args"], c["dy"], None, chunk=c["chunk"])
        for j in c["need"]:
            g = c["grads"].get(j)
            if g is None or not torch.equal(got[j].to(g.dtype), g):
                raise AssertionError(f"{arch} scan call {i}: autograd delivered "
                                     f"{'no' if g is None else 'another'} {names[j]} than the "
                                     f"backward kernel's at the call's inputs")
        want = ssd.chunked_linear_attention_backward_plain(
            *(None if t is None else t.float() for t in c["args"]), c["dy"].float(), None,
            chunk=c["chunk"])
        for n, a, b in zip(names, got, want):
            if b is not None:
                worst[n] = max(worst[n], assert_grad_close(a, b, f"{arch} scan call {i}: {n}"))
        del got, want
    if not used:
        raise AssertionError(f"{arch}: no scan call reached the backward")
    log(f"[train] gradient parity, {arch}: at each of the {len(used)} scan calls' own inputs "
        f"and cotangents (shape {tuple(used[0]['args'][2].shape)}, chunk {used[0]['chunk']}), "
        f"autograd delivered the backward kernel's gradients bit for bit to "
        + ", ".join(names[j][1:] for j in used[0]["need"])
        + "; against the f32 plain backward: worst "
        + ", ".join(f"{n} {x:.3g}" for n, x in worst.items() if x) + f" (tol {GRAD_TOL})")
    calls.clear()
    torch.cuda.empty_cache()


def phase_grad_parity(dev, arch: str, n_layers: int) -> None:
    """6b, for each of `GRAD_PARITY_RUNS`: `arch` at full width, its first
    `n_layers` layers (qwen2-1.5b's 2 of 28; zamba2-2.7b's first group, 5
    Mamba2 blocks and the shared attention; xlstm-1.3b's first period, 7
    mLSTM blocks on the scan's wide path and 1 sLSTM; seamless-m4t-large-v2's
    first 2 encoder and 2 decoder layers, its non-causal encoder and
    cross-attention through the flash backward; deepseek-v3-671b's first
    layer, a dense one, and its MTP module's dense layer, MLA's attention
    through the flash backward at q and k 192, v 128), a micro-batch of 4
    x 1024 tokens (the enc-dec's: 4 x 1024 frames and 4 x 256 tokens): one
    `Model.loss` and its gradients through `KERNELS` (the
    kernels' autograd routes), through `PLAIN` (autograd through the plain
    math) and through the plain math in f32, on the same parameters and
    batch.  Every leaf's gradient through the kernels is finite, zero only
    where the plain math's is, and within `F32_FLOOR_FACTOR` times the
    plain math's own bf16 distance from the f32 gradient (that distance
    taken as at least 5e-2 of the leaf's scale); where the model runs no
    scan, also within 5e-2 of the plain math's.  This is what fails if a
    kernel's output leaves autograd's graph (its inputs would get no
    gradient through it).  For the scanned models each scan call of the
    kernels' pass is first held (`check_scan_calls`): autograd delivered
    the backward kernel's gradients at that call's inputs and cotangents
    bit for bit, and they lie within GRAD_TOL of the f32 plain backward.
    The parameters are fan-in conditioned (`condition_fan_in`): at the
    init's std of 1/sqrt(28) a 1536-wide projection scales its input by
    about 7, the attention scores saturate, and the attention leaves'
    bf16 gradients are rounding noise in either route (the plain math's
    own bf16 gradients then stray from its f32 ones by more than their
    scale, on the CPU at two layers).  Logged: the parameters, what the
    three routes' parameters and gradients take (bf16 twice and the f32
    copy's leaves and gradients, before activations), and the peak device
    memory allocated over the run."""
    import copy
    import dataclasses
    import gc

    import torch

    from repro_torch.models.common import KERNELS, PLAIN
    from repro_torch.models.model_zoo import Model
    from repro_torch.testing.parity import condition_fan_in, grad_gap, tol
    from repro_torch.training.tree import leaves

    torch.cuda.reset_peak_memory_stats()
    cfg, model = model_for(arch, n_layers)
    params = model.init(torch.Generator(device=dev).manual_seed(SEED + 2))
    condition_fan_in(params, model.defs)
    n_params = sum(p.numel() for p in leaves(params))
    pipe = train_pipe(cfg, TRAIN_BATCH // TRAIN_ACCUM, SEED + 2)
    batch = train_batch(cfg, pipe, 0, dev)
    names = [n for n, _ in sorted(params.named_parameters())]

    def grads(model, params, ops):
        for p in leaves(params):
            p.requires_grad_(True)
        loss = model.loss(params, batch, remat=True, ops=ops)
        out = (float(loss.detach()), torch.autograd.grad(loss, leaves(params)))
        for p in leaves(params):
            p.requires_grad_(False)
        return out

    model32 = Model(cfg=dataclasses.replace(cfg, dtype=torch.float32), defs=model.defs,
                    mod=model.mod)
    scanned = bool(set(cfg.ssm_pattern or "") & set("mM"))
    calls: list = []
    kernels = (dataclasses.replace(KERNELS, linear_attention=scan_recorder(calls))
               if scanned else KERNELS)
    lk, gk = grads(model, params, kernels)
    if scanned:
        check_scan_calls(arch, calls)
    lp, gp = grads(model, params, PLAIN)
    l32, g32 = grads(model32, copy.deepcopy(params).float(), PLAIN)
    bound = tol(torch.bfloat16)["atol"]
    gaps = sorted(((grad_gap(a, b), n) for n, a, b in zip(names, gk, gp)), reverse=True)
    floor = {n: grad_gap(b, c) for n, b, c in zip(names, gp, g32)}
    to_f32 = {n: grad_gap(a, c) for n, a, c in zip(names, gk, g32)}
    ratio = sorted(((to_f32[n] / max(floor[n], bound), n) for n in names), reverse=True)
    full = model_for(arch)[0]
    depth = (f"{n_layers} + {n_layers} of {full.encoder_layers} + {full.n_layers} encoder and "
             f"decoder layers, a micro-batch of {pipe.global_batch} x {TRAIN_SEQ} frames and "
             f"{pipe.global_batch} x {pipe.seq_len} tokens" if cfg.family == "audio" else
             f"{n_layers} of {full.n_layers} layers, a micro-batch of {pipe.global_batch} x "
             f"{TRAIN_SEQ}") + (" (and the MTP module's layer)" if "mtp" in model.defs else "")
    log(f"[train] gradient parity, {arch}: {n_params / 1e9:.3f} B parameters ("
        f"{n_params * 2 / 1e9:.2f} GB in bf16, {n_params * 4 / 1e9:.2f} GB in f32; the three "
        f"routes' parameters and gradients {n_params * (2 * 3 + 4 * 2) / 1e9:.1f} GB before "
        f"activations); peak allocated {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    log(f"[train] gradient parity, {arch} at full width, {depth}: loss {lk:.6f} through the "
        f"kernels, {lp:.6f} through the plain math (gap "
        f"{abs(lk - lp):.3g}), {l32:.6f} in f32; the kernels' against f32 over the plain math's "
        f"bf16 against f32 (at least {bound}), worst "
        + ", ".join(f"{n} {r:.3g} ({to_f32[n]:.3g} / {floor[n]:.3g})" for r, n in ratio[:4])
        + f" (held to {F32_FLOOR_FACTOR}); the kernels against the plain math, worst "
        + ", ".join(f"{n} {g:.3g}" for g, n in gaps[:4]) + " of max |grad|"
        + ("" if scanned else f" (held to {bound})"))
    for n, a, b in zip(names, gk, gp):
        if not torch.isfinite(a).all() or (float(a.abs().max()) == 0.0) != \
                (float(b.abs().max()) == 0.0):
            raise AssertionError(f"{arch}: gradient of {n} through the kernels is not finite, "
                                 f"or zero where the plain math's is not (or the reverse)")
    if ratio[0][0] > F32_FLOOR_FACTOR:
        n = ratio[0][1]
        raise AssertionError(f"{arch}: gradient of {n} through the kernels is {to_f32[n]:.3g} "
                             f"of its scale from the f32 gradient, the plain math's "
                             f"{floor[n]:.3g}")
    if not scanned and gaps[0][0] > bound:
        raise AssertionError(f"{arch}: gradient of {gaps[0][1]} through the kernels differs "
                             f"from the plain math's by {gaps[0][0]:.3g} of its scale")
    del params, gk, gp, g32
    gc.collect()
    torch.cuda.empty_cache()


def phase_elastic(dev) -> None:
    """6c: `repro_torch.examples.train_small`'s run on the card (qwen2 at
    d_model 512, 8 layers, accumulation 2): `run_elastic` over
    `ELASTIC_STEPS` steps with checkpoints every `ELASTIC_CKPT_EVERY`, a
    failure injected at step `ELASTIC_FAIL_AT` and the restore from the
    newest committed checkpoint; and the same run with no failure (one
    checkpoint, at the end).  The loss over the last tenth must be below
    the first tenth's, and every loss after the restore must equal the
    uninjected run's at the same step.  The step is compiled
    (`compile_train_step`): each run warms up once, captures one graph and
    replays it every later step; the faulty run's restart must reach the
    graph through one copy of the restored state into its buffers, the
    uninjected run makes none.  The checkpoints go to a temporary
    directory, removed after."""
    import shutil
    import tempfile

    import torch

    from repro_torch.examples.train_small import run
    from repro_torch.training.train_lib import TRAIN_GRAPH_STATS as G

    root = tempfile.mkdtemp(prefix="chip_smoke_elastic_")
    graphs = {}
    try:
        torch.use_deterministic_algorithms(True, warn_only=True)
        t0 = time.perf_counter()
        G.reset()
        faulty, stats, wall = run(ELASTIC_STEPS, ELASTIC_FAIL_AT, f"{root}/faulty", dev,
                                  ckpt_every=ELASTIC_CKPT_EVERY)
        graphs["faulty"] = (G.misses, G.captures, G.replays, G.copy_ins)
        G.reset()
        clean, clean_stats, clean_wall = run(ELASTIC_STEPS, None, f"{root}/clean", dev,
                                             ckpt_every=ELASTIC_STEPS)
        graphs["clean"] = (G.misses, G.captures, G.replays, G.copy_ins)
        both = time.perf_counter() - t0
    finally:
        torch.use_deterministic_algorithms(False)
        shutil.rmtree(root, ignore_errors=True)
    resumed = stats["resumed_from"]
    k = ELASTIC_STEPS // 10
    first, last = sum(faulty[:k]) / k, sum(faulty[-k:]) / k
    log(f"[train] elastic: {ELASTIC_STEPS} steps, checkpoints every {ELASTIC_CKPT_EVERY}, a "
        f"failure at step {ELASTIC_FAIL_AT}: restarts {stats['restarts']}, resumed from "
        f"{resumed}, {wall:.1f} s; loss over the first tenth {first:.4f}, the last {last:.4f}; "
        f"the uninjected run {clean_wall:.1f} s ({both:.1f} s both; the eager step's pair "
        f"took 77.9 s, PERF.md section 2)")
    if stats["restarts"] != 1 or resumed != [ELASTIC_FAIL_AT // ELASTIC_CKPT_EVERY
                                             * ELASTIC_CKPT_EVERY]:
        raise AssertionError(f"expected one restart from the last checkpoint: {stats}")
    start = resumed[0]
    calls = {"faulty": ELASTIC_STEPS + ELASTIC_FAIL_AT - start, "clean": ELASTIC_STEPS}
    for what, n in calls.items():
        copies = 1 if what == "faulty" else 0
        log(f"[train] elastic, the {what} run: (warm-up steps, captures, replays, copy-ins of "
            f"state into the graph's buffers) {graphs[what]}")
        if graphs[what] != (1, 1, n - 1, copies):
            raise AssertionError(f"the {what} run's graph counts {graphs[what]}, expected "
                                 f"(1, 1, {n - 1}, {copies})")
    if not last < first:
        raise AssertionError(f"loss did not decrease: {first} -> {last}")
    after = faulty[ELASTIC_FAIL_AT:]
    if faulty[:ELASTIC_FAIL_AT] != clean[:ELASTIC_FAIL_AT] or after != clean[start:]:
        diff = [i for i, (a, b) in enumerate(zip(after, clean[start:])) if a != b]
        raise AssertionError(f"the losses after the restore differ from the uninjected run's "
                             f"at {len(diff)} steps, first at step {start + diff[0]}"
                             if diff else "the runs' losses differ before the failure")
    log(f"[train] elastic: the {len(after)} losses after the restore (steps {start}-"
        f"{ELASTIC_STEPS - 1}) equal the uninjected run's, step for step")


# ----------------------------------------------------------------- phase 7


def xlstm_step_trace() -> dict:
    """The meta trace of 6f's second eager step (`train_trace`: xlstm-1.3b
    at full depth, 6a's shape) on the batch's shapes: its predicted peak,
    memory analysis, kernel launches, traced FLOPs and wall."""
    import torch

    from repro_torch.training import AdamWConfig

    cfg, model = model_for(XLSTM_TRAIN_ARCH)
    pipe = train_pipe(cfg, TRAIN_BATCH, SEED)
    batch = {k: torch.empty(v.shape, dtype=torch.as_tensor(v).dtype, device="meta")
             for k, v in pipe.batch_for(1).items()}
    terms, extra = train_trace(model, AdamWConfig(lr=1e-3), batch)()
    return dict(peak_size=extra["peak_size"], trace_s=extra["trace_s"],
                memory_analysis=extra["memory_analysis"], flops=terms.flops_per_device,
                kernels={k: {"launches": w["launches"]} for k, w in extra["kernels"].items()})


def start_xlstm_trace() -> subprocess.Popen:
    """`xlstm_step_trace` in a process of its own (this script with
    `--xlstm-trace`, on the CPU: the meta device needs no card), so that
    its ~100 s of Python run beside phase 6; 6f hands `xlstm_trace_result`
    of it to phase 7 as its second eager step's trace."""
    return subprocess.Popen([sys.executable, str(Path(__file__).resolve()), "--xlstm-trace"],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def xlstm_trace_result(proc: subprocess.Popen) -> tuple:
    """`start_xlstm_trace`'s trace as `hlo_analysis.analyze_traced` returns
    one: (terms, with the traced FLOPs, and the record)."""
    import types

    out, err = proc.communicate(timeout=900)
    if proc.returncode != 0:
        raise AssertionError(f"xlstm-1.3b's trace exited {proc.returncode}: {err[-2000:]}")
    x = json.loads(out.strip().splitlines()[-1])
    return types.SimpleNamespace(flops_per_device=x.pop("flops")), x


def phase_dry_run() -> dict:
    """The dry run (`repro_torch.launch.dryrun`'s trace on the meta device)
    held to the card: `kernels/occupancy.py`'s table equal to the card's
    readings; for each call `measured` in the earlier phases (`DRY_RUN`:
    the second eager train step of 6a, 6d, 6e and 6f, the prefills of
    `DRY_RUN_PREFILLS`), the same call traced on the meta device (6f's in
    `start_xlstm_trace`'s process), its predicted peak within
    `DRY_RUN_TOL` of the card's and every kernel's launches equal to the
    card's.  Prints, without holding them, each trace's wall, and for the
    MoE pair the deepest depth whose prefill (phase 5's) the dry run
    predicts fits the card, beside `DEPTH_CUTS`.  Returns the table of
    predictions."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import occupancy
    from repro_torch.launch.dryrun import CARD_BYTES

    rms, flash = occupancy.read_on_card()
    differ = ({k: (occupancy.RMSNORM_BLOCKS_PER_SM[k], v) for k, v in rms.items()
               if v != occupancy.RMSNORM_BLOCKS_PER_SM[k]}
              | {k: (occupancy.FLASH_CLUSTERS[k], v) for k, v in flash.items()
                 if v != occupancy.FLASH_CLUSTERS[k]})
    if differ:
        raise AssertionError(f"the occupancy table differs from the card's readings "
                             f"(table, card): {differ}")
    log(f"[dry run] the occupancy table equals the card's readings: {len(rms)} rmsnorm_backward "
        f"widths, {len(flash)} flash backward (clusters, instance) pairs")
    want = ({f"{a} train step" for a in (TRAIN_ARCH, HYBRID_TRAIN_ARCH, ENCDEC_TRAIN_ARCH,
                                          XLSTM_TRAIN_ARCH)}
            | {f"{a} prefill" for a in DRY_RUN_PREFILLS})
    if set(DRY_RUN) != want:
        raise AssertionError(f"measured calls {sorted(DRY_RUN)}, expected {sorted(want)}")
    rows = {}
    for name, r in DRY_RUN.items():
        terms, extra = r.pop("trace")()
        predicted, got = extra["peak_size"], r["measured"]
        meta = {k: w["launches"] for k, w in extra["kernels"].items()}
        rows[name] = dict(r, predicted=predicted, ratio=predicted / got, trace_s=extra["trace_s"],
                          meta_launches=meta, flops=terms.flops_per_device,
                          memory_analysis=extra["memory_analysis"])
        ma = extra["memory_analysis"]
        log(f"[dry run] {name}: predicted peak {predicted / 2**30:.3f} GiB (arguments "
            f"{ma['argument_size'] / 2**30:.3f}, temp {ma['temp_size'] / 2**30:.3f}), measured "
            f"{got / 2**30:.3f} GiB (the card's peak {r['peak'] / 2**30:.3f} less "
            f"{(r['before'] - r['held']) / 2**30:.3f} GiB allocated before and not its "
            f"inputs'), {predicted / got:.4f}x; launches meta {meta}, card {r['launches']}; "
            f"{terms.flops_per_device / 1e12:.2f} TFLOP traced; the trace {extra['trace_s']:.2f} "
            f"s wall")
        if abs(predicted / got - 1) > DRY_RUN_TOL:
            raise AssertionError(f"{name}: the dry run predicts {predicted} bytes, the card "
                                 f"measured {got} (limit {DRY_RUN_TOL:.0%})")
        if meta != r["launches"]:
            raise AssertionError(f"{name}: launches on meta {meta}, on the card {r['launches']}")

    # the MoE pair: the deepest prefill of phase 5's shape that fits
    for arch, B, S, n in DECODE_RUNS:
        if arch not in DEPTH_CUTS:
            continue
        full, deepest, peaks = get_config(arch).n_layers, 0, {}
        for layers in range(1, full + 1):
            cfg, model = model_for(arch, layers)
            tokens = torch.empty((B, S), dtype=torch.int64, device="meta")
            _, extra = prefill_trace(model, {"tokens": tokens}, S + n)()
            peaks[layers] = extra["peak_size"]
            if extra["peak_size"] > CARD_BYTES:
                break
            deepest = layers
        rows[f"{arch} deepest prefill"] = dict(deepest=deepest, peaks=peaks)
        log(f"[dry run] {arch}: the deepest prefill ({B} x {S}, cache {S + n}) the dry run "
            f"predicts fits the card: {deepest} of {full} layers (DEPTH_CUTS: "
            f"{DEPTH_CUTS[arch]}); predicted peaks by depth "
            + ", ".join(f"{k}: {v / 2**30:.2f} GiB" for k, v in peaks.items()))
    return rows


# ----------------------------------------------------------------- phase 8


def phase_examples() -> dict:
    """The port's four examples (`repro_torch.examples.<name>`), each run in
    this process through its `main` with the reference CI's arguments
    (`EXAMPLES`), its printed lines logged: quickstart, plan_explorer and
    stream_serve plan and simulate; serve_pipeline's four acts deploy for
    real on the card, every stage a CUDA graph through the rmsnorm and
    flash-attention kernels at the example's widths.  Its `serve_workload`
    raises unless every request was served with no executor failure and no
    retry (the data plane drops the batch of an executor that raised).
    Counted as phase 3 counts: the counters' advance, less what was recorded
    into graphs, plus each graph's launches times its replays; fails unless
    both kernels launched.  Returns the launches."""
    import contextlib
    import importlib
    import io

    import torch

    from repro_torch.serving.engine import GRAPH_STATS as G

    reset_counts()
    G.reset()
    walls, served = {}, []
    for name, argv in EXAMPLES:
        module = importlib.import_module(f"repro_torch.examples.{name}")
        out = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            ret = module.main(argv)
        torch.cuda.synchronize()
        walls[name] = time.perf_counter() - t0
        for line in out.getvalue().splitlines():
            log(f"[examples] {name} | {line}")
        if name == "serve_pipeline":
            served = ret
    counted = read_counts()
    launches = {k: n - G.captured.get(k, 0) + G.replayed.get(k, 0) for k, n in counted.items()}
    log(f"[examples] serve_pipeline's stage graphs: {G.captures} captured, {G.replays} replays, "
        f"{G.misses} calls without a graph; launches {launches}")
    for name in ("rmsnorm", "flash_attention"):
        if launches.get(name, 0) < 1:
            raise AssertionError(f"the examples launched {name} {launches.get(name, 0)} times")
    log("[examples] walls: " + ", ".join(f"{k} {v:.2f} s" for k, v in walls.items())
        + "; serve_pipeline: " + "; ".join(
            f"{r['name']} {r['served']}/{r['n']} served, attainment {r['attainment']:.4f}, "
            f"p50 {r['p50_ms']:.3f} ms" for r in served) + "; executor failures 0")
    return launches


def main() -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", metavar="ROOT",
                    help="another tree of the repository (e.g. the parent commit unpacked): "
                         "time its kernels in turns with this tree's, and profile a prefill "
                         "through them")
    ap.add_argument("--xlstm-trace", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if not (ROOT / "src" / "repro_torch" / "kernels").is_dir():
        print("chip_smoke.py: run it from a checkout of the repository "
              "(src/repro_torch not found)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    if args.xlstm_trace:  # phase 7's process of its own (`start_xlstm_trace`)
        print(json.dumps(xlstm_step_trace()))
        return 0
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device; the port's kernels run only on the card",
              file=sys.stderr)
        return 3
    dev = torch.device("cuda", 0)
    t_start = time.perf_counter()
    log(f"[env] python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}")
    parent = load_parent(Path(args.parent).resolve()) if args.parent else None

    def elapsed(phase: str) -> None:
        log(f"[time] {phase} done at {time.perf_counter() - t_start:.1f} s")

    phase_build(parent)
    elapsed("1 (build)")
    smi = gpu_line()
    log(f"[env] nvidia-smi: {smi}")
    kern = phase_kernels(dev, parent)
    elapsed("2 (kernels)")
    cfg, session, launches = phase_serve(dev)
    phase_parity(cfg, session.dataplane.dispatcher.executors, dev)
    elapsed("3-4 (serve, parity)")
    serving = [session]  # phase_decode releases it after the run that reuses its parameters
    del session
    decode = phase_decode(serving, dev, parent)
    elapsed("5 (decode)")
    xlstm_trace = start_xlstm_trace()
    try:
        train = phase_train(dev)
        elapsed("6a (train)")
        for arch, n_layers in GRAD_PARITY_RUNS:
            phase_grad_parity(dev, arch, n_layers)
            elapsed(f"6b ({arch})")
        phase_elastic(dev)
        elapsed("6c (elastic)")
        for arch, trace in ((HYBRID_TRAIN_ARCH, None), (ENCDEC_TRAIN_ARCH, None),
                            (XLSTM_TRAIN_ARCH, lambda: xlstm_trace_result(xlstm_trace))):
            more = phase_train(dev, arch, trace)  # 6d, 6e, 6f
            train = {name: train.get(name, 0) + more.get(name, 0) for name in {*train, *more}}
            elapsed(f"6d-6f ({arch})")
        phase_dry_run()
        elapsed("7 (dry run)")
    finally:
        if xlstm_trace.poll() is None:
            xlstm_trace.kill()
            xlstm_trace.wait()
    examples = phase_examples()
    elapsed("8 (examples)")
    launches = {name: {"serve": launches.get(name, 0), "decode": decode.get(name, 0),
                       "train": train.get(name, 0), "examples": examples.get(name, 0)}
                for name in KERNEL_NAMES}
    log(f"[done] all phases passed in {time.perf_counter() - t_start:.1f} s")
    print(smi)
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": KERNEL_SOURCES[name][0],
         "replaces": KERNEL_SOURCES[name][1], "launches": sum(launches[name].values()),
         "launches_by_path": launches[name],
         "max_abs_err": kern[name]["max_abs_err"], "ms": kern[name]["ms"],
         "parent_ms": kern[name]["parent_ms"],
         "plain_ms": kern[name]["plain_ms"], "bound_ms": kern[name]["bound_ms"],
         "bound_by": kern[name]["bound_by"], "library_ms": kern[name]["library_ms"],
         "host_ms": kern[name]["host_ms"],
         **({"shapes": kern[name]["shapes"]} if "shapes" in kern[name] else {})}
        for name in KERNEL_NAMES]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
