"""Stage-split execution: the compute leaf of the serving data plane.

The control plane emits a PipelinePlan; this module materialises its
partitions as per-stage functions over block ranges so they can run on a
device.  Boundary activations are int8-quantized (the boundary_quant kernel)
before a transfer between devices, the paper's fp32->fp16 cut taken one step
further (section 6).

Stage splitting maps a model's block graph onto partitions:
  block 0           = embedding
  blocks 1..L       = sequence layers
  block L+1         = final norm + head
A stage spanning blocks [i, j) embeds iff i == 0 and unembeds iff j == n.

On CUDA a stage runs as a captured CUDA graph, the counterpart of the
reference's `jax.jit(stage_fn)`: one graph per executor and input shape,
captured off the serving path (`StageExecutor.capture`, called by
`Session._warm_executors` for every power-of-two batch bucket) and replayed
by `StageExecutor.__call__`.  A CUDA input of a shape with no graph runs
eagerly and counts as a miss in `GRAPH_STATS`; CPU inputs always run
eagerly.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.core.plan import PipelinePlan
from repro_torch.core.types import ModelProfile, Request
from repro_torch.kernels import launch_counts
from repro_torch.kernels.boundary_quant import ops as bq_ops
from repro_torch.models import transformer as tfm
from repro_torch.models.common import KERNELS, ModelConfig
from repro_torch.models.model_zoo import build_model


def split_stages(cfg: ModelConfig, block_ranges: list[tuple[int, int]],
                 layer_block_map: list[tuple[int, int]]):
    """Build per-stage apply functions for a dense-family model.

    `layer_block_map[b] = (layer_start, layer_end)` for each pre-partitioned
    block b (0 = embed, last = head).  Each stage function takes (params,
    carry) where carry is tokens for stage 0 and hidden states afterwards;
    it reads its layers from `params`, so no weight is copied.  RMSNorm and
    attention run as kernels for CUDA tensors (`common.KERNELS`).
    """
    ops = KERNELS
    model = build_model(cfg)
    n_blocks = len(layer_block_map)

    def make_stage(i: int, j: int) -> Callable:
        lo = layer_block_map[i][0]
        hi = layer_block_map[j - 1][1]

        def stage(params, carry):
            if i == 0:
                x = tfm.embed_tokens(cfg, params, carry)
                lstart, lend = 0, hi
            else:
                x = carry
                lstart, lend = lo, hi
            positions = tfm.positions_for(x)
            for lp in params["layers"][lstart:lend]:
                x, _ = tfm.layer_full(cfg, ops, lp, x, positions)
            if j == n_blocks:
                x = ops.rms_norm(x, params["final_norm"], cfg.norm_eps)
                return tfm.unembed(cfg, params, x)
            return x

        return stage

    return model, [make_stage(i, j) for i, j in block_ranges]


def layer_block_map_from_profile(profile: ModelProfile, n_layers: int
                                 ) -> list[tuple[int, int]]:
    """Map a ModelProfile's blocks to the (layer_start, layer_end) ranges
    `split_stages` expects.

    Profiles are built from `model_zoo.layer_costs`, whose cost index 0 is the
    embedding and index L+1 the head; model layer k lives at cost index k+1.
    Embedding/unembedding are implied by block position (first/last), so the
    map only carries sequence-layer ranges, clamped into [0, n_layers].
    """
    def clamp(i: int) -> int:
        return max(0, min(n_layers, i))

    return [(clamp(b.layer_start - 1), clamp(b.layer_end - 1))
            for b in profile.blocks]


@dataclass
class GraphStats:
    """Counts over a family of CUDA graphs since the last `reset`: every
    StageExecutor's (`GRAPH_STATS`), every compiled train step's
    (`training.train_lib.TRAIN_GRAPH_STATS`).

    The kernel wrappers' launch counters advance when a graph is captured,
    not when it replays: `captured` holds the launches recorded into graphs
    (by kernel), `replayed` each graph's recorded launches times its
    replays, so the launches the card ran are the counters' advance minus
    `captured` plus `replayed`.  Updated from the serving thread and from
    warm threads, under a lock."""

    captures: int = 0
    capture_s: float = 0.0    # host seconds inside capture_begin .. capture_end
    allocated_bytes: int = 0  # device memory the captures left allocated
    reserved_bytes: int = 0   # device memory the captures reserved (their pools)
    replays: int = 0
    misses: int = 0           # CUDA calls at a shape with no graph (run eagerly;
    #                           a train step's warm-up)
    copy_ins: int = 0         # train steps handed state the graphs do not hold
    captured: dict = field(default_factory=dict)
    replayed: dict = field(default_factory=dict)
    _lock: Any = field(default_factory=threading.Lock, repr=False, compare=False)

    def reset(self) -> None:
        self.__init__()

    def on_capture(self, launches: dict, seconds: float, allocated: int, reserved: int) -> None:
        with self._lock:
            self.captures += 1
            self.capture_s += seconds
            self.allocated_bytes += allocated
            self.reserved_bytes += reserved
            for name, n in launches.items():
                self.captured[name] = self.captured.get(name, 0) + n

    def on_replay(self, launches: dict) -> None:
        with self._lock:
            self.replays += 1
            for name, n in launches.items():
                self.replayed[name] = self.replayed.get(name, 0) + n

    def on_miss(self) -> None:
        with self._lock:
            self.misses += 1

    def on_copy_in(self) -> None:
        with self._lock:
            self.copy_ins += 1


GRAPH_STATS = GraphStats()


@dataclass
class _Graph:
    graph: Any  # torch.cuda.CUDAGraph
    static_in: torch.Tensor
    static_out: torch.Tensor
    launches: dict  # kernel launches recorded into the graph, by kernel


@dataclass
class StageExecutor:
    """One partition pool: a stage function bound to its params.

    On a single host all pool members are co-resident, so one executor
    serves the whole pool; member identity only matters to the reservation
    scheduler, which tracks per-vdev timelines.  Calls launch on the current
    CUDA stream and return without waiting for the device: a replay of the
    graph captured for the input's shape, or the stage run eagerly.
    """

    stage_fn: Callable
    params: Any
    quantize_boundary: bool = True
    device: torch.device | None = None  # None = the params' device
    # (shape, dtype) of the input -> its captured graph; owned here, released
    # by `release_graphs` (the data plane's epoch GC) or with the executor
    graphs: dict = field(default_factory=dict, repr=False, compare=False)

    def __post_init__(self):
        if self.device is None:
            self.device = next(self.params.parameters()).device
        self.device = torch.device(self.device)

    def __call__(self, carry: torch.Tensor) -> torch.Tensor:
        with torch.inference_mode():
            if carry.is_cuda:
                g = self.graphs.get((tuple(carry.shape), carry.dtype))
                if g is not None:
                    g.static_in.copy_(carry)
                    g.graph.replay()
                    GRAPH_STATS.on_replay(g.launches)
                    # the next replay overwrites static_out, and batches stay
                    # in flight past it: hand each its own copy
                    return g.static_out.clone()
                GRAPH_STATS.on_miss()
            return self.stage_fn(self.params, carry)

    def capture(self, example: torch.Tensor) -> None:
        """Capture the stage at `example`'s shape and dtype as a CUDA graph
        (nothing if one exists).  The caller has run it eagerly at that
        shape on the same stream, so kernels are built and lazy
        initialisations done.  Captures on the current stream, which must be a side stream this
        thread owns, in thread-local mode: another thread may serve (replay
        and launch) meanwhile.  Waits for nothing; the caller synchronises
        the stream."""
        key = (tuple(example.shape), example.dtype)
        if key in self.graphs:
            return
        allocated = torch.cuda.memory_allocated(self.device)
        reserved = torch.cuda.memory_reserved(self.device)
        with torch.inference_mode():
            static_in = example.clone()
            before = launch_counts()
            t0 = time.perf_counter()
            graph = torch.cuda.CUDAGraph()
            graph.capture_begin(capture_error_mode="thread_local")
            try:
                static_out = self.stage_fn(self.params, static_in)
            finally:
                graph.capture_end()
            seconds = time.perf_counter() - t0
        launches = {name: n - before[name] for name, n in launch_counts().items()
                    if n > before[name]}
        GRAPH_STATS.on_capture(launches, seconds,
                               torch.cuda.memory_allocated(self.device) - allocated,
                               torch.cuda.memory_reserved(self.device) - reserved)
        self.graphs[key] = _Graph(graph, static_in, static_out, launches)

    def release_graphs(self) -> None:
        """Drop every captured graph; their memory returns to the allocator."""
        self.graphs = {}

    def transfer(self, x: torch.Tensor) -> torch.Tensor:
        """Boundary transfer into this stage: int8-quantize on the sender,
        move, dequantize on the receiver (paper section 6).

        Skipped when sender and receiver share a device — the
        quantize->dequantize round-trip without a wire in between is pure
        overhead and pure error — and for any integer carry (token ids are
        exact already)."""
        if x.device == self.device:
            return x  # co-resident: nothing to move, nothing to compress
        if not self.quantize_boundary or not x.is_floating_point():
            return x.to(self.device)
        q, scale = bq_ops.quantize(x)
        return bq_ops.dequantize(q.to(self.device), scale.to(self.device), x.dtype)


@dataclass
class ServingEngine:
    """Synchronous wrapper: `infer` runs one batch through the pipeline;
    `serve` routes batches through the data plane's PoolDispatcher so they
    overlap across stages."""

    cfg: ModelConfig
    pipeline: PipelinePlan
    executors: list[list[StageExecutor]]  # [stage][pool member]
    rr: list[int] = field(default_factory=list)

    def __post_init__(self):
        self.rr = [0] * len(self.executors)

    def infer(self, tokens: torch.Tensor) -> torch.Tensor:
        """Run one batch through the pipeline (round-robin pool members)."""
        carry = tokens
        for si, pool in enumerate(self.executors):
            member = pool[self.rr[si] % len(pool)]
            self.rr[si] += 1
            if si > 0:
                carry = member.transfer(carry)
            carry = member(carry)
        return carry

    def serve(self, requests: list[Request], batch_size: int | None = None,
              seq_len: int = 128) -> dict:
        """Batch + run requests with overlapped dispatch; returns wall-clock
        latency stats plus the in-flight high-water mark."""
        from repro_torch.dataplane.dispatcher import PoolDispatcher

        bs = batch_size or self.pipeline.batch_size
        device = self.executors[0][0].device
        disp = PoolDispatcher({0: [pool[0] for pool in self.executors]})
        submits: list[tuple[int, float, int]] = []
        for i in range(0, len(requests), bs):
            chunk = requests[i : i + bs]
            tokens = torch.ones((len(chunk), seq_len), dtype=torch.int64, device=device)
            job_id = disp.submit_chain(0, tokens)
            submits.append((job_id, time.perf_counter(), len(chunk)))
        done = disp.drain_all()
        by_job = {c.job_id: c for c in done}
        lat = [by_job[j].done_wall - t0 for j, t0, _ in submits if j in by_job]
        return {
            "served": sum(n for _, _, n in submits),
            "batches": len(submits),
            "mean_batch_latency_s": float(np.mean(lat)) if lat else 0.0,
            "p99_batch_latency_s": float(np.percentile(lat, 99)) if lat else 0.0,
            "inflight_hwm": disp.inflight_hwm,
        }


def build_engine(cfg: ModelConfig, pipeline: PipelinePlan,
                 layer_block_map: list[tuple[int, int]],
                 generator: torch.Generator) -> ServingEngine:
    ranges = [(s.block_start, s.block_end) for s in pipeline.stages]
    model, stage_fns = split_stages(cfg, ranges, layer_block_map)
    params = model.init(generator)
    executors = []
    for sp, fn in zip(pipeline.stages, stage_fns):
        # one executor shared by every co-resident pool member
        shared = StageExecutor(stage_fn=fn, params=params)
        executors.append([shared] * sp.n_vdev)
    return ServingEngine(cfg=cfg, pipeline=pipeline, executors=executors)
