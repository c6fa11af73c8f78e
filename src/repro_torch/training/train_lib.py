"""Train-step builder: loss + grad + clip + AdamW, with activation remat and
gradient accumulation (microbatching), the reference's
`training/train_lib.py` in PyTorch.

The gradients come from `torch.autograd.grad` on the parameter leaves,
which are set to require a gradient for the step only (the serving path
keeps them frozen, so its kernels launch with no autograd wrapper).  With
`accum_steps > 1` each micro-batch's gradients are summed in f32 and scaled
by 1 / accum_steps, as the reference's scan does, and stay f32 into the
clip and the update (the reference's accumulated gradients are f32 too).

`compile_train_step` is the counterpart of the reference's
`jax.jit(train_step, donate_argnums=(0, 1))`: on CUDA state each step is
captured once as a CUDA graph per batch shape and replayed, the caller's
own parameter and moment tensors serving as the graph's static buffers
(the donation); on CPU state it runs the step as it is.

The reference's `zero_pspec` and `opt_pspecs` (ZeRO-style sharding specs of
the optimizer moments over a JAX mesh) have no counterpart on one card and
are not ported (PERF.md, section 7).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable

import torch

from repro_torch.kernels import launch_counts
from repro_torch.kernels._lib import ProgramError
from repro_torch.models.model_zoo import Model
from repro_torch.serving.engine import GraphStats

from .optimizer import AdamWConfig, adamw_update, clip_by_global_norm, init_opt_state
from .tree import leaves


@dataclass
class TrainState:
    params: Any
    opt_state: Any

    @property
    def step(self):
        return self.opt_state["step"]


def micro_batches(batch: dict, accum_steps: int) -> list[dict]:
    """The batch's leading axis cut into `accum_steps` equal micro-batches,
    in order (the reference's reshape to (accum_steps, B / accum_steps, ...))."""
    n = next(iter(batch.values())).shape[0]
    if n % accum_steps:
        raise ValueError(f"batch of {n} does not split into {accum_steps} micro-batches")
    size = n // accum_steps
    return [{k: x[i * size:(i + 1) * size] for k, x in batch.items()}
            for i in range(accum_steps)]


def make_train_step(
    model: Model,
    opt_cfg: AdamWConfig | None = None,
    remat: bool = True,
    accum_steps: int = 1,
) -> Callable:
    """Returns train_step(params, opt_state, batch) -> (params, opt_state,
    metrics), metrics {"loss", "grad_norm"} as 0-d f32 tensors.  The step
    updates params and opt_state in place (see `adamw_update`)."""
    opt_cfg = opt_cfg or AdamWConfig()

    def value_and_grad(params, batch) -> tuple[torch.Tensor, tuple]:
        loss = model.loss(params, batch, remat=remat)
        return loss.detach(), torch.autograd.grad(loss, leaves(params), materialize_grads=True)

    def grads_of(params, batch) -> tuple[torch.Tensor, list]:
        if accum_steps == 1:
            loss, grads = value_and_grad(params, batch)
            return loss, list(grads)
        loss_sum = None
        g_sum = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                 for p in leaves(params)]
        for mb in micro_batches(batch, accum_steps):
            loss, grads = value_and_grad(params, mb)
            loss_sum = loss.float() if loss_sum is None else loss_sum + loss
            for acc, g in zip(g_sum, grads):
                acc.add_(g.float())
            del grads
        scale = 1.0 / accum_steps
        return loss_sum * scale, [g * scale for g in g_sum]

    def train_step(params, opt_state, batch):
        trained = leaves(params)
        for p in trained:
            p.requires_grad_(True)
        try:
            loss, grads = grads_of(params, batch)
        finally:
            for p in trained:
                p.requires_grad_(False)
        # the gradients stay a list in the parameters' flatten order: the
        # clip and the update walk leaves, and a list needs no tree built
        grads, gnorm = clip_by_global_norm(grads, opt_cfg.grad_clip)
        params, opt_state = adamw_update(params, grads, opt_state, opt_cfg)
        return params, opt_state, {"loss": loss, "grad_norm": gnorm}

    return train_step


# every compiled train step's graphs: captures, replays, eager warm-up
# steps (`misses`: a CUDA call at a batch shape with no graph yet)
TRAIN_GRAPH_STATS = GraphStats()


def copy_into(static: list, given: list) -> int:
    """Write each leaf of `given` that is not its `static` counterpart (by
    identity) into that counterpart, in place; returns how many it copied.
    This is how state that the graph does not hold (`make_state()`'s, or
    `checkpoint.restore`'s fresh tensors) lands in the graph's buffers.
    Raises if the trees' leaves differ in count, shape or dtype."""
    if len(static) != len(given):
        raise ValueError(f"state of {len(given)} leaves, the graph holds {len(static)}")
    copied = 0
    with torch.no_grad():
        for i, (s, g) in enumerate(zip(static, given)):
            if s is g:
                continue
            if s.shape != g.shape or s.dtype != g.dtype:
                raise ValueError(f"leaf {i}: {tuple(g.shape)} {g.dtype}, the graph holds "
                                 f"{tuple(s.shape)} {s.dtype}")
            s.copy_(g)
            copied += 1
    return copied


def batch_key(batch: dict) -> tuple:
    return tuple((k, tuple(x.shape), x.dtype) for k, x in sorted(batch.items()))


def graph_nodes(graph) -> int:
    """The nodes of `graph`, a `torch.cuda.CUDAGraph(keep_graph=True)` after
    `capture_end`: one a kernel, copy or memset the capture recorded
    (libcuda's `cuGraphGetNodes`)."""
    import ctypes

    get = ctypes.CDLL("libcuda.so.1").cuGraphGetNodes
    get.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.POINTER(ctypes.c_size_t)]
    get.restype = ctypes.c_int
    n = ctypes.c_size_t(0)
    rc = get(graph.raw_cuda_graph(), None, ctypes.byref(n))
    if rc:
        raise ProgramError(f"cuGraphGetNodes returned CUDA error {rc}")
    return n.value


@dataclass
class _StepGraph:
    graph: Any  # torch.cuda.CUDAGraph
    batch: dict  # the static batch the graph reads
    metrics: dict  # the static loss and gradient norm the graph writes
    launches: dict  # kernel launches recorded into the graph, by kernel
    nodes: int  # the graph's nodes (`graph_nodes`)
    capture_s: float  # host seconds recording the step (capture_begin .. capture_end)
    instantiate_s: float  # host seconds instantiating the recorded graph


@dataclass
class CompiledTrainStep:
    """`compile_train_step`'s callable: (params, opt_state, batch) ->
    (params, opt_state, metrics), the step's own signature.

    On CUDA, the first call at a batch shape runs the step eagerly on a
    side stream (a real step, the warm-up: kernels are built, cuBLAS takes
    its workspace on that stream, autograd does its lazy set-up); the next
    call at that shape captures the step on that stream and replays the
    graph (capture records without running, so the step runs once); every
    later call copies the batch into the graph's static batch and replays.
    Before the capture the allocator's cached blocks are released
    (`torch.cuda.empty_cache`): the warm-up's freed activations stay cached
    in the default pool, and the graph's private pool, which must hold a
    whole step's, would otherwise come on top of them (a step whose
    activations and gradient sums are as large as its state would not fit
    twice on the card).  So no other graph may be capturing on the device
    meanwhile.  The capture keeps its graph (`keep_graph`) to count its
    nodes, then instantiates it.  The static state is the state of the
    first CUDA call: its parameter, moment and step tensors, written in
    place by every step (the step counter through a copy the graph makes
    of `adamw_update`'s new step).
    A call with other tensors (a restart's `make_state()`, a restore)
    copies them in first (`copy_into`; counted in `stats.copy_ins`).
    Counts go to `stats` (`TRAIN_GRAPH_STATS` unless given): warm-up steps
    as `misses`, captures, replays.  Returns the static trees and
    clones of the static metrics.  A failed capture raises `ProgramError`;
    no step then runs.  On CPU state it is the step itself."""

    step_fn: Callable
    stats: GraphStats = field(default_factory=lambda: TRAIN_GRAPH_STATS)
    graphs: dict = field(default_factory=dict, repr=False)
    warmed: set = field(default_factory=set, repr=False)
    params: Any = field(default=None, repr=False)
    opt_state: Any = field(default=None, repr=False)
    stream: Any = field(default=None, repr=False)

    def __call__(self, params, opt_state, batch: dict):
        device = leaves(params)[0].device
        if device.type == "cpu":
            return self.step_fn(params, opt_state, batch)
        if device.type != "cuda":
            raise ProgramError(f"no train step for state on {device}")
        if self.stream is None:
            self.stream = torch.cuda.Stream(device)
        self._adopt(params, opt_state)
        key = batch_key(batch)
        g = self.graphs.get(key)
        if g is None and key not in self.warmed:
            return self._warm(key, batch)
        if g is None:
            g = self._capture(key, batch)
        else:
            for k, x in batch.items():
                g.batch[k].copy_(x)
        g.graph.replay()
        self.stats.on_replay(g.launches)
        return self.params, self.opt_state, {k: v.clone() for k, v in g.metrics.items()}

    def _adopt(self, params, opt_state) -> None:
        if self.params is None:
            self.params, self.opt_state = params, opt_state
            return
        if params is self.params and opt_state is self.opt_state:
            return
        if copy_into(leaves(self.params) + leaves(self.opt_state),
                     leaves(params) + leaves(opt_state)):
            self.stats.on_copy_in()

    def _warm(self, key: tuple, batch: dict):
        cur = torch.cuda.current_stream(self.stream.device)
        self.stream.wait_stream(cur)
        with torch.cuda.stream(self.stream):
            _, opt, metrics = self.step_fn(self.params, self.opt_state, batch)
            self.opt_state["step"].copy_(opt["step"])
        cur.wait_stream(self.stream)
        for v in metrics.values():
            v.record_stream(cur)  # made on the side stream, read on the caller's
        self.warmed.add(key)
        self.stats.on_miss()
        return self.params, self.opt_state, metrics

    def _capture(self, key: tuple, batch: dict) -> _StepGraph:
        device = self.stream.device
        torch.cuda.empty_cache()  # the warm-up's cached blocks (see the class's note)
        allocated = torch.cuda.memory_allocated(device)
        reserved = torch.cuda.memory_reserved(device)
        cur = torch.cuda.current_stream(device)
        self.stream.wait_stream(cur)
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        with torch.cuda.stream(self.stream):
            static_batch = {k: x.clone() for k, x in batch.items()}
            before = launch_counts()
            t0 = time.perf_counter()
            graph.capture_begin(capture_error_mode="thread_local")
            try:
                _, opt, metrics = self.step_fn(self.params, self.opt_state, static_batch)
                self.opt_state["step"].copy_(opt["step"])
            except Exception as err:
                try:
                    graph.capture_end()
                except Exception:
                    pass  # the capture is invalid already; the step's error says why
                raise ProgramError(f"the train step could not be captured as a CUDA graph "
                                   f"at batch {key}: {err}") from err
            try:
                graph.capture_end()
                t1 = time.perf_counter()
                nodes = graph_nodes(graph)
                t2 = time.perf_counter()
                graph.instantiate()
            except Exception as err:
                raise ProgramError(f"the train step's CUDA graph capture failed at batch "
                                   f"{key}: {err}") from err
            t3 = time.perf_counter()
        cur.wait_stream(self.stream)
        launches = {name: n - before[name] for name, n in launch_counts().items()
                    if n > before[name]}
        self.stats.on_capture(launches, t1 - t0 + t3 - t2,
                              torch.cuda.memory_allocated(device) - allocated,
                              torch.cuda.memory_reserved(device) - reserved)
        g = _StepGraph(graph, static_batch, metrics, launches, nodes, t1 - t0, t3 - t2)
        self.graphs[key] = g
        return g


def compile_train_step(step_fn: Callable) -> CompiledTrainStep:
    """`step_fn` (a `make_train_step` step) compiled: one CUDA graph per
    batch shape on CUDA state, the step itself on CPU state (see
    `CompiledTrainStep`).  The counterpart of the reference's
    `jax.jit(step_fn, donate_argnums=(0, 1))`."""
    return CompiledTrainStep(step_fn)


def init_train_state(model: Model, generator: torch.Generator,
                     opt_cfg: AdamWConfig | None = None) -> TrainState:
    opt_cfg = opt_cfg or AdamWConfig()
    params = model.init(generator)
    return TrainState(params=params, opt_state=init_opt_state(params, opt_cfg))
