"""Roofline terms and memory of a step traced on the meta device.

The counterpart of the reference's `launch/hlo_analysis.py`, which reads
FLOPs, bytes and memory from a compiled XLA executable.  The port has no
compiled artifact to read: `analyze_traced` runs the real step on PyTorch's
`meta` device (shapes and dtypes, no storage), through the port's own CUDA
route, kernel wrappers included (`kernels/_lib.py`: a meta tensor takes the
kernel's Python code and skips the launch), under one `TorchDispatchMode`
that sees every aten op, the backward's too, and counts as it goes:

* memory: every storage on the step's device, from its first appearance as
  an op's output to its release, rounded up to the caching allocator's 512
  bytes; views share their storage's count; the storages of the step's
  arguments (parameters, optimizer state, batch, cache) count from the
  start.  The peak is the largest live total, the counterpart of what
  `torch.cuda.max_memory_allocated` reads on the card (which also holds
  what a CUDA kernel allocates inside itself, invisible here);
* FLOPs: 2 x M x N x K for each matrix product (`mm`, `addmm`, `bmm`,
  `baddbmm`, into which einsum and linear decompose under autograd; under
  inference mode `matmul`, `linear` and `einsum` arrive whole), plus each
  kernel's own operations (`kernels/work.py`);
* bytes: each aten op's inputs and outputs read and written once (views,
  and composites whose output is a view, move nothing), plus each
  kernel's bytes; like XLA's "bytes accessed", an upper bound on what the
  fused program would move.

`shape_bytes` and `parse_collectives` read HLO text and have no
counterpart: the port runs no sharded step and emits no HLO.

Hardware constants: the NVIDIA H100 80GB HBM3 (SXM) data sheet at its 700 W
power limit: 989 TFLOP/s bf16 dense, 3.35 TB/s HBM, 450 GB/s NVLink each way
(18 links of fourth-generation NVLink) in place of the TPU's ICI rate.
"""

from __future__ import annotations

import math
import time
import weakref
from dataclasses import dataclass

import torch
from torch.utils._python_dispatch import TorchDispatchMode

PEAK_FLOPS = 989e12
HBM_BW = 3.35e12
NVLINK_BW = 450e9

ALLOC_BLOCK = 512  # the CUDA caching allocator rounds every block up to this


@dataclass
class RooflineTerms:
    flops_per_device: float
    hbm_bytes_per_device: float
    collective_bytes_per_device: float
    n_devices: int

    @property
    def compute_s(self) -> float:
        return self.flops_per_device / PEAK_FLOPS

    @property
    def memory_s(self) -> float:
        return self.hbm_bytes_per_device / HBM_BW

    @property
    def collective_s(self) -> float:
        return self.collective_bytes_per_device / NVLINK_BW

    @property
    def dominant(self) -> str:
        terms = {
            "compute": self.compute_s,
            "memory": self.memory_s,
            "collective": self.collective_s,
        }
        return max(terms, key=terms.get)

    @property
    def bound_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    def as_dict(self) -> dict:
        return {
            "flops_per_device": self.flops_per_device,
            "hbm_bytes_per_device": self.hbm_bytes_per_device,
            "collective_bytes_per_device": self.collective_bytes_per_device,
            "n_devices": self.n_devices,
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "dominant": self.dominant,
        }


def _block(nbytes: int) -> int:
    return -(-nbytes // ALLOC_BLOCK) * ALLOC_BLOCK


_aten = torch.ops.aten
# a matrix product's contraction width: this operand's last dim (under
# inference mode `matmul` and `linear` arrive whole, not as mm and bmm)
_MATMUL_K = {_aten.mm: 0, _aten.addmm: 1, _aten.bmm: 0, _aten.baddbmm: 1, _aten.matmul: 0,
             _aten.linear: 0}
_NO_ACCESS = {_aten.empty, _aten.empty_like, _aten.empty_strided}


def _moved(func, ins: list, outs: list) -> int:
    """The bytes an op reads and writes: its inputs and outputs once each;
    none for a functional op whose every output lies in an input's storage
    (a composite such as reshape that returned a view)."""
    if not func._schema.is_mutable and outs:
        keys = {t.untyped_storage()._cdata for t in ins}
        if all(t.untyped_storage()._cdata in keys for t in outs):
            return 0
    return sum(t.nbytes for t in ins) + sum(t.nbytes for t in outs)


def _einsum_flops(args) -> float:
    """2 x the product of every index's size, for each operand past the
    first: a multiply and an add for each combination of indices."""
    spec, operands = args[0], args[1]
    sizes = {}
    for term, t in zip(spec.split("->")[0].split(","), operands):
        term = term.strip()
        if "..." in term:
            return 0.0
        sizes.update(zip(term, t.shape))
    return 2.0 * math.prod(sizes.values()) * max(len(operands) - 1, 1)


def _tensors(items):
    for a in items:
        if isinstance(a, torch.Tensor):
            yield a
        elif isinstance(a, (list, tuple)):
            yield from (t for t in a if isinstance(t, torch.Tensor))


def _signature(items) -> tuple:
    """A hashable stand-in for an op's arguments: tensors by layout."""
    out = []
    for a in items:
        if isinstance(a, torch.Tensor):
            out.append((tuple(a.shape), a.stride(), a.dtype, a.device))
        elif isinstance(a, (list, tuple)):
            out.append(_signature(a))
        else:
            out.append(a)
    return tuple(out)


def tree_tensors(tree) -> list[torch.Tensor]:
    """Every tensor of a nested dict / list / tuple / `nn.Module` (its
    parameters and buffers)."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, torch.nn.Module):
        return [*tree.parameters(), *tree.buffers()]
    if isinstance(tree, dict):
        tree = tree.values()
    if isinstance(tree, (list, tuple, type({}.values()))):
        return [t for x in tree for t in tree_tensors(x)]
    return []


class MemoryTracker(TorchDispatchMode):
    """Live storage bytes on `device` (each rounded up to `ALLOC_BLOCK`),
    their peak, and the FLOPs and bytes of every aten op, while active.
    `hold(t)` adds a storage that exists before (an argument)."""

    def __init__(self, device) -> None:
        super().__init__()
        self.device = torch.device(device)
        self.sizes: dict[int, int] = {}  # live storages: key -> rounded bytes
        self.live = self.peak = 0
        self.flops = self.nbytes = 0.0
        self.ops = 0
        # (op, signature) -> (None for one tensor out, else the sequence's
        # type; its outputs' (shape, stride, dtype))
        self.layouts: dict = {}
        self.uncached: set = set()  # ops that write in place or alias an input

    def _cached(self, func, args, kwargs):
        """`func(*args, **kwargs)`, or on the device's second and later
        calls with the same signature (op, inputs' shapes, strides, dtypes,
        devices, other arguments), new empty outputs of the layouts the
        first call made: a meta op's outputs depend on nothing else, and
        making them directly spares the meta kernels' Python (an sLSTM
        time step is ~25 ops).  An op that writes in place, or whose output
        shares an input's storage, always runs."""
        if self.device.type != "meta" or func in self.uncached:
            return func(*args, **kwargs)
        try:
            key = (func, _signature(args), _signature(tuple(kwargs.items())))
            hash(key)
        except TypeError:
            return func(*args, **kwargs)
        known = self.layouts.get(key)
        if known is not None:
            kind, layouts = known
            made = [torch.empty_strided(shape, stride, dtype=dtype, device=self.device)
                    for shape, stride, dtype in layouts]
            return made[0] if kind is None else kind(made)
        out = func(*args, **kwargs)
        outs = [out] if isinstance(out, torch.Tensor) else out
        inputs = {t.untyped_storage()._cdata for t in _tensors(args)}
        if (func._schema.is_mutable or not isinstance(outs, (list, tuple)) or not outs
                or not all(isinstance(t, torch.Tensor) and t.device == self.device
                           for t in outs)
                or any(t.untyped_storage()._cdata in inputs for t in outs)):
            self.uncached.add(func)
            return out
        self.layouts[key] = (None if isinstance(out, torch.Tensor) else type(out),
                             [(t.shape, t.stride(), t.dtype) for t in outs])
        return out

    def hold(self, t: torch.Tensor) -> None:
        if t.device != self.device:
            return
        st = t.untyped_storage()
        key = st._cdata
        if key in self.sizes:
            return
        n = _block(st.nbytes())
        self.sizes[key] = n
        self.live += n
        self.peak = max(self.peak, self.live)
        # fires when the last tensor of the storage is gone
        weakref.finalize(st, self._release, key)

    def _release(self, key: int) -> None:
        self.live -= self.sizes.pop(key, 0)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = self._cached(func, args, kwargs)
        self.ops += 1
        outs = [out] if isinstance(out, torch.Tensor) else list(_tensors(out))
        packet = func.overloadpacket
        k = _MATMUL_K.get(packet)
        if k is not None:
            self.flops += 2.0 * outs[0].numel() * args[k].shape[-1]
        elif packet is _aten.einsum:
            self.flops += _einsum_flops(args)
        if not func.is_view and packet not in _NO_ACCESS:
            self.nbytes += _moved(func, list(_tensors(args)), outs)
        for t in outs:
            self.hold(t)
        return out


def storage_bytes(tensors, block: int = ALLOC_BLOCK) -> int:
    """The bytes of the distinct storages of `tensors`, each rounded up to
    `block` (the caching allocator's, by default: what they hold on the
    card; 1 for their own sizes)."""
    seen = {}
    for t in tensors:
        st = t.untyped_storage()
        seen[st._cdata] = -(-st.nbytes() // block) * block
    return sum(seen.values())


def analyze_traced(step, *args, n_devices: int = 1) -> tuple[RooflineTerms, dict]:
    """Run `step(*args)` once under a `MemoryTracker` on the device of its
    first tensor argument (meta, for the dry run), in place of the
    reference's `analyze_compiled`.  Returns the roofline terms (the aten
    ops' and the kernels' FLOPs and bytes) and a dict: `memory_analysis`
    (see `launch/dryrun.py`), `peak_size`, `kernels` (each kernel's
    launches, bytes and operations by precision class in this step),
    `aten_ops`, the aten ops traced, and `trace_s`, the trace's wall."""
    from repro_torch.kernels import work_counts

    arg_tensors = tree_tensors(list(args))
    device = arg_tensors[0].device
    tracker = MemoryTracker(device)
    for t in arg_tensors:
        tracker.hold(t)
    arg_keys = dict(tracker.sizes)
    argument = tracker.live
    before = work_counts()
    t0 = time.perf_counter()
    with tracker:
        out = step(*args)
    trace_s = time.perf_counter() - t0
    after = work_counts()
    kernels = {}
    for name, w in after.items():
        b = before[name]
        if w["launches"] > b["launches"]:
            kernels[name] = {"launches": w["launches"] - b["launches"],
                             "nbytes": w["nbytes"] - b["nbytes"],
                             "ops": {c: n - b["ops"].get(c, 0.0) for c, n in w["ops"].items()}}
    outs = {}
    for t in tree_tensors(out if isinstance(out, (list, tuple, dict)) else [out]):
        if t.device == device:
            st = t.untyped_storage()
            outs[st._cdata] = _block(st.nbytes())
    alias = sum(n for key, n in outs.items() if key in arg_keys)
    output = sum(outs.values())
    mem = {"argument_size": argument, "output_size": output, "alias_size": alias,
           "temp_size": tracker.peak - argument - (output - alias)}
    k_flops = sum(sum(w["ops"].values()) for w in kernels.values())
    k_bytes = sum(w["nbytes"] for w in kernels.values())
    terms = RooflineTerms(flops_per_device=tracker.flops + k_flops,
                          hbm_bytes_per_device=tracker.nbytes + k_bytes,
                          collective_bytes_per_device=0.0, n_devices=n_devices)
    del out
    return terms, {"memory_analysis": mem, "peak_size": tracker.peak, "kernels": kernels,
                   "aten_ops": tracker.ops, "trace_s": trace_s}


def model_flops(n_params_active: float, tokens: float, training: bool) -> float:
    """MODEL_FLOPS = 6*N*D for a training step; 2*N*D for inference."""
    return (6.0 if training else 2.0) * n_params_active * tokens


def analytic_hbm_bytes(cfg, shape, n_devices: int, tp: int = 16) -> float:
    """Per-device HBM traffic of the *deployed* (flash/chunked) implementation.

    The HLO byte count from the cost-true compile is an upper bound: it
    materializes unchunked attention scores that flash attention never writes
    to HBM.  This analytic estimate uses the control-plane cost model's
    per-layer activation/weight traffic (flash-style assumptions):

      train  : 3*W_local + 4*A_local + 12B/param moments traffic
      serve  : W_local + A_local (+ KV cache read for decode)
    """
    from repro_torch.models.model_zoo import layer_costs

    seq = shape.seq_len if shape.kind != "decode" else 1
    kv_len = shape.seq_len if shape.kind == "decode" else None
    costs = layer_costs(cfg, seq)
    dp = max(1, n_devices // tp)
    batch_local = max(1, shape.global_batch // dp)
    W_local = sum(c.weight_bytes for c in costs) / tp
    A_local = sum(c.act_bytes for c in costs) * batch_local
    if shape.kind == "train":
        opt_traffic = W_local * 6.0  # grads + m/v read/write (bf16..f32 mix)
        return 3.0 * W_local + 4.0 * A_local + opt_traffic
    if shape.kind == "decode" and kv_len:
        # KV-cache read dominates decode: bytes = cache_local per step
        cache = _decode_cache_bytes(cfg, kv_len, shape.global_batch) / n_devices
        return W_local + A_local + cache
    return W_local + A_local


def _decode_cache_bytes(cfg, kv_len: int, batch: int) -> float:
    if cfg.mla:
        per_tok = cfg.kv_lora_rank + cfg.qk_rope_dim
        return cfg.n_layers * batch * kv_len * per_tok * 2.0
    if cfg.family in ("ssm", "hybrid"):
        n_attn = cfg.ssm_pattern.count("a")
        per_tok = n_attn * 2 * cfg.kv_heads * cfg.hd
        state = cfg.n_layers * batch * cfg.d_model * cfg.ssm_expand * (cfg.d_state or cfg.d_model // max(cfg.n_heads,1)) * 4.0
        return batch * kv_len * per_tok * 2.0 + state
    n_self = cfg.n_layers
    per_tok = n_self * 2 * cfg.kv_heads * cfg.hd
    cross = (cfg.encoder_layers and cfg.n_layers * batch * kv_len * 2 * cfg.kv_heads * cfg.hd * 2.0) or 0.0
    return batch * kv_len * per_tok * 2.0 + cross
