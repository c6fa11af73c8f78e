"""Shared model machinery: the config, parameter templates and the basic ops
(RMSNorm, RoPE, SwiGLU MLP, chunked attention, decode attention) in PyTorch.

The functions here are the plain versions, op for op the math of the
reference's `repro.models.common`.  `Ops` names the ops the model paths may
run as kernels: `PLAIN` keeps the plain functions, `KERNELS` routes to the
Hopper kernels for CUDA tensors (and their plain versions for CPU tensors).
Sharding rules have no counterpart: the port runs each stage on one device.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Any, Callable

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from repro_torch.kernels.decode_attention import ops as da_ops
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.rmsnorm import ops as rn_ops
from repro_torch.kernels.ssd_scan import ops as ssd_ops

# ----------------------------------------------------------------------------
# Config
# ----------------------------------------------------------------------------


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0  # 0 -> d_model // n_heads
    qk_norm: bool = False
    qkv_bias: bool = False
    rope_theta: float = 1e4
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    # MoE
    n_experts: int = 0
    top_k: int = 0
    n_shared_experts: int = 0
    moe_d_ff: int = 0
    dense_layers: int = 0
    capacity_factor: float = 1.25
    # MLA (deepseek)
    mla: bool = False
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_dim: int = 0
    qk_rope_dim: int = 0
    v_head_dim: int = 0
    mtp: bool = False
    # SSM / hybrid
    ssm_pattern: str = ""
    d_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_chunk: int = 256
    # enc-dec
    encoder_layers: int = 0
    # modality frontend stub
    frontend: str = ""
    frontend_tokens: int = 0
    vocab_pad_multiple: int = 256
    dtype: Any = torch.bfloat16
    # compile-shape knobs of the reference, kept so `reduced()` and the
    # chunk sizes of `chunked_attention` stay identical
    cost_exact: bool = False
    layer_unroll: int = 1
    moe_dispatch_groups: int = 0
    moe_weight_gather: bool = False
    attn_q_chunk: int = 512
    attn_k_chunk: int = 1024
    ce_chunk: int = 2048

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def padded_vocab(self) -> int:
        m = self.vocab_pad_multiple
        return (self.vocab + m - 1) // m * m

    def reduced(self, **overrides) -> "ModelConfig":
        """A tiny same-family config for CPU smoke tests."""
        shrink = dict(
            n_layers=min(self.n_layers, 2 + (2 if self.dense_layers else 0)),
            d_model=128,
            n_heads=4,
            kv_heads=min(self.kv_heads, 4) if self.kv_heads else 0,
            d_ff=256 if self.d_ff else 0,
            vocab=512,
            head_dim=32,
        )
        if self.n_experts:
            shrink.update(n_experts=4, top_k=min(self.top_k, 2), moe_d_ff=64,
                          dense_layers=min(self.dense_layers, 1),
                          capacity_factor=8.0)
        if self.mla:
            shrink.update(q_lora_rank=64, kv_lora_rank=32, qk_nope_dim=16,
                          qk_rope_dim=16, v_head_dim=32, head_dim=32)
        if self.ssm_pattern:
            pat = _shrink_pattern(self.ssm_pattern)
            shrink.update(ssm_pattern=pat, n_layers=len(pat), d_state=16,
                          ssm_head_dim=16, ssm_chunk=8)
        if self.encoder_layers:
            shrink.update(encoder_layers=2)
        if self.frontend:
            shrink.update(frontend_tokens=8)
        shrink.update(overrides)
        return dataclasses.replace(self, **shrink)


def _shrink_pattern(pattern: str) -> str:
    """Keep one repetition of the layer pattern's period."""
    for period in range(1, len(pattern) + 1):
        if len(pattern) % period == 0 and pattern == pattern[:period] * (len(pattern) // period):
            return pattern[:period]
    return pattern[: min(4, len(pattern))]


# ----------------------------------------------------------------------------
# Parameter templates
# ----------------------------------------------------------------------------


# A leaf of more elements is drawn in slices along its leading axis, each
# scaled and cast into the result in turn, so the f32 draw never holds the
# whole leaf: one llama4-maverick-400b-a17b expert leaf (128, 5120, 8192)
# drawn whole is a 21.5 GB f32 draw and a second 21.5 GB temporary for its
# scaling, beside its 10.7 GB in bf16; its embedding and head (1.04e9
# elements each) 8.3 GB of f32 temporaries.  Every leaf of the other
# families' configs is at most qwen3-14b's embedding (7.8e8 elements) and
# drawn whole, as before the slices.
SLICE_ELEMS = 800_000_000


@dataclass(frozen=True)
class ParamDef:
    shape: tuple[int, ...]
    init: str = "normal"  # normal | zeros | ones
    scale: float | None = None  # default: 1/sqrt(fan_in)
    dtype: Any = torch.bfloat16
    # > 0: one layer's slice of a stack of `stacked` layers.  The reference
    # initialises the stacked array, whose fan-in is its leading (layers)
    # axis; the port keeps that formula for its per-layer tensors.
    stacked: int = 0

    def fan_in(self) -> int:
        if self.stacked:
            return self.stacked
        return self.shape[0] if len(self.shape) > 1 else self.shape[-1]

    def initialize(self, generator: torch.Generator) -> torch.Tensor:
        device = generator.device
        if self.init == "zeros":
            return torch.zeros(self.shape, dtype=self.dtype, device=device)
        if self.init == "ones":
            return torch.ones(self.shape, dtype=self.dtype, device=device)
        scale = self.scale if self.scale is not None else 1.0 / math.sqrt(self.fan_in())
        n = math.prod(self.shape)
        if n <= SLICE_ELEMS:
            x = torch.randn(self.shape, generator=generator, dtype=torch.float32, device=device)
            return (x * scale).to(self.dtype)
        out = torch.empty(self.shape, dtype=self.dtype, device=device)
        rows = max(1, SLICE_ELEMS // (n // self.shape[0]))
        for i in range(0, self.shape[0], rows):
            part = out[i:i + rows]
            x = torch.randn(part.shape, generator=generator, dtype=torch.float32, device=device)
            part.copy_(x.mul_(scale))
        return out


class ParamTree(torch.nn.Module):
    """A nested parameter container indexed like the reference's pytrees:
    `p["attn"]["wq"]`, `params["layers"][i]`, `params["inner"][g][k]`.
    Dicts become submodules, lists (of dicts or of lists) `ModuleList`s,
    tensors frozen `Parameter`s."""

    def __init__(self, tree: dict) -> None:
        super().__init__()
        for name, value in tree.items():
            if isinstance(value, torch.Tensor):
                self.register_parameter(
                    name, torch.nn.Parameter(value, requires_grad=False))
            else:
                self.add_module(name, _module(value))

    def __getitem__(self, name: str):
        return getattr(self, name)

    def __contains__(self, name: str) -> bool:
        return name in self._parameters or name in self._modules


def _module(node) -> torch.nn.Module:
    if isinstance(node, list):
        return torch.nn.ModuleList(_module(v) for v in node)
    return ParamTree(node)


def count_params(defs) -> int:
    """Elements of every leaf of a template tree."""
    if isinstance(defs, ParamDef):
        return math.prod(defs.shape)
    nodes = defs if isinstance(defs, list) else defs.values()
    return sum(count_params(n) for n in nodes)


def remat_call(fn: Callable, *args):
    """`fn(*args)` with its activations recomputed in the backward
    (`torch.utils.checkpoint`, non-reentrant): the counterpart of
    `jax.checkpoint`.  Without autograd recording it is the plain call.

    No RNG state is saved for the recompute (`preserve_rng_state=False`):
    no model draws random numbers in its forward, so the recompute is exact
    without it, and reading or setting the CUDA generator's state is
    refused while a CUDA graph captures the train step."""
    if not torch.is_grad_enabled():
        return fn(*args)
    return torch.utils.checkpoint.checkpoint(fn, *args, use_reentrant=False,
                                             preserve_rng_state=False)


def init_params(defs: dict, generator: torch.Generator) -> ParamTree:
    """Initialise a template tree ({name: ParamDef | dict | list}) on the
    generator's device."""
    return ParamTree(_build(defs, lambda d: d.initialize(generator)))


def empty_params(defs: dict, device) -> ParamTree:
    """The template tree as empty tensors on `device`, one per `ParamDef`
    with its shape and dtype; nothing is drawn (on the meta device: shapes
    and dtypes, no storage)."""
    return ParamTree(_build(defs, lambda d: torch.empty(d.shape, dtype=d.dtype, device=device)))


def _build(node, leaf: Callable):
    if isinstance(node, ParamDef):
        return leaf(node)
    if isinstance(node, list):
        return [_build(n, leaf) for n in node]
    return {k: _build(v, leaf) for k, v in node.items()}


# ----------------------------------------------------------------------------
# Basic ops
# ----------------------------------------------------------------------------


# the plain RMSNorm and decode attention are the kernels' plain versions:
# one definition of the math each
rms_norm = rn_ops.rmsnorm_plain
decode_attention = da_ops.decode_attention_plain


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., seq, heads, head_dim); positions: (..., seq).  Rotates the
    two halves of head_dim (not interleaved pairs)."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)
    angles = positions[..., :, None].float() * freqs
    cos = torch.cos(angles)[..., None, :]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def attn_chunks(cfg: ModelConfig, seq: int) -> tuple[int, int]:
    """(q_chunk, k_chunk) for chunked attention; full-seq when cost_exact."""
    if cfg.cost_exact:
        return seq, seq
    return cfg.attn_q_chunk, cfg.attn_k_chunk


def ssm_chunk_of(cfg: ModelConfig, seq: int) -> int:
    return seq if cfg.cost_exact else cfg.ssm_chunk


def ce_chunk_of(cfg: ModelConfig, seq: int) -> int:
    """Positions a chunk of the chunked cross-entropy."""
    return seq if cfg.cost_exact else min(seq, cfg.ce_chunk)


def swiglu(x: torch.Tensor, w_gate, w_up, w_down) -> torch.Tensor:
    g = x @ w_gate
    u = x @ w_up
    h = F.silu(g.float()).to(x.dtype) * u  # silu in f32, then cast
    return h @ w_down


def chunked_attention(
    q: torch.Tensor,  # (B, Tq, H, D)
    k: torch.Tensor,  # (B, Tk, KH, D)
    v: torch.Tensor,  # (B, Tk, KH, Dv)
    causal: bool = True,
    q_offset: int = 0,
    kv_len: int | None = None,
    q_chunk: int = 512,
    k_chunk: int = 1024,
    softmax_scale: float | None = None,
) -> torch.Tensor:
    """Flash-style attention in plain PyTorch: online softmax over key
    chunks, f32 scores and accumulators, the probabilities cast to v's
    dtype before the PV product (as the reference's einsum does)."""
    B, Tq, H, D = q.shape
    _, Tk, KH, Dv = v.shape
    G = H // KH
    scale = softmax_scale or 1.0 / math.sqrt(D)
    q = q.reshape(B, Tq, KH, G, D)
    q_chunk = min(q_chunk, Tq)
    k_chunk = min(k_chunk, Tk)
    nq = -(-Tq // q_chunk)
    nk = -(-Tk // k_chunk)
    pad_q = nq * q_chunk - Tq
    pad_k = nk * k_chunk - Tk
    if pad_q:
        q = F.pad(q, (0, 0, 0, 0, 0, 0, 0, pad_q))
    if pad_k:
        k = F.pad(k, (0, 0, 0, 0, 0, pad_k))
        v = F.pad(v, (0, 0, 0, 0, 0, pad_k))
    valid_k = Tk if kv_len is None else kv_len
    dev = q.device
    outs = []
    for qi in range(nq):
        qblk = q[:, qi * q_chunk:(qi + 1) * q_chunk].float()  # (B, qc, KH, G, D)
        q_pos = q_offset + qi * q_chunk + torch.arange(q_chunk, device=dev)
        m = torch.full((B, KH, G, q_chunk), -math.inf, dtype=torch.float32, device=dev)
        l = torch.zeros((B, KH, G, q_chunk), dtype=torch.float32, device=dev)
        acc = torch.zeros((B, KH, G, q_chunk, Dv), dtype=torch.float32, device=dev)
        for kj in range(nk):
            kblk = k[:, kj * k_chunk:(kj + 1) * k_chunk]
            vblk = v[:, kj * k_chunk:(kj + 1) * k_chunk]
            k_pos = kj * k_chunk + torch.arange(k_chunk, device=dev)
            s = torch.einsum("bqhgd,bkhd->bhgqk", qblk, kblk.float()) * scale
            mask = k_pos[None, :] < valid_k
            if causal:
                mask = mask & (k_pos[None, :] <= q_pos[:, None])
            s = torch.where(mask, s, torch.full_like(s, -1e30))
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            pv = torch.einsum("bhgqk,bkhd->bhgqd", p.to(vblk.dtype).float(), vblk.float())
            acc = acc * corr[..., None] + pv
            m = m_new
        out = acc / torch.clamp(l, min=1e-30)[..., None]
        outs.append(out.permute(0, 3, 1, 2, 4))  # (B, qc, KH, G, Dv)
    out = torch.cat(outs, dim=1).reshape(B, nq * q_chunk, H, Dv)
    return out[:, :Tq].to(v.dtype)


# ----------------------------------------------------------------------------
# The ops the model paths may run as kernels
# ----------------------------------------------------------------------------


@dataclass(frozen=True)
class Ops:
    """The port's counterpart of the reference's `rules` argument, threaded
    through every model function:

    * `rms_norm(x, w, eps)`;
    * causal self-`attention(cfg, q, k, v)` in the (B, T, H, D) layout;
    * `noncausal_attention(cfg, q, k, v)`: every query over every key, q
      (B, Tq, H, D) against k/v (B, Tk, KH, D) of any Tk (the encoder's
      self-attention, Tq == Tk, and the decoder's cross-attention);
    * `decode_attention(q, k_cache, v_cache, kv_len)`: q (B, 1, H, D)
      against a (B, S, KH, D) cache;
    * `linear_attention(q, k, v, log_g, log_i=None, chunk=256)`: the
      chunked decayed scan from a zero state in the (B, T, NH, D) layout
      (q and k may be one head, (B, T, 1, D), broadcast over v's NH),
      returning (y, final f32 state)."""

    rms_norm: Callable
    attention: Callable
    noncausal_attention: Callable
    decode_attention: Callable
    linear_attention: Callable


def _chunked_causal(cfg: ModelConfig, q, k, v) -> torch.Tensor:
    qc, kc = attn_chunks(cfg, q.shape[1])
    return chunked_attention(q, k, v, causal=True, q_chunk=qc, k_chunk=kc)


def _chunked_noncausal(cfg: ModelConfig, q, k, v) -> torch.Tensor:
    # the reference's chunks: attn_chunks over the longer of the two lengths
    qc, kc = attn_chunks(cfg, max(q.shape[1], k.shape[1]))
    return chunked_attention(q, k, v, causal=False, q_chunk=qc, k_chunk=kc)


def _flash_causal(cfg: ModelConfig, q, k, v) -> torch.Tensor:
    return fa_ops.attention_bthd(q, k, v)


def _flash_noncausal(cfg: ModelConfig, q, k, v) -> torch.Tensor:
    return fa_ops.attention_bthd(q, k, v, causal=False)


# the reference's math, op for op, on any device
PLAIN = Ops(rms_norm=rms_norm, attention=_chunked_causal, noncausal_attention=_chunked_noncausal,
            decode_attention=decode_attention,
            linear_attention=ssd_ops.chunked_linear_attention_plain)
# the Hopper kernels for CUDA tensors; their plain versions for CPU tensors
KERNELS = Ops(rms_norm=rn_ops.rmsnorm, attention=_flash_causal,
              noncausal_attention=_flash_noncausal,
              decode_attention=da_ops.decode_attention_bthd,
              linear_attention=ssd_ops.ssd_scan_bthd)
