"""The SSD scan's wide route (DK or DV past 64, the mLSTM's) on the CPU: its
scratch and the backward's wiring, through the CUDA route's Python on the
meta device (shapes, allocations and launch counts; no kernel runs).

* `scratch_shapes`: past one state tile no chunk's local state is
  allocated (the state pass keeps each tile's state on chip).
* `backward_scratch_shapes`: the pairs route's own scratch, beside the
  forward's `SAVED` cum, li and entering, with no local-state buffer.
* `_ScanFn` keeps `SAVED` on either backward route, and a train step's
  backward then launches no forward kernel; a direct `ssd_scan_backward`
  without `saved=` launches the forward first.
"""

import pytest
import torch

from repro_torch.kernels import work_counts
from repro_torch.kernels.ssd_scan import ops as ssd

bf16 = torch.bfloat16
# (B, T, NH, DK, DV, chunk, q/k one head, log_i): xlstm-1.3b's mLSTM cut to
# 2 heads and a ragged T, a state past one tile in DV alone, and a narrow one
SHAPES = {"mlstm": (2, 300, 2, 1024, 1025, 256, False, True),
          "dv_129": (1, 200, 3, 64, 129, 64, False, True),
          "narrow": (2, 40, 3, 16, 16, 16, True, False)}


def _launches(name: str) -> int:
    return work_counts()[name]["launches"]


def _meta_inputs(B, T, NH, DK, DV, one, with_i, grad=False):
    heads = 1 if one else NH
    ts = [torch.empty(B, T, heads, DK, dtype=bf16, device="meta"),
          torch.empty(B, T, heads, DK, dtype=bf16, device="meta"),
          torch.empty(B, T, NH, DV, dtype=bf16, device="meta"),
          torch.empty(B, T, NH, device="meta"),
          torch.empty(B, T, NH, device="meta") if with_i else None]
    return [None if t is None else t.requires_grad_(grad) for t in ts]


@pytest.mark.parametrize("dtype,parts", [(bf16, 2), (torch.float32, 3)])
def test_wide_forward_scratch_has_no_local_states(dtype, parts):
    """At the mLSTM's train micro-batch the forward allocates cum, li, the
    entering states (285 MB in bf16) and the scores, and no local states."""
    B, T, NH, DK, DV, chunk = 4, 1024, 4, 1024, 1025, 256
    shapes = ssd.scratch_shapes(B, T, NH, DK, DV, chunk, dtype)
    assert set(shapes) == {"cum", "li", "entering", "scores"}
    assert shapes["entering"] == ((B, NH, 4, 16 * 17, parts, 64, 64), bf16)
    assert shapes["scores"] == ((B, NH, 4, 10, 3, 64, 64), bf16)
    if dtype == bf16:
        size = 4 * 4 * 4 * 272 * 2 * 64 * 64 * 2
        assert size == 285_212_672
    narrow = ssd.scratch_shapes(B, T, 80, 64, 64, chunk, dtype)
    assert narrow["local"] == ((B, 80, 4, 1, 64, 64), torch.float32)
    assert "scores" not in narrow


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_backward_scratch_shapes(name):
    """The pairs route's scratch holds no local states and none of the
    forward's `SAVED` buffers, which come from the forward; with them it is
    `BACKWARD_SCRATCH`, in the C entry's order.  The state cotangents are
    laid out as the entering states, the pairs' P and dS in two bf16 parts,
    the decay term one value a state tile."""
    B, T, NH, DK, DV, chunk, _, _ = SHAPES[name]
    chunk = min(chunk, T)
    shapes = ssd.backward_scratch_shapes(B, T, NH, DK, DV, chunk)
    forward = ssd.scratch_shapes(B, T, NH, DK, DV, chunk, bf16)
    assert "local" not in shapes
    assert not set(shapes) & set(ssd.SAVED)
    assert tuple(n for n in ssd.BACKWARD_SCRATCH if n not in shapes) == ssd.SAVED
    assert set(shapes) | set(ssd.SAVED) == set(ssd.BACKWARD_SCRATCH)
    nc, nt = -(-T // chunk), -(-chunk // 64)
    tiles = -(-DK // 64) * -(-DV // 64)
    assert shapes["gstate"] == forward["entering"]
    pairs = nt * (nt + 1) // 2
    assert shapes["pmat"] == shapes["dsmat"] == ((B, NH, nc, pairs, 2, 64, 64), bf16)
    assert shapes["dpart"] == ((B, NH, nc, tiles), torch.float32)
    # the C entry's pointers: 12 tensors and the scratch
    assert len([t for t in ssd._SIGNATURES["ssd_backward"] if t is ssd._P]) == \
        12 + len(ssd.BACKWARD_SCRATCH) + 1  # and the stream


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_scan_fn_keeps_saved_on_either_route(name):
    """Under grad `_ScanFn` saves the forward's cum, li and entering states
    beside the inputs, on the pairs route as on the heads route; the
    backward of y then launches `ssd_scan_backward` once and no forward."""
    B, T, NH, DK, DV, chunk, one, with_i = SHAPES[name]
    chunk = min(chunk, T)
    route = ssd.backward_plan(B, T, NH, 1 if one else NH, DK, DV, chunk)[0]
    assert route == ("heads" if name == "narrow" else "pairs")
    args = _meta_inputs(B, T, NH, DK, DV, one, with_i, grad=True)
    before = _launches("ssd_scan")
    y, state = ssd.ssd_scan_bthd(*args, chunk=chunk)
    assert _launches("ssd_scan") == before + 1
    saved = y.grad_fn.saved_tensors
    forward = ssd.scratch_shapes(B, T, NH, DK, DV, chunk, bf16)
    assert len(saved) == 5 + len(ssd.SAVED)
    for n, t in zip(ssd.SAVED, saved[5:]):
        assert (tuple(t.shape), t.dtype) == (forward[n][0], forward[n][1]), n
    fwd, bwd = _launches("ssd_scan"), _launches("ssd_scan_backward")
    grads = torch.autograd.grad(y, [t for t in args if t is not None],
                                torch.empty_like(y, device="meta"))
    assert _launches("ssd_scan") == fwd
    assert _launches("ssd_scan_backward") == bwd + 1
    for g, t in zip(grads, [t for t in args if t is not None]):
        assert (g.shape, g.dtype) == (t.shape, t.dtype)


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_direct_backward_runs_the_forward_first(name):
    """`ssd_scan_backward` with no `saved=` makes the forward's scratch with
    one forward launch, on either route; with `forward_saved`'s, none."""
    B, T, NH, DK, DV, chunk, one, with_i = SHAPES[name]
    chunk = min(chunk, T)
    args = _meta_inputs(B, T, NH, DK, DV, one, with_i)
    dy = torch.empty(B, T, NH, DV, dtype=bf16, device="meta")
    fwd, bwd = _launches("ssd_scan"), _launches("ssd_scan_backward")
    ssd.ssd_scan_backward(*args, dy, None, chunk=chunk)
    assert (_launches("ssd_scan"), _launches("ssd_scan_backward")) == (fwd + 1, bwd + 1)
    saved = ssd.forward_saved(*args, chunk=chunk)
    fwd = _launches("ssd_scan")
    ssd.ssd_scan_backward(*args, dy, None, chunk=chunk, saved=saved)
    assert (_launches("ssd_scan"), _launches("ssd_scan_backward")) == (fwd, bwd + 2)
