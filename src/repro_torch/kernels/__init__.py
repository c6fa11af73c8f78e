"""Hand-written Hopper kernels of the serving and training paths.

Each kernel directory holds its CUDA source under `csrc/` and an `ops.py`
with the launching wrapper, its counters (launches, and the bytes and
operations of those launches, `work.py`) and the plain PyTorch version of
the same function.  `_lib.py` builds the sources with nvcc at first use.
"""

def counters() -> dict:
    """Each kernel's launching wrapper, by kernel name; its `launches`
    attribute counts the launches (or, under CUDA graph capture, the
    recordings; on the meta device, the launches skipped) of its kernel,
    `nbytes` and `ops` their work (`work.py`)."""
    from .boundary_quant import ops as bq
    from .decode_attention import ops as da
    from .flash_attention import ops as fa
    from .rmsnorm import ops as rn
    from .ssd_scan import ops as ssd

    return {"quantize": bq.quantize, "dequantize": bq.dequantize, "rmsnorm": rn.rmsnorm,
            "flash_attention": fa.flash_attention, "decode_attention": da.decode_attention,
            "ssd_scan": ssd.ssd_scan, "rmsnorm_backward": rn.rmsnorm_backward,
            "flash_attention_forward_lse": fa.flash_attention_forward_lse,
            "flash_attention_backward": fa.flash_attention_backward,
            "ssd_scan_backward": ssd.ssd_scan_backward}


def launch_counts() -> dict[str, int]:
    return {name: fn.launches for name, fn in counters().items()}


def work_counts() -> dict[str, dict]:
    """Each kernel's launches, bytes and operations by precision class."""
    return {name: {"launches": fn.launches, "nbytes": fn.nbytes, "ops": dict(fn.ops)}
            for name, fn in counters().items()}


def reset_counts() -> None:
    from .work import reset

    for fn in counters().values():
        reset(fn)
