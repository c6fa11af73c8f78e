"""Build, load and route to the port's CUDA kernels.

Each kernel's `csrc/*.cu` is compiled by `nvcc` for `sm_90a` into its own
shared library with a plain C interface and loaded with `ctypes`.  The build
runs at first use (or up front through `build_all`, which starts one `nvcc`
per source in parallel) into `_build/` beside this file, resolved from the
package's path so the working directory does not matter.  A library's file
name carries a hash of every file in its `csrc/` directory (the source and
the headers it includes) and of the flags, so an edited file rebuilds.

`route(...)` is the one device rule every wrapper follows: CPU tensors take
the plain PyTorch version, CUDA tensors launch the kernel (or raise), and
any other device raises.  Nothing falls back.  Meta tensors (shapes and
dtypes, no storage: the dry run, `launch/hlo_analysis.py`) take the CUDA
route's Python code, its checks, copies, allocations, plans and autograd
`Function`s, and skip only the launch (`launch`): no library is loaded
and no plain version runs (it would allocate what the kernel never
writes).  A device query on a meta tensor answers with the H100's value
(`sm_count`; the occupancy reads in `occupancy.py`).  `needs_grad(...)` is the
rule under autograd: a CUDA input that needs a gradient goes through the
kernel's `torch.autograd.Function` (rmsnorm, flash attention's training
route, the SSD scan in bf16), or, for a kernel with no backward, raises (`no_backward`, a
`ProgramError`): a kernel's output never silently drops its inputs'
gradients.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

KERNELS_DIR = Path(__file__).resolve().parent
BUILD_DIR = KERNELS_DIR / "_build"
SOURCES = {
    "boundary_quant": KERNELS_DIR / "boundary_quant" / "csrc" / "boundary_quant.cu",
    "rmsnorm": KERNELS_DIR / "rmsnorm" / "csrc" / "rmsnorm.cu",
    "flash_attention": KERNELS_DIR / "flash_attention" / "csrc" / "flash_attention.cu",
    "decode_attention": KERNELS_DIR / "decode_attention" / "csrc" / "decode_attention.cu",
    "ssd_scan": KERNELS_DIR / "ssd_scan" / "csrc" / "ssd_scan.cu",
}
# no --use_fast_math: quantize must match its plain version bit for bit,
# which needs IEEE division (-prec-div=true) and rintf
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-prec-div=true", "-Xptxas=-v", "-shared", "-Xcompiler", "-fPIC")

# dtype codes shared with every csrc/*.cu that takes both dtypes
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_libs: dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def nvcc_path() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return found


def lib_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(p for p in SOURCES[name].parent.iterdir() if p.is_file()):
        h.update(f.name.encode() + b"\0" + f.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def build_all(names=tuple(SOURCES)) -> dict[str, float]:
    """Compile every library in `names` that is not built yet, one `nvcc`
    process per source, all started together.  Returns the build seconds
    of each library compiled here (0.0 for one found built).  Raises with
    the compiler's output if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    procs = {}
    for name in names:
        out = lib_path(name)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCES[name])]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    seconds = {name: 0.0 for name in names}
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        out.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
            continue
        os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return seconds


def load(name: str, signatures: dict[str, list]) -> ctypes.CDLL:
    """The loaded library for kernel `name`, built first if needed, with
    `argtypes` set from `signatures` ({C function: [ctypes types]}).  Every
    C entry point returns a CUDA error code as an int."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build_all((name,))
            lib = ctypes.CDLL(str(lib_path(name)))
            for fn, argtypes in signatures.items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
            _libs[name] = lib
        return lib


def route(*tensors: torch.Tensor) -> bool:
    """True for the kernel's route (CUDA; meta, which skips the launch),
    False for the plain version (CPU).

    Every tensor must sit on one device; any device other than CPU, CUDA
    or meta raises, as does a mix."""
    dev = tensors[0].device
    for t in tensors[1:]:
        if t.device != dev:
            raise ValueError(f"tensors on different devices: {dev} and {t.device}")
    if dev.type == "cpu":
        return False
    if dev.type in ("cuda", "meta"):
        return True
    raise RuntimeError(f"no kernel and no plain version for device {dev}")


def launch(t: torch.Tensor, name: str, call) -> None:
    """Run `call()`, a C entry point's launch, and raise on its error; on
    a meta tensor skip it: there is no storage to run on."""
    if t.device.type != "meta":
        check(name, call())


def needs_grad(*tensors) -> bool:
    """True when autograd records: grad mode is on and any input (None
    allowed) requires a gradient."""
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


class ProgramError(Exception):
    """A program the port cannot run on the card as asked: a kernel asked
    for a gradient it has no backward for, or a train step that cannot be
    captured as a CUDA graph.  Not a `RuntimeError`, on purpose: the elastic
    training loop takes every `RuntimeError` for a node failure and
    restarts, and retrying cannot mend a program."""


def no_backward(kernel: str, item: str) -> ProgramError:
    """The error of a CUDA kernel asked for a gradient it has no backward
    for; `item` names the ROADMAP entry that brings one."""
    return ProgramError(
        f"{kernel} has no backward kernel on CUDA (its output would carry no gradient): "
        f"{item}; call it without grad, or on CPU tensors for the plain version")


# streaming multiprocessors of an NVIDIA H100 SXM: what a meta tensor's
# device queries answer
H100_SMS = 132


@functools.lru_cache(maxsize=None)
def sm_count(device: torch.device | int | None) -> int:
    """Streaming multiprocessors of CUDA device `device` (an index, or None
    for the current one), looked up once; `H100_SMS` for the meta device."""
    if isinstance(device, torch.device):
        if device.type == "meta":
            return H100_SMS
        device = device.index
    return torch.cuda.get_device_properties(device).multi_processor_count


def dtype_code(t: torch.Tensor) -> int:
    code = DTYPE_CODES.get(t.dtype)
    if code is None:
        raise TypeError(f"kernel takes float32 or bfloat16, got {t.dtype}")
    return code


def stream_handle(t: torch.Tensor) -> int:
    """The current CUDA stream of `t`'s device; 0 on meta (no stream)."""
    if t.device.type == "meta":
        return 0
    return torch.cuda.current_stream(t.device).cuda_stream


def check(name: str, err: int) -> None:
    """Raise if a C entry point returned a CUDA error (e.g. a refused launch)."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")
