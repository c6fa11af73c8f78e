"""Atomic, async-capable checkpointing (no external deps), the reference's
`training/checkpoint.py` with its on-disk layout:

    <dir>/step_<N>/
        manifest.json   step, structure, and per leaf: file, shape, dtype,
                        sha256 prefix of its bytes
        arr_<i>.npy     one file a leaf, in flatten order (dict keys sorted)
        _COMMITTED      written last -> partial checkpoints are ignored

A step is written into `step_<N>.tmp` and renamed into place.  The bytes are
the reference's: a bfloat16 leaf is saved as the reference's `np.save` of an
ml_dtypes array writes it (header descr '<V2', the raw 16-bit patterns;
"bfloat16" in the manifest), from the tensor's bits alone, and read back the
same way; every other dtype is `np.save` of its numpy array.  So a step
written by either package restores in the other with equal bytes (the
reference's own `restore` cannot cast a '<V2' leaf to bfloat16; the port's
reads the manifest's dtype).  `restore` places each leaf on the device and
in the dtype of the matching leaf of `like`, so a run resumes wherever its
fresh state lives.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import threading
import time

import numpy as np
import torch

from .tree import leaves, structure, unflatten

BF16 = "bfloat16"


def _host(t: torch.Tensor) -> tuple[np.ndarray, str]:
    """A leaf as (numpy array of its bytes, manifest dtype): a bf16 leaf as
    its int16 bit patterns."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy(), BF16
    arr = t.numpy()
    return arr, str(arr.dtype)


def _write_npy(path: str, arr: np.ndarray, dtype: str) -> None:
    if dtype != BF16:
        np.save(path, arr)
        return
    with open(path, "wb") as f:
        np.lib.format.write_array_header_1_0(
            f, {"descr": "<V2", "fortran_order": False, "shape": tuple(arr.shape)})
        f.write(np.ascontiguousarray(arr).tobytes())


def _read_npy(path: str, dtype: str) -> tuple[torch.Tensor, bytes]:
    """(the leaf as a CPU tensor, its bytes for the checksum)."""
    arr = np.load(path)
    raw = arr.tobytes()
    if dtype == BF16:
        if arr.dtype.itemsize != 2:
            raise ValueError(f"{path}: a bfloat16 leaf of {arr.dtype} elements")
        bits = np.frombuffer(raw, dtype=np.int16).reshape(arr.shape)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16), raw
    return torch.from_numpy(np.array(arr, copy=True)), raw


def save(directory: str, step: int, tree, async_: bool = False) -> threading.Thread | None:
    """Write a checkpoint; the device-to-host copy happens here, and with
    async_=True the files are written on a background thread."""
    host = [_host(x) for x in leaves(tree)]
    treedef = structure(tree)

    def _write():
        final = os.path.join(directory, f"step_{step:08d}")
        tmp = final + ".tmp"
        os.makedirs(tmp, exist_ok=True)
        manifest = {"step": step, "treedef": treedef, "leaves": []}
        for i, (arr, dtype) in enumerate(host):
            fname = f"arr_{i:05d}.npy"
            _write_npy(os.path.join(tmp, fname), arr, dtype)
            manifest["leaves"].append(
                {
                    "file": fname,
                    "shape": list(arr.shape),
                    "dtype": dtype,
                    "sha256": hashlib.sha256(arr.tobytes()).hexdigest()[:16],
                }
            )
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        with open(os.path.join(tmp, "_COMMITTED"), "w") as f:
            f.write(str(time.time()))
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)

    if async_:
        t = threading.Thread(target=_write, daemon=True)
        t.start()
        return t
    _write()
    return None


def latest_step(directory: str) -> int | None:
    """Newest *committed* checkpoint step, or None."""
    if not os.path.isdir(directory):
        return None
    best = None
    for name in os.listdir(directory):
        if not name.startswith("step_") or name.endswith(".tmp"):
            continue
        if not os.path.exists(os.path.join(directory, name, "_COMMITTED")):
            continue  # torn write (e.g. node died mid-save): skip
        step = int(name.split("_")[1])
        best = step if best is None or step > best else best
    return best


def restore(directory: str, like, step: int | None = None):
    """(a tree of `like`'s structure restored from the checkpoint, its step);
    verifies checksums and shapes."""
    step = step if step is not None else latest_step(directory)
    if step is None:
        raise FileNotFoundError(f"no committed checkpoint under {directory}")
    path = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)

    like_leaves = leaves(like)
    if len(like_leaves) != len(manifest["leaves"]):
        raise ValueError(
            f"checkpoint has {len(manifest['leaves'])} leaves, expected {len(like_leaves)}"
        )
    out = []
    for meta, like_leaf in zip(manifest["leaves"], like_leaves):
        t, raw = _read_npy(os.path.join(path, meta["file"]), meta["dtype"])
        digest = hashlib.sha256(raw).hexdigest()[:16]
        if digest != meta["sha256"]:
            raise IOError(f"checksum mismatch in {meta['file']} (corrupt checkpoint)")
        if tuple(t.shape) != tuple(like_leaf.shape):
            raise ValueError(
                f"shape mismatch {tuple(t.shape)} vs {tuple(like_leaf.shape)} for {meta['file']}"
            )
        out.append(t.to(device=like_leaf.device, dtype=like_leaf.dtype))
    return unflatten(like, out), step


def prune(directory: str, keep: int = 3) -> None:
    """Keep only the newest `keep` committed checkpoints."""
    if not os.path.isdir(directory):
        return
    steps = sorted(
        int(n.split("_")[1])
        for n in os.listdir(directory)
        if n.startswith("step_") and not n.endswith(".tmp")
        and os.path.exists(os.path.join(directory, n, "_COMMITTED"))
    )
    for s in steps[:-keep]:
        shutil.rmtree(os.path.join(directory, f"step_{s:08d}"), ignore_errors=True)
