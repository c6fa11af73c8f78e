"""Dry run of each (arch x shape) cell on the meta device: memory and FLOPs
of its real step on one H100, with no card.

The counterpart of the reference's `launch/dryrun.py`, as far as one card
goes.  For each cell of `configs.SHAPES` x `ARCH_IDS` it builds the port's
own step function, exactly as the card runs it (the train step with remat
and gradient accumulation, the prefill, the decode step), on parameters
from `Model.shapes()` and inputs from `configs.input_specs`, all on the
meta device, and runs it once under `hlo_analysis.analyze_traced`, through
the kernels' CUDA route with the launches skipped.  The train step runs
eagerly (on the card `compile_train_step` would capture it in a CUDA
graph, whose pool this does not count).  Every Python loop runs in full
(layer stacks, attention chunks, the sLSTM's time steps), so no unrolled
pair of compiles and no extrapolation is needed.

A record holds the reference's keys where they mean the same thing: arch,
shape, mesh ("1xH100"), variant ("baseline"), status ("ok", "skip" with
the reference's reason, or "error" with the traceback), n_devices,
n_params, active_params, trace_s (the trace's wall, in place of the
reference's lower_s and compile_s) and memory_analysis, whose four fields
are XLA's:

  argument_size  the step's inputs: parameters, optimizer state, batch or
                 cache;
  output_size    its outputs, those in new storage and those written into
                 an input's storage;
  alias_size     the outputs written into an input's storage, the
                 counterpart of donation (the train step updates the
                 parameters and moments in place; the decode step its
                 cache);
  temp_size      the peak less the arguments and the outputs in new
                 storage: activations, gradients, workspaces,

so that `hbm_per_device_gb`, by the reference's formula (argument + output
+ temp - alias), is the peak of live bytes (`peak_size`), each storage
rounded up to the caching allocator's 512 bytes.  `fits_one_card` holds
that peak against 79.18 GiB, the total `torch.cuda` reports on an H100
80GB HBM3; the allocator's fragmentation and a CUDA graph's pool are not
counted.  Unless --memory-only: `roofline` (`hlo_analysis.RooflineTerms`
of the traced FLOPs and bytes), `analytic_hbm_bytes_per_device` and
`analytic_memory_s` (the reference's analytic traffic, with no tensor
parallelism on one card), `model_flops_total`, `model_flops_per_device`,
`useful_flops_ratio` (model FLOPs over traced ones), and `kernels`, each
kernel's launches, bytes and operations by precision class.  Beside them:
`argument_bytes`, the inputs' own bytes by kind (params, opt_state, batch,
cache), and `accum`, the micro-batches of a train step.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-1.5b --shape train_4k

runs on a machine with no card (PyTorch built for the CPU will do).  The
reference's --multi-pod and --variant, its sharding rules and `mesh.py`
have no counterpart: the port runs no sharded step (PERF.md, section 7).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import traceback

import torch

from repro_torch.configs import ARCH_IDS, SHAPES, get_config, input_specs, shape_applicable
from repro_torch.launch import hlo_analysis
from repro_torch.models.common import count_params
from repro_torch.models.model_zoo import build_model
from repro_torch.training.optimizer import AdamWConfig, init_opt_state
from repro_torch.training.train_lib import make_train_step

MESH = "1xH100"
CARD_BYTES = 79.18 * 2**30  # what torch.cuda reports an H100 80GB HBM3 holds


def active_params(cfg, n_params: float) -> float:
    """Parameters touched per token (MoE: routed top-k + shared only)."""
    if not cfg.n_experts:
        return n_params
    ff = cfg.moe_d_ff or cfg.d_ff
    per_expert = 3 * cfg.d_model * ff
    n_moe_layers = cfg.n_layers - cfg.dense_layers
    routed_total = per_expert * cfg.n_experts * n_moe_layers
    routed_active = per_expert * cfg.top_k * n_moe_layers
    return n_params - routed_total + routed_active


def cell_step(model, shape, accum: int = 1, remat: bool = True):
    """(step, args, inputs by name) of one cell: the step function as the
    card runs it and its arguments, empty tensors on the meta device."""
    params = model.shapes()
    specs = input_specs(model.cfg, shape)
    if shape.kind == "train":
        n_params = count_params(model.defs)
        opt_cfg = AdamWConfig(moment_dtype=torch.bfloat16 if n_params > 100e9 else torch.float32)
        opt = init_opt_state(params, opt_cfg)
        step = make_train_step(model, opt_cfg, remat=remat, accum_steps=accum)
        return step, (params, opt, specs), {"params": params, "opt_state": opt, "batch": specs}
    if shape.kind == "prefill":
        def serve_prefill(params, batch):
            with torch.inference_mode():
                return model.prefill(params, batch, max_len=shape.seq_len)

        return serve_prefill, (params, specs), {"params": params, "batch": specs}

    def serve_decode(params, token, cache, cur_len):
        with torch.inference_mode():
            return model.decode_step(params, token, cache, cur_len)

    return (serve_decode, (params, specs["token"], specs["cache"], specs["cur_len"]),
            {"params": params, "cache": specs["cache"], "batch": [specs["token"]]})


def run_cell(arch: str, shape_name: str, out_path: str | None = None,
             memory_only: bool = False, accum: int | None = None, remat: bool = True):
    ok, reason = shape_applicable(arch, shape_name)
    rec = {"arch": arch, "shape": shape_name, "mesh": MESH, "variant": "baseline"}
    if not ok:
        rec.update(status="skip", reason=reason)
        print(json.dumps(rec))
        _append(out_path, rec)
        return rec

    try:
        cfg = get_config(arch)
        shape = SHAPES[shape_name]
        model = build_model(cfg)
        n_params = count_params(model.defs)
        # train shapes microbatch (grad accumulation x2), as the reference's
        if accum is None:
            accum = 2 if shape.kind == "train" else 1
        step, args, inputs = cell_step(model, shape, accum, remat)
        state = {name: hlo_analysis.storage_bytes(hlo_analysis.tree_tensors(x), block=1)
                 for name, x in inputs.items()}
        terms, extra = hlo_analysis.analyze_traced(step, *args)
        del step, args, inputs
        ma, peak = extra["memory_analysis"], extra["peak_size"]
        rec.update(
            status="ok", n_devices=1, n_params=n_params,
            active_params=active_params(cfg, n_params), accum=accum,
            trace_s=round(extra["trace_s"], 2), memory_analysis=ma, argument_bytes=state,
            peak_size=peak,
            hbm_per_device_gb=round(
                (ma["argument_size"] + ma["output_size"] + ma["temp_size"]
                 - ma["alias_size"]) / 1e9, 3),
            fits_one_card=peak <= CARD_BYTES,
        )
        if not memory_only:
            analytic_bytes = hlo_analysis.analytic_hbm_bytes(cfg, shape, 1, tp=1)
            training = shape.kind == "train"
            tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode" else 1)
            mf = hlo_analysis.model_flops(active_params(cfg, n_params), tokens, training)
            rec.update(
                roofline=terms.as_dict(),
                analytic_hbm_bytes_per_device=analytic_bytes,
                analytic_memory_s=analytic_bytes / hlo_analysis.HBM_BW,
                model_flops_total=mf,
                model_flops_per_device=mf,
                useful_flops_ratio=mf / max(terms.flops_per_device, 1.0),
                aten_ops=extra["aten_ops"],
                kernels=extra["kernels"],
            )
    except Exception as e:  # noqa: BLE001 - record the failure, sweep continues
        rec.update(status="error", error=f"{type(e).__name__}: {e}",
                   traceback=traceback.format_exc()[-2000:])
    _finish(rec, out_path)
    return rec


def _finish(rec, out_path):
    print(json.dumps({k: rec.get(k) for k in
                      ("arch", "shape", "mesh", "status", "trace_s", "hbm_per_device_gb",
                       "fits_one_card", "error")}))
    _append(out_path, rec)


def _append(path: str | None, rec: dict) -> None:
    if not path:
        return
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "a") as f:
        f.write(json.dumps(rec) + "\n")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", choices=ARCH_IDS, required=True)
    ap.add_argument("--shape", choices=list(SHAPES), required=True)
    ap.add_argument("--memory-only", action="store_true",
                    help="record the memory only (no roofline, model FLOPs or kernels)")
    ap.add_argument("--accum", type=int, default=None,
                    help="override grad-accumulation microbatch count")
    ap.add_argument("--no-remat", action="store_true",
                    help="disable activation rematerialization (train shapes)")
    ap.add_argument("--out", default=None, help="append JSONL results here")
    args = ap.parse_args()
    rec = run_cell(args.arch, args.shape, args.out, memory_only=args.memory_only,
                   accum=args.accum, remat=not args.no_remat)
    return 0 if rec.get("status") in ("ok", "skip") else 1


if __name__ == "__main__":
    sys.exit(main())
