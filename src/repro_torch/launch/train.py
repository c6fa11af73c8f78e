"""Training launcher: the full training stack on one device.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-1.5b \
        --steps 200 --reduce 4 --ckpt-dir CKPT [--fail-at 90] [--device cuda]

The reference's `repro.launch.train`, same flags, defaults and output lines,
plus `--device` (CUDA unless the caller names another; `--device cpu` runs
the kernels' plain versions).  Builds the model (reduced by --reduce; 0 =
the full config), and runs the elastic loop — deterministic step-indexed
data, atomic checkpoints, restart-on-failure — over the port's train step
(AdamW, remat, `--accum` micro-batches), compiled as the reference jits it
(`compile_train_step`: on the card a CUDA graph replayed every step, on the
CPU the step run eagerly).  The checkpoints go to
`--ckpt-dir`, by default `repro_torch_train_ckpt` under the temporary
directory; a run finding a committed checkpoint there resumes from it.
"""

from __future__ import annotations

import argparse
import os
import tempfile
import time

import torch

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.data.tokens import TokenPipeline
from repro_torch.models.common import count_params
from repro_torch.models.model_zoo import build_model
from repro_torch.training import (AdamWConfig, compile_train_step, init_opt_state,
                                  make_train_step)
from repro_torch.training.elastic import ElasticConfig, FailureInjector, run_elastic


def device_count(device: torch.device) -> int:
    return torch.cuda.device_count() if device.type == "cuda" else 1


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", choices=ARCH_IDS, default="qwen2-1.5b")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--reduce", type=int, default=4,
                    help="width divisor for small runs (0 = full config)")
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(),
                                                       "repro_torch_train_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--fail-at", type=int, default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device (cuda: the Hopper kernels; cpu: their plain versions)")
    args = ap.parse_args()
    device = torch.device(args.device)

    cfg = get_config(args.arch)
    if args.reduce:
        d = max(128, cfg.d_model // args.reduce // 64 * 64)
        cfg = cfg.reduced(
            n_layers=max(2, cfg.n_layers // args.reduce),
            d_model=d, d_ff=(2 * d if cfg.d_ff else 0), vocab=8192,
            n_heads=4, kv_heads=min(cfg.kv_heads, 4), head_dim=d // 4,
        )
    model = build_model(cfg)
    print(f"arch={args.arch} params={count_params(model.defs)/1e6:.1f}M "
          f"devices={device_count(device)}")

    opt_cfg = AdamWConfig(lr=args.lr)
    step_fn = compile_train_step(
        make_train_step(model, opt_cfg, remat=True, accum_steps=args.accum))
    pipe = TokenPipeline(vocab=cfg.vocab, seq_len=args.seq_len,
                         global_batch=args.global_batch, seed=args.seed)

    def make_state():
        params = model.init(torch.Generator(device=device).manual_seed(args.seed))
        return {"params": params, "opt": init_opt_state(params, opt_cfg)}

    def train_step(state, batch):
        params, opt, metrics = step_fn(state["params"], state["opt"], batch)
        return {"params": params, "opt": opt}, metrics

    def batch_for(step):
        return {k: torch.as_tensor(v, device=device) for k, v in pipe.batch_for(step).items()}

    fail = FailureInjector({args.fail_at} if args.fail_at else set())
    t0 = time.perf_counter()
    state, stats = run_elastic(
        make_state, train_step, batch_for,
        args.steps, ElasticConfig(ckpt_dir=args.ckpt_dir,
                                  ckpt_every=args.ckpt_every), fail,
    )
    wall = time.perf_counter() - t0
    losses = stats["losses"]
    k = max(1, len(losses) // 10)
    tok_s = args.steps * args.global_batch * args.seq_len / wall
    print(f"done: steps={args.steps} wall={wall:.1f}s ({tok_s:.0f} tok/s) "
          f"restarts={stats['restarts']}")
    print(f"loss first/last-{k}: {sum(losses[:k])/k:.3f} -> {sum(losses[-k:])/k:.3f}")


if __name__ == "__main__":
    main()
