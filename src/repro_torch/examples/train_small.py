"""Train a ~40M-parameter qwen2-family model for a few hundred steps with
the full training stack: deterministic data pipeline, AdamW + remat +
grad accumulation, atomic checkpoints, and elastic restart — the port's
counterpart of the reference's `examples/train_small.py`.

    PYTHONPATH=src python -m repro_torch.examples.train_small [--steps 300] [--fail-at 120]

On the card by default, where the step is captured once as a CUDA graph
and replayed (`compile_train_step`, as the reference jits it); `--device
cpu` runs the step eagerly through the kernels' plain versions.
`run` is the example as a function: it returns the per-step losses and the
run's statistics, for callers that compare runs.
"""

import argparse
import tempfile
import time

import torch

from repro_torch.configs import get_config
from repro_torch.data.tokens import TokenPipeline
from repro_torch.models.common import count_params
from repro_torch.models.model_zoo import build_model
from repro_torch.training import (AdamWConfig, compile_train_step, init_opt_state,
                                  make_train_step)
from repro_torch.training.elastic import ElasticConfig, FailureInjector, run_elastic

# a step: BATCH sequences of SEQ tokens in ACCUM micro-batches
SEQ, BATCH, ACCUM = 128, 8, 2


def small_config(dim: int = 512, layers: int = 8):
    """The example's reduced qwen2-1.5b: `layers` layers of width `dim`,
    8 heads over 2 KV heads, vocab 8192."""
    return get_config("qwen2-1.5b").reduced(
        n_layers=layers, d_model=dim, d_ff=dim * 4,
        n_heads=8, kv_heads=2, vocab=8192, head_dim=dim // 8,
    )


def run(steps: int, fail_at: int | None, ckpt_dir: str, device: torch.device,
        dim: int = 512, layers: int = 8, ckpt_every: int = 50) -> tuple[list[float], dict, float]:
    """(losses, elastic stats, wall seconds) of one run of the example."""
    cfg = small_config(dim, layers)
    model = build_model(cfg)
    opt_cfg = AdamWConfig(lr=1e-3)
    step_fn = compile_train_step(make_train_step(model, opt_cfg, remat=True,
                                                 accum_steps=ACCUM))
    pipe = TokenPipeline(vocab=cfg.vocab, seq_len=SEQ, global_batch=BATCH)

    def make_state():
        params = model.init(torch.Generator(device=device).manual_seed(0))
        return {"params": params, "opt": init_opt_state(params, opt_cfg)}

    def train_step(state, batch):
        params, opt, metrics = step_fn(state["params"], state["opt"], batch)
        return {"params": params, "opt": opt}, metrics

    def batch_for(step):
        return {k: torch.as_tensor(v, device=device) for k, v in pipe.batch_for(step).items()}

    fail = FailureInjector({fail_at} if fail_at else set())
    cfg_e = ElasticConfig(ckpt_dir=ckpt_dir, ckpt_every=ckpt_every)
    t0 = time.perf_counter()
    _, stats = run_elastic(make_state, train_step, batch_for, steps, cfg_e, fail)
    return stats["losses"], stats, time.perf_counter() - t0


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--fail-at", type=int, default=None,
                    help="inject a node failure at this step (tests recovery)")
    ap.add_argument("--dim", type=int, default=512)
    ap.add_argument("--layers", type=int, default=8)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    cfg = small_config(args.dim, args.layers)
    n_params = count_params(build_model(cfg).defs)
    print(f"model: {cfg.name}-reduced  params={n_params/1e6:.1f}M")
    ckpt_dir = tempfile.mkdtemp(prefix="train_small_")
    losses, stats, wall = run(args.steps, args.fail_at, ckpt_dir, torch.device(args.device),
                              args.dim, args.layers)
    k = max(1, len(losses) // 10)
    print(f"steps={args.steps} wall={wall:.1f}s restarts={stats['restarts']} "
          f"ckpt={ckpt_dir}")
    print(f"loss: first10={sum(losses[:k])/k:.3f} "
          f"last10={sum(losses[-k:])/k:.3f}")
    assert sum(losses[-k:]) / k < sum(losses[:k]) / k, "loss did not decrease"
    print("OK — loss decreased")


if __name__ == "__main__":
    main()
