"""Elastic training loop: checkpoint/restart, failure recovery, re-meshing
(the reference's `training/elastic.py`, the same loop).

At 1000+-node scale, node loss is routine.  The recovery contract here:

 1. every `ckpt_every` steps the loop writes an atomic checkpoint (torn
    writes are skipped on restore);
 2. on failure (simulated via `FailureInjector` in tests, real via process
    restart in deployment) the loop rebuilds its state with `make_state`
    (on whatever devices survive; `shrink_mesh` drops lost data-parallel
    rows of a device array) and restores the newest committed checkpoint
    into it, each leaf placed on its fresh counterpart's device;
 3. the data pipeline is step-indexed and deterministic, so resumed runs
    consume exactly the batches after the restored step (no data loss/dup).

Straggler mitigation at serving time is native to PPipe (probe() routes
around slow pool members); at training time the knobs here are checkpoint
cadence + re-meshing, plus the gradient-compression path in
distributed/collectives.py that shrinks the straggler-sensitive reduction.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import numpy as np

# the deterministic-schedule core lives in repro_torch.faults so serving and
# training share one injector; re-exported here for the training loop
from repro_torch.faults import FailureInjector  # noqa: F401

from . import checkpoint as ckpt_lib


@dataclass
class ElasticConfig:
    ckpt_dir: str
    ckpt_every: int = 20
    keep: int = 3
    max_restarts: int = 8


def run_elastic(
    make_state: Callable[[], object],  # () -> TrainState-like pytree
    train_step: Callable,  # (state, batch) -> (state, metrics)
    batch_for_step: Callable[[int], dict],  # deterministic step-indexed data
    n_steps: int,
    cfg: ElasticConfig,
    failure: FailureInjector | None = None,
) -> tuple[object, dict]:
    """Run n_steps with checkpoint/restart; returns (state, stats)."""
    failure = failure or FailureInjector()
    restarts = 0
    stats = {"restarts": 0, "resumed_from": [], "losses": []}

    state = make_state()
    start = 0
    latest = ckpt_lib.latest_step(cfg.ckpt_dir)
    if latest is not None:
        state, start = ckpt_lib.restore(cfg.ckpt_dir, state)
        stats["resumed_from"].append(start)

    step = start
    while step < n_steps:
        try:
            failure.check(step)
            state, metrics = train_step(state, batch_for_step(step))
            stats["losses"].append(float(metrics["loss"]))
            step += 1
            if step % cfg.ckpt_every == 0 or step == n_steps:
                ckpt_lib.save(cfg.ckpt_dir, step, state)
                ckpt_lib.prune(cfg.ckpt_dir, cfg.keep)
        except RuntimeError:
            restarts += 1
            stats["restarts"] = restarts
            if restarts > cfg.max_restarts:
                raise
            # recovery: rebuild state, restore newest committed checkpoint
            state = make_state()
            latest = ckpt_lib.latest_step(cfg.ckpt_dir)
            if latest is not None:
                state, step = ckpt_lib.restore(cfg.ckpt_dir, state)
            else:
                step = 0
            stats["resumed_from"].append(step)
    return state, stats


def shrink_mesh(devices: np.ndarray, lost: int, axis: int = 0) -> np.ndarray:
    """Drop `lost` rows from the DP axis of a device array (elastic shrink).

    Model-axis loss cannot shrink (weights are sharded there); the caller must
    re-plan onto fewer model replicas instead — mirrored by the control plane
    re-running MILP on the updated inventory (paper section 5.1 migration)."""
    if lost == 0:
        return devices
    keep = devices.shape[axis] - lost
    if keep < 1:
        raise ValueError("cannot lose every DP replica")
    sl = [slice(None)] * devices.ndim
    sl[axis] = slice(0, keep)
    return devices[tuple(sl)]
