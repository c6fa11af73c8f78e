"""Deterministic synthetic token pipeline for training.

Step-indexed and host-sharded: batch_for(step, host, n_hosts) is a pure
function, so elastic restarts resume the exact data order with no loss or
duplication (see training/elastic.py), and each host materializes only its
shard — the pattern a real distributed loader must satisfy.

The stream is a mixture of Zipf-distributed unigrams with shifting n-gram
structure so the loss actually decreases during the train_small example.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class TokenPipeline:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0

    def batch_for(self, step: int, host: int = 0, n_hosts: int = 1) -> dict:
        if self.global_batch % n_hosts:
            raise ValueError("global_batch must divide n_hosts")
        per_host = self.global_batch // n_hosts
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, step, host])
        )
        # Zipf unigrams, clipped to vocab
        toks = rng.zipf(1.3, size=(per_host, self.seq_len + 1)).astype(np.int64)
        toks = (toks - 1) % self.vocab
        # inject learnable bigram structure: every even position repeats
        # f(prev) = (prev * 31 + 7) % vocab with prob .5
        prev = toks[:, :-1]
        det = (prev * 31 + 7) % self.vocab
        mask = rng.random(prev.shape) < 0.5
        toks[:, 1:] = np.where(mask, det, toks[:, 1:])
        return {"tokens": toks[:, : self.seq_len].astype(np.int32)}
