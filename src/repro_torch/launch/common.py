"""Setup helpers of the serving launcher, copied from the reference's
`benchmarks/common.py`: the DNN-stand-in profiles (assigned LM archs at
serving sequence lengths in place of the paper's 18 CNNs), priced through
the public facade (`repro_torch.api.build_profile_store`) exactly as a
`Session` prices them, and the paper's max-load-factor search."""

from __future__ import annotations

import numpy as np

from repro_torch.api import ModelSpec, build_profile_store
from repro_torch.core.types import ClusterSpec

# Serving profile: one request = a seq_len-256 chunk of the model (vision-scale
# latency); SLO = 5x inference latency on the fastest class at batch 1
# (paper section 7.1, following AlpaServe).
SERVE_SEQ = 256


def model_spec(arch: str, slo_scale: float = 5.0, n_blocks: int = 10
               ) -> ModelSpec:
    """The benchmark-standard ModelSpec: SERVE_SEQ request chunks, paper SLO."""
    return ModelSpec(arch=arch, slo_scale=slo_scale, seq_len=SERVE_SEQ,
                     n_blocks=n_blocks)


def make_setup(arch_group: list[str], cluster: ClusterSpec, slo_scale=5.0,
               slo_margin=0.4, batch_sizes=(1, 2, 4, 8), vfracs=(1, 2, 4)):
    store = build_profile_store(
        cluster, [model_spec(a, slo_scale) for a in arch_group],
        vfracs=vfracs, batch_sizes=batch_sizes,
    )
    profiles = {a: store.profiles[a] for a in arch_group}
    tables = {a: store.analytic_table(a) for a in arch_group}
    return profiles, tables


def max_load_factor(attain_fn, lo=0.05, hi=1.0, step=0.05, target=0.99):
    """Paper metric: max load factor sustaining >= 99% SLO attainment."""
    best = 0.0
    for lf in np.arange(lo, hi + 1e-9, step):
        if attain_fn(float(lf)) >= target:
            best = float(lf)
        else:
            break
    return best
