"""Inference request trace generators (paper section 7.1, "Workloads").

The paper replays Microsoft Azure Functions traces: MAF-2019 (per-minute
counts -> Poisson arrivals, the "Poisson" workload) and MAF-2021 (per-request
timestamps, markedly burstier -> the "Bursty" workload).  Those traces are not
redistributable offline, so we generate statistically matching stand-ins:

* `poisson_trace`   — homogeneous Poisson arrivals at rate lambda.
* `bursty_trace`    — a Markov-modulated Poisson process (two-state on/off
  burst envelope with heavy-tailed burst intensities), the standard generative
  model for serverless-invocation burstiness.

All generators are deterministic per seed.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from repro_torch.core.types import Request


@dataclass(frozen=True)
class TraceStats:
    """Shape summary of an arrival trace (reported by the serving example and
    BENCH_e2e.json so Poisson vs bursty runs are self-describing)."""

    n: int
    horizon_s: float
    mean_rps: float
    peak_rps: float  # max arrival rate over a sliding window
    cv_interarrival: float  # coefficient of variation; ~1 Poisson, >1 bursty
    slo_s: float  # mean request SLO

    def as_dict(self) -> dict:
        return {
            "n": self.n,
            "horizon_s": self.horizon_s,
            "mean_rps": self.mean_rps,
            "peak_rps": self.peak_rps,
            "cv_interarrival": self.cv_interarrival,
            "slo_s": self.slo_s,
        }


def describe(trace: list[Request], window_frac: float = 0.02) -> TraceStats:
    """Empirical rate/burstiness statistics of a trace."""
    if not trace:
        return TraceStats(0, 0.0, 0.0, 0.0, 0.0, 0.0)
    times = np.sort(np.array([r.arrival_s for r in trace]))
    horizon = max(float(times[-1]), 1e-9)
    window = max(horizon * window_frac, 1e-9)
    # peak rate: most arrivals inside any window of `window` seconds
    peak = 1
    j = 0
    for i in range(len(times)):
        while times[i] - times[j] > window:
            j += 1
        peak = max(peak, i - j + 1)
    gaps = np.diff(times)
    cv = float(np.std(gaps) / np.mean(gaps)) if len(gaps) > 1 and np.mean(gaps) > 0 else 0.0
    return TraceStats(
        n=len(trace),
        horizon_s=horizon,
        mean_rps=len(trace) / horizon,
        peak_rps=peak / window,
        cv_interarrival=cv,
        slo_s=float(np.mean([r.slo_s for r in trace])),
    )


def poisson_trace(
    rate_rps: float,
    horizon_s: float,
    slo_s: float,
    model_name: str = "model",
    seed: int = 0,
    start_id: int = 0,
) -> list[Request]:
    rng = np.random.default_rng(seed)
    n_expect = max(1, int(rate_rps * horizon_s * 1.2 + 10))
    gaps = rng.exponential(1.0 / max(rate_rps, 1e-9), size=n_expect)
    times = np.cumsum(gaps)
    times = times[times < horizon_s]
    return [
        Request(
            arrival_s=float(t),
            req_id=start_id + i,
            model_name=model_name,
            deadline_s=float(t) + slo_s,
        )
        for i, t in enumerate(times)
    ]


def bursty_trace(
    rate_rps: float,
    horizon_s: float,
    slo_s: float,
    model_name: str = "model",
    seed: int = 0,
    start_id: int = 0,
    burst_rate_mult: float = 4.0,
    calm_rate_mult: float = 0.4,
    mean_burst_s: float = 0.5,
    mean_calm_s: float = 2.0,
) -> list[Request]:
    """Markov-modulated Poisson arrivals whose long-run average equals
    `rate_rps` (burst/calm multipliers are renormalized)."""
    rng = np.random.default_rng(seed)
    # renormalize so the time-averaged rate equals rate_rps
    frac_burst = mean_burst_s / (mean_burst_s + mean_calm_s)
    avg_mult = frac_burst * burst_rate_mult + (1 - frac_burst) * calm_rate_mult
    burst_rate = rate_rps * burst_rate_mult / avg_mult
    calm_rate = rate_rps * calm_rate_mult / avg_mult

    times: list[float] = []
    t = 0.0
    in_burst = False
    while t < horizon_s:
        dwell = rng.exponential(mean_burst_s if in_burst else mean_calm_s)
        rate = burst_rate if in_burst else calm_rate
        seg_end = min(t + dwell, horizon_s)
        cur = t
        while True:
            cur += rng.exponential(1.0 / max(rate, 1e-9))
            if cur >= seg_end:
                break
            times.append(cur)
        t = seg_end
        in_burst = not in_burst
    return [
        Request(
            arrival_s=float(tt),
            req_id=start_id + i,
            model_name=model_name,
            deadline_s=float(tt) + slo_s,
        )
        for i, tt in enumerate(times)
    ]


def multi_model_trace(
    rates: dict[str, float],
    horizon_s: float,
    slos: dict[str, float],
    bursty: bool = False,
    seed: int = 0,
) -> list[Request]:
    """Interleaved trace for serving several DNNs in parallel (paper 7.2)."""
    gen = bursty_trace if bursty else poisson_trace
    out: list[Request] = []
    for i, (name, rate) in enumerate(sorted(rates.items())):
        # fixed per-model id stride (NOT cumulative-count-based: that made
        # strides trace-size dependent and collide with callers' segment
        # offsets on paper-scale traces, silently aliasing outcomes that
        # are attributed by req_id)
        out.extend(
            gen(rate, horizon_s, slos[name], model_name=name, seed=seed + 1000 * i,
                start_id=i * 1_000_000_000)
        )
    return sorted(out)


def load_sweep(start: float = 0.05, stop: float = 1.0, step: float = 0.05) -> list[float]:
    """Paper section 7.1: lambda from 0.05 to 1.0 x load factor, step 0.05."""
    n = int(round((stop - start) / step)) + 1
    return [round(start + i * step, 4) for i in range(n)]
