"""Run act 3 of the serve_pipeline example (a pinned 2-stage plan served
with measured feedback, its deadlines on the wall clock) many times, each
on a fresh session, and count the runs that lost a request.

    python3 scripts/act3_repeat.py [--runs 30] [--device cuda] [--src DIR]

`--src` names the `src` directory whose `repro_torch` is imported (by
default this checkout's), so two trees can be compared in one process
each.  Each run prints its served count, its drops by cause, its final
feedback scales and its calibrated latency tables (ms by batch size); the
last line says how many runs lost requests and in how many a stage's
batch 1 was priced above a larger batch.
"""

import argparse
import sys
import time
from pathlib import Path


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--runs", type=int, default=30)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--src", default=str(Path(__file__).resolve().parent.parent / "src"))
    args = ap.parse_args(argv)
    sys.path.insert(0, args.src)
    import torch

    from repro_torch.api import Session
    from repro_torch.data.requests import bursty_trace
    from repro_torch.examples import serve_pipeline as ex

    if args.device == "cpu":
        torch.set_num_threads(1)
    lost = slow_one = 0
    t0 = time.perf_counter()
    for i in range(args.runs):
        with Session.from_config(ex.base_config(feedback="measured", slo_scale=8.0),
                                 device=torch.device(args.device)) as session:
            session.profile()
            session.use_plan(ex.staged_plan(session))
            session.deploy(mode="real")
            stages = session.runtime.pipelines[0].stages
            tables = [{b: round(v * 1e3, 4) for b, v in sorted(s.latency_by_batch.items())}
                      for s in stages]
            # act 3's trace, as the example builds it with --quick
            e2e = sum(s.latency(1) for s in stages)
            unified = session.runtime.pipelines[0].unified_batch
            thr = min(len(s.vdevs) * unified / s.latency(unified) for s in stages)
            rate = thr * 0.5
            trace = bursty_trace(rate, 24 / rate, e2e * 6, "stablelm-3b", seed=11)
            handles = [session.submit(r) for r in trace]
            session.drain()
            served = sum(h.latency_s is not None for h in handles)
            drops = {k: v for k, v in session.telemetry.snapshot()["drops"].items() if v}
            scales = [round(s.lat_scale, 4) for s in stages]
        above = any(t[1] > min(t.values()) for t in tables)
        slow_one += above
        lost += served < len(trace)
        print(f"[act3] run {i}: served {served}/{len(trace)}, drops {drops}, "
              f"lat_scale {scales}, batch 1 above a larger batch {above}, tables {tables}",
              flush=True)
    print(f"[act3] {args.src}: {lost} of {args.runs} runs lost requests; batch 1 above a "
          f"larger batch in {slow_one}; {time.perf_counter() - t0:.1f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
