"""Serving launcher: PPipe control plane + data plane for one or more models.

    PYTHONPATH=src python -m repro_torch.launch.serve --archs stablelm-3b qwen3-14b \
        --hi 4 --lo 12 --load 0.8 [--bursty] [--reactive]

Plans pooled pipelines with the MILP control plane on a heterogeneous
inventory, then drives the reservation data plane against a Poisson/bursty
trace and reports the paper's metrics (SLO attainment, per-class utilization,
probe overhead).  `--sweep` reproduces the max-load-factor search.
Simulated, as the reference's launcher is: nothing runs on a device.
`--archs` takes the port's registry, the reference's ten architectures.
"""

from __future__ import annotations

import argparse

from repro_torch.configs import ARCH_IDS
from repro_torch.core import plan_cluster, plan_dart_r, plan_np
from repro_torch.core.runtime import build_runtime
from repro_torch.core.simulator import run_simulation
from repro_torch.core.types import ClusterSpec
from repro_torch.data.requests import multi_model_trace
from repro_torch.launch.common import make_setup, max_load_factor


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--archs", nargs="+", choices=ARCH_IDS,
                    default=["stablelm-3b"])
    ap.add_argument("--hi", type=int, default=4, help="high-class chips")
    ap.add_argument("--lo", type=int, default=12, help="low-class chips")
    ap.add_argument("--slo-scale", type=float, default=5.0)
    ap.add_argument("--load", type=float, default=0.8, help="load factor")
    ap.add_argument("--horizon", type=float, default=10.0)
    ap.add_argument("--bursty", action="store_true")
    ap.add_argument("--reactive", action="store_true",
                    help="use the reactive (ablation) scheduler")
    ap.add_argument("--planner", choices=["ppipe", "np", "dart"], default="ppipe")
    ap.add_argument("--sweep", action="store_true",
                    help="search the max load factor at 99% attainment")
    args = ap.parse_args()

    cluster = ClusterSpec(counts={"tpu-hi": args.hi, "tpu-lo": args.lo})
    profiles, tables = make_setup(args.archs, cluster, slo_scale=args.slo_scale)
    planner = {
        "ppipe": plan_cluster,
        "np": plan_np,
        "dart": plan_dart_r,
    }[args.planner]
    res = planner(profiles, tables, cluster)
    print(res.plan.summary())

    rates = {a: max(res.plan.throughput_of(a), 1e-9) for a in args.archs}
    slos = {a: profiles[a].slo_s for a in args.archs}

    def attain(lf: float) -> float:
        trace = multi_model_trace({a: r * lf for a, r in rates.items()},
                                  args.horizon, slos, bursty=args.bursty)
        sim = run_simulation(build_runtime(res.plan, profiles), trace,
                             reactive=args.reactive)
        attain._last = sim  # stash for reporting
        return sim.attainment

    if args.sweep:
        mlf = max_load_factor(attain)
        print(f"\nmax load factor @99% attainment: {mlf:.2f}")
        return

    a = attain(args.load)
    sim = attain._last
    print(f"\nload={args.load:.2f} ({args.planner}, "
          f"{'bursty' if args.bursty else 'poisson'}, "
          f"{'reactive' if args.reactive else 'reservation'} data plane)")
    print(f"  requests={len(sim.outcomes)}  attainment={a:.3f}")
    print(f"  utilization={ {k: round(v, 3) for k, v in sim.utilization.items()} }")
    print(f"  probes/dispatch={sim.probes_per_dispatch:.2f}")


if __name__ == "__main__":
    main()
