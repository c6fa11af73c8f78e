"""Quickstart: plan a heterogeneous GPU cluster with PPipe and simulate it
(the port's counterpart of the reference's `examples/quickstart.py`).

    PYTHONPATH=src python -m repro_torch.examples.quickstart

The whole pipeline through the public facade (`repro_torch.api`): a
declarative `ServeConfig` -> `Session` lifecycle — profile (analytical
roofline + pre-partitioning) -> plan (MILP control plane -> pooled
pipelines) -> deploy (reservation-driven data plane, simulated) -> run ->
report — and the paper's headline comparison (PPipe vs the
No-Partitioning baseline) on a 16-GPU cluster (`CLUSTER`: the reference's
4 high-class + 12 low-class shape in the port's GPU classes), each
baseline just one more `session.solve(backend=...)`.  Simulated: no card
is needed.
"""

import argparse

from repro_torch.api import ClusterSpec, ModelSpec, ObsConfig, ServeConfig, Session
from repro_torch.data.requests import poisson_trace

CLUSTER = {"h100": 4, "l4": 12}


def main(argv=None):
    argparse.ArgumentParser(description=__doc__).parse_args(argv)
    # 1) declare the deployment: a 4 high-class + 12 low-class GPU cluster
    #    serving stablelm-3b, SLO = 5x fastest batch-1 latency (paper 7.1);
    #    obs.level="aggregate" adds rolling-window metrics to the report
    cfg = ServeConfig(
        cluster=ClusterSpec(counts=dict(CLUSTER)),
        models=(ModelSpec(arch="stablelm-3b", slo_scale=5.0, seq_len=256,
                          n_blocks=10),),
        obs=ObsConfig(level="aggregate", window_s=1.0),
    )

    with Session.from_config(cfg) as session:
        # 2) profile: analytic layer costs -> 10 pre-partitioned blocks
        store = session.profile()
        prof = store.profiles["stablelm-3b"]
        print(f"model=stablelm-3b  blocks={prof.n_blocks}  "
              f"SLO={prof.slo_s*1e3:.1f} ms")

        # 3) control plane: MILP -> pooled pipelines (+ the NP baseline via
        #    the same facade)
        plan = session.plan()
        print("\n== PPipe plan ==")
        print(plan.summary())

        np_plan = session.solve(backend="np")
        print(f"\nNP baseline throughput: {np_plan.throughput:.0f} rps "
              f"(PPipe: {plan.throughput:.0f} rps, "
              f"+{100*(plan.throughput/max(np_plan.throughput,1e-9)-1):.1f}%)")

        # 4) data plane: simulate Poisson arrivals at 90% of planned capacity
        session.deploy(mode="sim")
        trace = poisson_trace(plan.throughput * 0.9, 10.0, prof.slo_s,
                              "stablelm-3b")
        report = session.run(trace)
        tel = report.telemetry
        print(f"\nsimulated {len(trace)} requests @0.9 load: "
              f"attainment={report.attainment:.3f}  "
              f"utilization={ {k: round(v, 2) for k, v in report.utilization.items()} }  "
              f"probes/dispatch={tel.probes_per_dispatch:.1f}")

        # 5) observability: the per-window rollup behind the aggregates
        ts = report.timeseries()
        print(f"\nper-{ts['window_s']:.0f}s windows:")
        for i in range(ts["n_windows"]):
            att = ts["attainment"][i]
            print(f"  t={ts['t_s'][i]:4.0f}s  arrivals={ts['arrivals'][i]:4d}  "
                  f"goodput={ts['goodput_rps'][i]:7.1f} rps  "
                  f"attainment={'-' if att is None else f'{att:.3f}'}")


if __name__ == "__main__":
    main()
