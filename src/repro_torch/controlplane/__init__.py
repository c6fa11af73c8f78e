"""repro_torch.controlplane — the unified planning subsystem (paper sections 3, 5).

One facade, two cadences:

  planner.py    `Planner` — one `plan(profiles, tables, cluster, objective)`
                entry over every solver backend (literal MILP, template
                enumeration, NP and DART-r baselines); plans come out
                validated.
  milp.py       the literal Appendix-A.2 MILP (moved from repro.core.milp)
  templates.py  template enumeration + master ILP — the scalable production
                solver (moved from repro.core.enumerate)
  baselines.py  NP / DART-r planners (moved from repro.core.baselines)
  profiles.py   `ProfileStore` — latency tables from the analytic roofline or
                from measured calibration/feedback, so re-solves price stages
                at observed speed
  replan.py     `ReplanLoop`/`DriftMonitor` — online workload-drift detection
                driving periodic re-solves and live `DataPlane.swap_plan`;
                `ReplanPolicy` — the governance gate between them
                (cost/benefit pricing, cooldown, oscillation damper)

Copied from the reference package (device-free; only import paths
differ).  The reference's deprecation shims for the old deep import paths
(`repro.core.milp`, `repro.core.enumerate`, `repro.core.baselines`) are
not ported.
"""

from .baselines import plan_dart_r, plan_np  # noqa: F401
from .milp import solve_milp, solve_milp_multi  # noqa: F401
from .planner import BACKENDS, Objective, Planner  # noqa: F401
from .profiles import ProfileStore  # noqa: F401
from .replan import (  # noqa: F401
    DriftMonitor,
    PolicyConfig,
    ReplanConfig,
    ReplanDecision,
    ReplanEvent,
    ReplanLoop,
    ReplanPolicy,
    estimate_benefit_scalar,
    mix_distance,
)
from .templates import (  # noqa: F401
    PlanningResult,
    Template,
    TemplateCache,
    enumerate_templates,
    plan_cluster,
)
