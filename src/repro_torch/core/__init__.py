"""PPipe core, copied from the reference package: plan/runtime value types
+ reservation-based data plane.

The execution-side primitives live here: pre-partitioning (blocks), the
analytical profiler (costmodel), the plan dataclasses (plan), runtime
instantiation (runtime), and the data plane — reservation tables +
probe/reserve (reservation), adaptive batching schedulers (scheduler), and
the discrete-event simulator (simulator).  `_reference` is the frozen
pre-optimization scheduler that `DataPlane(scheduler_cls=...)` accepts.

Planning itself lives in `repro_torch.controlplane` (Planner facade over the
literal MILP, template enumeration, and the NP/DART-r baselines); the full
planner surface (`plan_cluster`, `solve_milp`, `plan_np`, `plan_dart_r`,
`PlanningResult`) is re-exported here lazily — lazily so that
`repro_torch.controlplane`, which builds on these core primitives, can be
imported first without a cycle.  `repro_torch.core.milp`, `.enumerate` and
`.baselines` are deprecation shims, as in the reference.
"""

import importlib

from . import blocks, costmodel, plan, reservation, runtime, scheduler, simulator, types  # noqa: F401
from .plan import ClusterPlan, PipelinePlan, StagePlan  # noqa: F401
from .types import (  # noqa: F401
    ACCEL_CLASSES,
    TPU_HI,
    TPU_LO,
    AcceleratorClass,
    ClusterSpec,
    ModelProfile,
    Request,
)

# name -> (module, attr); attr None re-exports the module itself (the
# deprecation shims for repro_torch.core.milp / .enumerate / .baselines)
_LAZY = {
    "plan_cluster": ("repro_torch.controlplane.templates", "plan_cluster"),
    "PlanningResult": ("repro_torch.controlplane.templates", "PlanningResult"),
    "solve_milp": ("repro_torch.controlplane.milp", "solve_milp"),
    "solve_milp_multi": ("repro_torch.controlplane.milp", "solve_milp_multi"),
    "plan_np": ("repro_torch.controlplane.baselines", "plan_np"),
    "plan_dart_r": ("repro_torch.controlplane.baselines", "plan_dart_r"),
    "Planner": ("repro_torch.controlplane.planner", "Planner"),
    "Objective": ("repro_torch.controlplane.planner", "Objective"),
    "baselines": ("repro_torch.core.baselines", None),
    "enumerate": ("repro_torch.core.enumerate", None),
    "milp": ("repro_torch.core.milp", None),
}


def __getattr__(name: str):
    spec = _LAZY.get(name)
    if spec is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    module = importlib.import_module(spec[0])
    value = module if spec[1] is None else getattr(module, spec[1])
    globals()[name] = value  # cache: __getattr__ runs once per name
    return value


def __dir__():
    return sorted(set(globals()) | set(_LAZY))
