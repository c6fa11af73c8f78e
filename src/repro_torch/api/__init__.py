"""repro_torch.api — the public serving facade (DESIGN.md section 9).

The single supported way to run PPipe end to end:

    from repro_torch.api import ClusterSpec, ModelSpec, ServeConfig, Session

    cfg = ServeConfig(cluster=ClusterSpec(counts={"h100": 1, "l4": 8}),
                      models=(ModelSpec(arch="stablelm-3b"),))
    with Session.from_config(cfg) as s:  # device="cpu" for real mode off the card
        s.profile()                  # analytic/measured latency tables
        plan = s.plan()              # Planner facade -> validated ClusterPlan
        s.deploy(mode="sim")         # or "real": executors + dispatcher
        report = s.run(trace)        # or submit()/drain() with RequestHandles
        s.swap(new_plan)             # warmed live plan swap
        s.enable_replanning()        # managed drift-driven re-solves

`ModelSpec`/`ServeConfig` are declarative, validated, and dict-round-trip
serializable; `Session` owns the lifecycle and auto-wires the dispatcher /
runtime-setup closures that hand-written integrations used to rebuild at
every call site.  Config building blocks from deeper layers (`ClusterSpec`,
`Objective`, `ReplanConfig`, `PolicyConfig`, `AdmissionPolicy`) are
re-exported so scenario scripts need exactly one import.

tests/test_torch_api.py snapshots `__all__` and the lifecycle signatures
(the reference's, plus the session's `device`) — widen this surface
deliberately, never by accident.
"""

from repro_torch.controlplane.planner import Objective  # noqa: F401
from repro_torch.controlplane.replan import PolicyConfig, ReplanConfig  # noqa: F401
from repro_torch.core.types import ClusterSpec  # noqa: F401
from repro_torch.dataplane.queues import AdmissionPolicy  # noqa: F401
from repro_torch.faults import FaultConfig, FaultEvent, FaultSchedule  # noqa: F401
from repro_torch.obs import ObsConfig  # noqa: F401
from repro_torch.stream import SourceConfig  # noqa: F401

from .config import ConfigError, ModelSpec, ServeConfig  # noqa: F401
from .session import (  # noqa: F401
    LifecycleError,
    Report,
    RequestHandle,
    Session,
    SwapRecord,
    build_profile_store,
    profile_model,
)

__all__ = [
    # facade
    "Session",
    "RequestHandle",
    "Report",
    "SwapRecord",
    # declarative config
    "ModelSpec",
    "ServeConfig",
    "ConfigError",
    "LifecycleError",
    # profiling helpers
    "profile_model",
    "build_profile_store",
    # re-exported config building blocks
    "ClusterSpec",
    "Objective",
    "ReplanConfig",
    "PolicyConfig",
    "AdmissionPolicy",
    "ObsConfig",
    "SourceConfig",
    # fault injection / elastic clusters (repro_torch.faults)
    "FaultConfig",
    "FaultEvent",
    "FaultSchedule",
]
