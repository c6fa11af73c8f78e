"""repro_torch.dataplane — the reservation-driven serving data plane.

  queues.py     per-model EDF queues, SLO-aware admission, drop policy (copy)
  batcher.py    adaptive batching = Algorithm 1, shared (copy)
  dispatcher.py overlapped execution on CUDA streams + feedback correction
  metrics.py    SLO attainment / goodput / utilization telemetry (copy)
  plane.py      the event loop, plan hot-swap with epoch GC, faults,
                serve_stream + plan->executor builders + calibration

The one-shot `serve_trace` helper is deprecated at this level, as in the
reference: end-to-end flows go through `repro_torch.api.Session`.  The
import keeps working through a PEP-562 shim (with a DeprecationWarning);
the bare helper is `repro_torch.dataplane.plane.serve_trace`.
"""

import warnings

from .batcher import AdaptiveBatcher, unloaded_latency_s  # noqa: F401
from .dispatcher import (  # noqa: F401
    CompletedBatch,
    FeedbackController,
    PoolDispatcher,
)
from .metrics import DispatchRecord, Telemetry  # noqa: F401
from .plane import (  # noqa: F401
    DataPlane,
    build_executors,
    calibrate_runtime,
)
from .queues import AdmissionPolicy, ModelQueue, QueueSet  # noqa: F401


def __getattr__(name: str):
    if name == "serve_trace":
        warnings.warn(
            "repro_torch.dataplane.serve_trace is deprecated; drive serving "
            "through repro_torch.api.Session (Session.run) — or import "
            "repro_torch.dataplane.plane.serve_trace when you really want the "
            "bare one-shot helper",
            DeprecationWarning,
            stacklevel=2,
        )
        from .plane import serve_trace

        # no caching on purpose: like the repro_torch.core.* shims, every
        # access warns, so tests can assert the deprecation deterministically
        return serve_trace
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted(set(globals()) | {"serve_trace"})
