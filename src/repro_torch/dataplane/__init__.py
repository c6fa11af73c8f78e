"""repro_torch.dataplane — the reservation-driven serving data plane.

  queues.py     per-model EDF queues, SLO-aware admission, drop policy (copy)
  batcher.py    adaptive batching = Algorithm 1, shared (copy)
  dispatcher.py overlapped execution on CUDA streams + feedback correction
  metrics.py    SLO attainment / goodput / utilization telemetry (copy)
  plane.py      the event loop, plan hot-swap with epoch GC, faults,
                serve_stream + plan->executor builders + calibration
"""

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
    serve_trace,
)
from .queues import AdmissionPolicy, ModelQueue, QueueSet  # noqa: F401
