"""repro_torch.obs — observability for the serving stack (DESIGN.md section 10).

Span tracing (per-request causally-linked span trees, Perfetto export),
rolling-window metrics (attainment/goodput/queue depth/utilization per
fixed virtual-time window) and the structured decision journal (drift ->
replan -> swap, drop causes, per-batch execution) behind one `Observer`
facade, configured by the declarative `ObsConfig` (``ServeConfig.obs``).

Off by default: with ``level="off"`` no Observer exists and the data plane's
hooks are skipped behind ``is not None`` checks — decision-identical to the
pre-observability plane (tests/test_obs.py proves it bit-for-bit).
"""

from .config import ObsConfig  # noqa: F401
from .journal import DecisionJournal  # noqa: F401
from .observer import Observer  # noqa: F401
from .schema import SCHEMA, EventSchema  # noqa: F401
from .spans import perfetto_trace, request_trees  # noqa: F401
from .windows import WindowedMetrics  # noqa: F401

__all__ = [
    "ObsConfig",
    "Observer",
    "DecisionJournal",
    "WindowedMetrics",
    "EventSchema",
    "SCHEMA",
    "perfetto_trace",
    "request_trees",
]
