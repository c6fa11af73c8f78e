"""repro_torch.stream — unbounded, seed-deterministic arrival sources.

`Source` subclasses generate open-loop arrival processes lazily;
`Session.serve(source)` pulls them incrementally through the data plane
under backpressure-aware admission.  `SourceConfig` is the declarative
form carried on `ServeConfig.stream`.
"""

from .config import SOURCE_KINDS, SourceConfig
from .sources import (
    DiurnalSource,
    FlashCrowdSource,
    MultiCameraSource,
    PoissonSource,
    Source,
    TraceSource,
    build_source,
)

__all__ = [
    "SOURCE_KINDS",
    "SourceConfig",
    "Source",
    "TraceSource",
    "PoissonSource",
    "DiurnalSource",
    "FlashCrowdSource",
    "MultiCameraSource",
    "build_source",
]
