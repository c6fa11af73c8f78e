"""Deprecated shim: baseline planners moved to `repro_torch.controlplane.baselines`.

`from repro_torch.core.baselines import plan_np, plan_dart_r` keeps working (with a
DeprecationWarning on attribute access); new code should import from
`repro_torch.controlplane` — the `Planner` facade is the supported entry point.
"""

from __future__ import annotations

import warnings

from repro_torch.controlplane import baselines as _impl

_MSG = ("repro_torch.core.baselines has moved to repro_torch.controlplane.baselines; "
        "use repro_torch.controlplane.Planner(backend='np'|'dart-r') or import "
        "from repro_torch.controlplane")


def __getattr__(name: str):
    if name.startswith("__"):
        raise AttributeError(name)
    value = getattr(_impl, name)
    warnings.warn(_MSG, DeprecationWarning, stacklevel=2)
    return value


def __dir__():
    return dir(_impl)
