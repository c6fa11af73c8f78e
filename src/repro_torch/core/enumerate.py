"""Deprecated shim: the template planner moved to `repro_torch.controlplane.templates`.

`from repro_torch.core.enumerate import plan_cluster` keeps working (with a
DeprecationWarning on attribute access); new code should import from
`repro_torch.controlplane` — the `Planner` facade is the supported entry point.
"""

from __future__ import annotations

import warnings

from repro_torch.controlplane import templates as _impl

_MSG = ("repro_torch.core.enumerate has moved to repro_torch.controlplane.templates; "
        "use repro_torch.controlplane.Planner(backend='enumerate') or import from "
        "repro_torch.controlplane")


def __getattr__(name: str):
    if name.startswith("__"):
        raise AttributeError(name)
    value = getattr(_impl, name)
    warnings.warn(_MSG, DeprecationWarning, stacklevel=2)
    return value


def __dir__():
    return dir(_impl)
