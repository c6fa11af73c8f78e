"""Deprecated shim: the literal MILP moved to `repro_torch.controlplane.milp`.

`from repro_torch.core.milp import solve_milp` keeps working (with a
DeprecationWarning on attribute access); new code should import from
`repro_torch.controlplane` — the `Planner` facade is the supported entry point.
"""

from __future__ import annotations

import warnings

from repro_torch.controlplane import milp as _impl

_MSG = ("repro_torch.core.milp has moved to repro_torch.controlplane.milp; "
        "use repro_torch.controlplane.Planner(backend='milp') or import from "
        "repro_torch.controlplane")


def __getattr__(name: str):
    if name.startswith("__"):
        raise AttributeError(name)
    value = getattr(_impl, name)
    warnings.warn(_MSG, DeprecationWarning, stacklevel=2)
    return value


def __dir__():
    return dir(_impl)
