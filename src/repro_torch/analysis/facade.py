"""FAC rules: clients go through the facade; moved modules keep shims.

* FAC001 — an example (`src/repro_torch/examples/`) imports an internal
  subsystem (`allowlists.FACADE_FORBIDDEN_ROOTS`: dataplane, controlplane,
  obs, serving, faults, launch) instead of the `repro_torch.api` /
  `repro_torch.core` surface.  The facade is the seam every scenario plugs
  into (ROADMAP); deep imports fossilize internals and dodge the
  snapshot-tested surface.
* FAC002 — an example imports a private module or name (any
  underscore-leading dotted component), outside
  `allowlists.FACADE_DEEP_ALLOWED`.
* FAC003 — a moved module's deprecation shim regressed: each entry of
  `allowlists.MOVED_MODULES` (old path -> new home) must still exist,
  import its new home, and forward — via a module-level ``__getattr__``
  or an explicit re-export — so old import paths keep working one
  deprecation cycle.
"""

from __future__ import annotations

import ast

from . import allowlists
from .engine import Project, Violation


def _imported_modules(tree: ast.Module):
    """Yield (node, dotted module, [imported names]) for every import."""
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield node, a.name, []
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node, node.module, [a.name for a in node.names]


def _check_client(ctx, out: list[Violation]) -> None:
    for node, module, names in _imported_modules(ctx.tree):
        if not (module == "repro_torch" or module.startswith("repro_torch.")):
            continue
        if (ctx.rel, module) in allowlists.FACADE_DEEP_ALLOWED:
            continue
        for root in allowlists.FACADE_FORBIDDEN_ROOTS:
            if module == root or module.startswith(root + "."):
                out.append(Violation(
                    "FAC001", ctx.rel, node.lineno,
                    f"deep import of `{module}` bypasses the facade — "
                    "import via repro_torch.api / repro_torch.core (re-export there "
                    "if the name is missing)",
                    f"{module}"))
                break
        else:
            private_part = next(
                (p for p in module.split(".") if p.startswith("_")), None)
            if private_part is not None:
                out.append(Violation(
                    "FAC002", ctx.rel, node.lineno,
                    f"import of private module `{module}` from a facade "
                    "client",
                    f"{module}"))
            else:
                for n in names:
                    if n.startswith("_") and n != "_" and \
                            (ctx.rel, f"{module}.{n}") not in \
                            allowlists.FACADE_DEEP_ALLOWED:
                        out.append(Violation(
                            "FAC002", ctx.rel, node.lineno,
                            f"import of private name `{n}` from "
                            f"`{module}` in a facade client",
                            f"{module}.{n}"))


def _check_shims(project: Project, out: list[Violation]) -> None:
    for old_rel, new_home in allowlists.MOVED_MODULES.items():
        # the shim obligation exists only where the new home does (scratch
        # trees staged by tests don't owe shims for modules they lack)
        home_rel = "src/" + new_home.replace(".", "/")
        if home_rel + ".py" not in project.by_rel and \
                home_rel + "/__init__.py" not in project.by_rel:
            continue
        ctx = project.by_rel.get(old_rel)
        if ctx is None:
            out.append(Violation(
                "FAC003", old_rel, 1,
                f"moved module lost its deprecation shim: {old_rel} must "
                f"keep forwarding to {new_home}",
                f"{new_home}:missing"))
            continue
        imports_new = any(
            module == new_home or module.startswith(new_home + ".")
            or new_home.startswith(module + ".")
            for _n, module, _names in _imported_modules(ctx.tree))
        # `from repro_torch.controlplane import milp` imports the *package*;
        # accept parent-package imports that bind the new module too
        if not imports_new:
            parent, _, leaf = new_home.rpartition(".")
            imports_new = any(
                module == parent and leaf in names
                for _n, module, names in _imported_modules(ctx.tree))
        has_getattr = any(
            isinstance(n, ast.FunctionDef) and n.name == "__getattr__"
            for n in ctx.tree.body)
        has_reexport = any(
            isinstance(n, ast.ImportFrom) and n.module
            and (n.module == new_home
                 or n.module.startswith(new_home + "."))
            for n in ctx.tree.body)
        if not imports_new or not (has_getattr or has_reexport):
            out.append(Violation(
                "FAC003", old_rel, 1,
                f"deprecation shim {old_rel} no longer forwards to "
                f"{new_home} (needs an import of the new home plus a "
                "module __getattr__ or explicit re-export)",
                f"{new_home}:broken"))


def run(project: Project) -> list[Violation]:
    out: list[Violation] = []
    for ctx in project.files:
        if ctx.facade_client:
            _check_client(ctx, out)
    _check_shims(project, out)
    return out
