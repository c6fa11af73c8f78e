"""DET rules: decision paths must be seed-deterministic and run on the
virtual clock.

Applies to files under the decision packages (`engine.DECISION_PACKAGES`):
everything feeding scheduler, planner, dispatcher, or admission decisions.

* DET001 — wall-clock read (`time.time`/`perf_counter`/`monotonic`/
  `datetime.now`...) outside `allowlists.WALL_CLOCK_ALLOWED`.  Two runs of
  the same seed must produce bit-identical decision streams; a wall read
  on a decision path breaks that and the decision-identity proofs with it.
* DET002 — unseeded randomness: module-level `random.*` (global RNG),
  `random.Random()`/`np.random.default_rng()` with no seed, legacy
  `np.random.*` global-state calls, `uuid.uuid1/uuid4`, `secrets.*`.
* DET003 — `id()` on a decision path: CPython allocation addresses vary
  across processes, so `id()`-keyed containers (or identity probes) make
  iteration order and membership run-dependent.  Use a stable key
  (`node_id`, `req_id`...) instead.
* DET004 — ordering-sensitive iteration over a set: `for` loops and
  list/generator comprehensions whose iterable is statically set-typed,
  unless consumed by an order-insensitive reducer (sorted/min/max/sum/
  any/all/set/frozenset/len).  Set iteration order is hash-seed dependent
  for str keys; anything that flows into dispatch or solver input must be
  sorted first.
"""

from __future__ import annotations

import ast

from . import allowlists
from .engine import Project, Violation, dotted_call_name, import_maps, \
    scope_of

WALL_CLOCK = {
    "time.time", "time.time_ns", "time.perf_counter",
    "time.perf_counter_ns", "time.monotonic", "time.monotonic_ns",
    "time.process_time", "time.process_time_ns",
    "datetime.datetime.now", "datetime.datetime.utcnow",
    "datetime.datetime.today", "datetime.date.today",
}

# numpy.random callables that are fine when *seeded* (checked separately)
_NP_SEEDED_OK = {
    "numpy.random.default_rng", "numpy.random.Generator",
    "numpy.random.SeedSequence", "numpy.random.PCG64",
    "numpy.random.Philox", "numpy.random.BitGenerator",
}

ORDER_FREE_REDUCERS = {"sorted", "set", "frozenset", "sum", "min", "max",
                       "any", "all", "len"}

SET_OPS = (ast.BitOr, ast.BitAnd, ast.Sub, ast.BitXor)
SET_METHODS = {"union", "intersection", "difference",
               "symmetric_difference", "copy"}


def _allowed_wall(rel: str, scope: str) -> bool:
    for (path, s), _reason in allowlists.WALL_CLOCK_ALLOWED.items():
        if path == rel and (scope == s or scope.startswith(s + ".")):
            return True
    return False


def _check_clock_and_rng(ctx, mods, names, out: list[Violation]) -> None:
    for node in ast.walk(ctx.tree):
        if not isinstance(node, ast.Call):
            continue
        dotted = dotted_call_name(node.func, mods, names)
        if dotted is None:
            continue
        scope = scope_of(node)
        if dotted in WALL_CLOCK:
            if not _allowed_wall(ctx.rel, scope):
                out.append(Violation(
                    "DET001", ctx.rel, node.lineno,
                    f"wall-clock read `{dotted}` on a decision path "
                    "(virtual clock only; measurement seams go in "
                    "allowlists.WALL_CLOCK_ALLOWED)",
                    f"{scope}:{dotted}"))
            continue
        if dotted in ("random.SystemRandom", "os.urandom"):
            out.append(Violation(
                "DET002", ctx.rel, node.lineno,
                f"`{dotted}` draws OS entropy — never deterministic",
                f"{scope}:{dotted}"))
            continue
        if dotted in ("random.Random", "numpy.random.default_rng"):
            if not node.args and not node.keywords:
                out.append(Violation(
                    "DET002", ctx.rel, node.lineno,
                    f"`{dotted}()` without a seed is entropy-seeded — "
                    "decision paths must thread an explicit seed",
                    f"{scope}:{dotted}"))
            continue
        if dotted.startswith("random."):
            out.append(Violation(
                "DET002", ctx.rel, node.lineno,
                f"`{dotted}` uses the global process RNG; construct a "
                "seeded random.Random(seed) instead",
                f"{scope}:{dotted}"))
            continue
        if (dotted.startswith("numpy.random.")
                and dotted not in _NP_SEEDED_OK):
            out.append(Violation(
                "DET002", ctx.rel, node.lineno,
                f"`{dotted}` uses numpy's legacy global RNG; use a seeded "
                "np.random.default_rng(seed)",
                f"{scope}:{dotted}"))
            continue
        if dotted in ("uuid.uuid1", "uuid.uuid4") or \
                dotted.startswith("secrets."):
            out.append(Violation(
                "DET002", ctx.rel, node.lineno,
                f"`{dotted}` is non-deterministic by construction",
                f"{scope}:{dotted}"))
            continue
        if dotted == "id":
            out.append(Violation(
                "DET003", ctx.rel, node.lineno,
                "id() on a decision path: allocation addresses vary "
                "across processes — key on a stable field "
                "(node_id/req_id) instead",
                f"{scope}:id"))


def _set_typed(expr: ast.AST, local_sets: set[str]) -> bool:
    if isinstance(expr, (ast.Set, ast.SetComp)):
        return True
    if isinstance(expr, ast.Name):
        return expr.id in local_sets
    if isinstance(expr, ast.Call):
        f = expr.func
        if isinstance(f, ast.Name) and f.id in ("set", "frozenset"):
            return True
        if isinstance(f, ast.Attribute) and f.attr in SET_METHODS:
            return _set_typed(f.value, local_sets)
        return False
    if isinstance(expr, ast.BinOp) and isinstance(expr.op, SET_OPS):
        return (_set_typed(expr.left, local_sets)
                or _set_typed(expr.right, local_sets))
    return False


def _check_set_iteration(ctx, out: list[Violation]) -> None:
    # names assigned a set-typed value anywhere in the file (scope-blind on
    # purpose: cheap, and a rebind to non-set just risks a false positive
    # that a pragma or sorted() wrap resolves)
    local_sets: set[str] = set()
    for _ in range(2):  # tiny fixpoint so chained aliases resolve
        for node in ast.walk(ctx.tree):
            if isinstance(node, ast.Assign) and _set_typed(node.value,
                                                           local_sets):
                for t in node.targets:
                    if isinstance(t, ast.Name):
                        local_sets.add(t.id)
            elif isinstance(node, (ast.AnnAssign, ast.AugAssign)) and \
                    node.value is not None and \
                    _set_typed(node.value, local_sets):
                t = node.target
                if isinstance(t, ast.Name):
                    local_sets.add(t.id)

    # comprehensions whose result feeds an order-insensitive reducer
    exempt: set[ast.AST] = set()
    for node in ast.walk(ctx.tree):
        if isinstance(node, ast.Call) and isinstance(node.func, ast.Name) \
                and node.func.id in ORDER_FREE_REDUCERS:
            for arg in node.args:
                if isinstance(arg, (ast.ListComp, ast.GeneratorExp)):
                    exempt.add(arg)

    def flag(node: ast.AST, what: str) -> None:
        scope = scope_of(node)
        out.append(Violation(
            "DET004", ctx.rel, node.lineno,
            f"ordering-sensitive iteration over a set ({what}): set "
            "order is hash-seed dependent — iterate sorted(...) or use "
            "an order-insensitive reducer",
            f"{scope}:set-iter"))

    for node in ast.walk(ctx.tree):
        if isinstance(node, (ast.For, ast.AsyncFor)) and \
                _set_typed(node.iter, local_sets):
            flag(node, "for loop")
        elif isinstance(node, (ast.ListComp, ast.GeneratorExp)) and \
                node not in exempt and \
                _set_typed(node.generators[0].iter, local_sets):
            flag(node, "comprehension")


def run(project: Project) -> list[Violation]:
    out: list[Violation] = []
    for ctx in project.files:
        if not ctx.decision_path:
            continue
        mods, names = import_maps(ctx.tree)
        _check_clock_and_rng(ctx, mods, names, out)
        _check_set_iteration(ctx, out)
    return out
