"""THR001: state shared between a Thread target and the serve path must be
a declared handoff.

Per module (threads never cross module boundaries here): find every
``threading.Thread(target=...)`` construction, resolve its target to local
function definitions, and compute the set of functions statically
reachable from those targets (name-based call graph: ``f(...)`` resolves
to same-module functions named ``f``; ``x.m(...)`` to same-module methods
named ``m``).  Any class attribute mutated both by a thread-reachable
function and by a function *not* reachable from a thread (the serve path)
is flagged unless ``allowlists.THREAD_SHARED_ALLOWED`` names it with its
synchronization story.

Mutations counted: ``x.attr = / += / del``, ``x.attr[...] =``, and
in-place mutator calls (``x.attr.append/update/...``).  The owner class is
resolved from ``self`` (enclosing class, including closures) or from
parameter/closure annotations; unresolvable receivers fall back to
attribute-name matching so a rename can't silently hide a handoff.
"""

from __future__ import annotations

import ast
from dataclasses import dataclass, field

from . import allowlists
from .engine import Project, Violation, dotted_call_name, import_maps

MUTATOR_METHODS = {"append", "extend", "add", "update", "insert", "pop",
                   "popitem", "remove", "discard", "clear", "setdefault",
                   "appendleft", "sort"}


@dataclass
class _Func:
    qualname: str
    bare: str
    node: ast.AST
    owner_class: str | None   # nearest enclosing class, if any
    ann_types: dict[str, str] = field(default_factory=dict)


def _collect(tree: ast.Module) -> tuple[list[_Func], set[str]]:
    funcs: list[_Func] = []
    classes: set[str] = set()

    def ann_name(ann: ast.AST | None) -> str | None:
        if isinstance(ann, ast.Name):
            return ann.id
        if isinstance(ann, ast.Attribute):
            return ann.attr
        if isinstance(ann, ast.Constant) and isinstance(ann.value, str):
            return ann.value.strip("'\"").split(".")[-1]
        return None

    def visit(node: ast.AST, q: str, cls: str | None,
              inherited: dict[str, str]) -> None:
        for child in ast.iter_child_nodes(node):
            if isinstance(child, ast.ClassDef):
                classes.add(child.name)
                visit(child, f"{q}.{child.name}" if q else child.name,
                      child.name, {})
            elif isinstance(child, (ast.FunctionDef,
                                    ast.AsyncFunctionDef)):
                cq = f"{q}.{child.name}" if q else child.name
                anns = dict(inherited)
                for a in (list(child.args.args)
                          + list(child.args.kwonlyargs)):
                    t = ann_name(a.annotation)
                    if t:
                        anns[a.arg] = t
                funcs.append(_Func(cq, child.name, child, cls, anns))
                # nested functions close over our params (prepare_swap's
                # `work` sees `session`), so annotations flow down
                visit(child, cq, cls, anns)
            else:
                visit(child, q, cls, inherited)

    visit(tree, "", None, {})
    return funcs, classes


def _own_body(fn: ast.AST):
    """Walk a function's body without descending into nested defs (their
    mutations belong to the nested function, which the call graph covers
    separately)."""
    stack = list(ast.iter_child_nodes(fn))
    while stack:
        node = stack.pop()
        yield node
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef, ast.Lambda)):
            stack.extend(ast.iter_child_nodes(node))


def _thread_targets(tree: ast.Module, funcs: list[_Func],
                    mods, names) -> list[_Func]:
    entries: list[_Func] = []
    by_bare: dict[str, list[_Func]] = {}
    for f in funcs:
        by_bare.setdefault(f.bare, []).append(f)
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        dotted = dotted_call_name(node.func, mods, names)
        if dotted != "threading.Thread":
            continue
        for kw in node.keywords:
            if kw.arg != "target":
                continue
            if isinstance(kw.value, ast.Name):
                entries.extend(by_bare.get(kw.value.id, []))
            elif isinstance(kw.value, ast.Attribute):
                entries.extend(by_bare.get(kw.value.attr, []))
    return entries


def _reachable(entries: list[_Func], funcs: list[_Func]) -> set[str]:
    by_bare: dict[str, list[_Func]] = {}
    for f in funcs:
        by_bare.setdefault(f.bare, []).append(f)
    seen = {f.qualname for f in entries}
    todo = list(entries)
    while todo:
        fn = todo.pop()
        for node in _own_body(fn.node):
            if not isinstance(node, ast.Call):
                continue
            if isinstance(node.func, ast.Name):
                name = node.func.id
            elif isinstance(node.func, ast.Attribute):
                name = node.func.attr
            else:
                continue
            for cand in by_bare.get(name, []):
                if cand.qualname not in seen:
                    seen.add(cand.qualname)
                    todo.append(cand)
    return seen


def _mutations(fn: _Func) -> list[tuple[str, str, int]]:
    """(owner-class-or-'?', attr, line) mutated directly in `fn`."""
    out: list[tuple[str, str, int]] = []

    def owner_of(recv: ast.AST) -> str | None:
        if isinstance(recv, ast.Name):
            if recv.id == "self":
                return fn.owner_class or "?"
            return fn.ann_types.get(recv.id, "?")
        return None

    def record(attr_node: ast.AST, line: int) -> None:
        if isinstance(attr_node, ast.Attribute):
            owner = owner_of(attr_node.value)
            if owner is not None:
                out.append((owner, attr_node.attr, line))

    for node in _own_body(fn.node):
        if isinstance(node, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) \
                else [node.target]
            flat: list[ast.AST] = []
            for t in targets:
                if isinstance(t, (ast.Tuple, ast.List)):
                    flat.extend(t.elts)
                else:
                    flat.append(t)
            for t in flat:
                if isinstance(t, ast.Attribute):
                    record(t, node.lineno)
                elif isinstance(t, ast.Subscript):
                    record(t.value, node.lineno)
        elif isinstance(node, ast.Delete):
            for t in node.targets:
                if isinstance(t, ast.Attribute):
                    record(t, node.lineno)
                elif isinstance(t, ast.Subscript):
                    record(t.value, node.lineno)
        elif isinstance(node, ast.Call) and \
                isinstance(node.func, ast.Attribute) and \
                node.func.attr in MUTATOR_METHODS:
            record(node.func.value, node.lineno)
    return out


def _match(a: tuple[str, str], b: tuple[str, str]) -> bool:
    """Owner-aware match; '?' owners fall back to attr-name equality."""
    (ca, aa), (cb, ab) = a, b
    if aa != ab:
        return False
    return ca == cb or ca == "?" or cb == "?"


def run(project: Project) -> list[Violation]:
    out: list[Violation] = []
    for ctx in project.files:
        if not ctx.in_src:
            continue
        if "threading" not in ctx.source:
            continue
        mods, names = import_maps(ctx.tree)
        funcs, _classes = _collect(ctx.tree)
        entries = _thread_targets(ctx.tree, funcs, mods, names)
        if not entries:
            continue
        reach = _reachable(entries, funcs)
        thread_funcs = [f for f in funcs if f.qualname in reach]
        serve_funcs = [f for f in funcs if f.qualname not in reach]
        serve_muts = {(c, a) for f in serve_funcs
                      for (c, a, _ln) in _mutations(f)}
        for f in thread_funcs:
            for (cls, attr, line) in _mutations(f):
                if not any(_match((cls, attr), s) for s in serve_muts):
                    continue
                owner = cls if cls != "?" else (f.owner_class or "?")
                key = (ctx.rel, f"{owner}.{attr}")
                if key in allowlists.THREAD_SHARED_ALLOWED:
                    continue
                out.append(Violation(
                    "THR001", ctx.rel, line,
                    f"`{owner}.{attr}` is mutated from the thread-"
                    f"reachable `{f.qualname}` AND on the serve path — "
                    "declare the handoff (with its lock/ordering story) "
                    "in allowlists.THREAD_SHARED_ALLOWED",
                    f"{f.qualname}:{owner}.{attr}"))
    return out
