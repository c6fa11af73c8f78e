"""RTP rules: dataclass dict round-trips must cover every field.

For every dataclass in ``src/repro_torch`` that participates in the dict
round-trip contract (it defines ``from_dict``, and optionally
``to_dict``/``as_dict``), the field set is cross-checked statically so a
newly added field can never silently drop out of serialization:

* RTP001 — the serializer omits a declared field (either a dict-literal
  serializer whose keys miss it, or a generic ``dataclasses.fields`` loop
  that explicitly excludes it) and the exclusion isn't sanctioned in
  ``allowlists.ROUNDTRIP_EXCLUDED``.
* RTP002 — the deserializer can't accept a declared field: no ``**``
  catch-all, and the field is neither popped/got from the dict, passed as
  an explicit constructor kwarg, nor supplied by a ``from_dict``
  parameter.

Both directions tolerate *extra* keys (legacy aliases a migration shim
pops) — only declared-field coverage is enforced.
"""

from __future__ import annotations

import ast

from . import allowlists
from .engine import Project, Violation


def _is_dataclass(cls: ast.ClassDef) -> bool:
    for dec in cls.decorator_list:
        node = dec.func if isinstance(dec, ast.Call) else dec
        if isinstance(node, ast.Name) and node.id == "dataclass":
            return True
        if isinstance(node, ast.Attribute) and node.attr == "dataclass":
            return True
    return False


def _is_classvar(ann: ast.AST) -> bool:
    node = ann
    if isinstance(node, ast.Subscript):
        node = node.value
    return (isinstance(node, ast.Name) and node.id == "ClassVar") or \
        (isinstance(node, ast.Attribute) and node.attr == "ClassVar")


def _fields(cls: ast.ClassDef) -> list[str]:
    out = []
    for stmt in cls.body:
        if isinstance(stmt, ast.AnnAssign) and \
                isinstance(stmt.target, ast.Name) and \
                not _is_classvar(stmt.annotation):
            out.append(stmt.target.id)
    return out


def _method(cls: ast.ClassDef, *names: str) -> ast.FunctionDef | None:
    for stmt in cls.body:
        if isinstance(stmt, ast.FunctionDef) and stmt.name in names:
            return stmt
    return None


def _uses_generic_fields(fn: ast.FunctionDef) -> bool:
    for node in ast.walk(fn):
        if isinstance(node, ast.Call):
            f = node.func
            if (isinstance(f, ast.Name) and f.id == "fields") or \
                    (isinstance(f, ast.Attribute) and f.attr == "fields"):
                return True
    return False


def _name_exclusions(fn: ast.FunctionDef) -> set[str]:
    """Literal strings compared against a ``<x>.name`` inside a generic
    ``fields()`` serializer — the fields the loop filters out."""
    out: set[str] = set()
    for node in ast.walk(fn):
        if not (isinstance(node, ast.Compare) and len(node.ops) == 1):
            continue
        sides = [(node.left, node.comparators[0]),
                 (node.comparators[0], node.left)]
        for name_side, lit_side in sides:
            if isinstance(name_side, ast.Attribute) and \
                    name_side.attr == "name":
                for el in ([lit_side] if isinstance(lit_side, ast.Constant)
                           else getattr(lit_side, "elts", [])):
                    if isinstance(el, ast.Constant) and \
                            isinstance(el.value, str):
                        out.add(el.value)
    return out


def _literal_keys(fn: ast.FunctionDef) -> set[str]:
    """All literal string keys of dict literals / dict-subscript stores in
    the serializer body."""
    out: set[str] = set()
    for node in ast.walk(fn):
        if isinstance(node, ast.Dict):
            for k in node.keys:
                if isinstance(k, ast.Constant) and isinstance(k.value, str):
                    out.add(k.value)
        elif isinstance(node, ast.Assign):
            for t in node.targets:
                if isinstance(t, ast.Subscript) and \
                        isinstance(t.slice, ast.Constant) and \
                        isinstance(t.slice.value, str):
                    out.add(t.slice.value)
    return out


def _deser_coverage(fn: ast.FunctionDef) -> tuple[set[str], bool]:
    """(explicitly handled keys, has a ** catch-all constructor)."""
    keys: set[str] = set()
    catch_all = False
    for node in ast.walk(fn):
        if isinstance(node, ast.Call):
            f = node.func
            if isinstance(f, ast.Attribute) and f.attr in ("pop", "get") \
                    and node.args and \
                    isinstance(node.args[0], ast.Constant) and \
                    isinstance(node.args[0].value, str):
                keys.add(node.args[0].value)
            for kw in node.keywords:
                if kw.arg is None:
                    catch_all = True
                elif kw.arg:
                    keys.add(kw.arg)
        elif isinstance(node, ast.Subscript) and \
                isinstance(node.slice, ast.Constant) and \
                isinstance(node.slice.value, str):
            keys.add(node.slice.value)
    # parameters beyond (cls, d) supply fields from the call site
    args = fn.args
    for a in list(args.args)[2:] + list(args.kwonlyargs):
        keys.add(a.arg)
    return keys, catch_all


def _allowed(rel: str, cls: str, field: str) -> bool:
    return (rel, f"{cls}.{field}") in allowlists.ROUNDTRIP_EXCLUDED


def run(project: Project) -> list[Violation]:
    out: list[Violation] = []
    for ctx in project.files:
        if not ctx.in_src:
            continue
        for node in ast.walk(ctx.tree):
            if not (isinstance(node, ast.ClassDef) and _is_dataclass(node)):
                continue
            deser = _method(node, "from_dict")
            if deser is None:
                continue  # no round-trip contract
            fields = set(_fields(node))
            ser = _method(node, "to_dict", "as_dict")
            if ser is not None:
                if _uses_generic_fields(ser):
                    missing = _name_exclusions(ser) & fields
                else:
                    missing = fields - _literal_keys(ser)
                for f in sorted(missing):
                    if not _allowed(ctx.rel, node.name, f):
                        out.append(Violation(
                            "RTP001", ctx.rel, ser.lineno,
                            f"{node.name}.{ser.name} omits dataclass "
                            f"field {f!r} — it will silently drop from "
                            "serialization",
                            f"{node.name}.{ser.name}:{f}"))
            covered, catch_all = _deser_coverage(deser)
            if not catch_all:
                for f in sorted(fields - covered):
                    if not _allowed(ctx.rel, node.name, f):
                        out.append(Violation(
                            "RTP002", ctx.rel, deser.lineno,
                            f"{node.name}.from_dict cannot accept field "
                            f"{f!r} (no ** catch-all and the key is "
                            "never read)",
                            f"{node.name}.from_dict:{f}"))
    return out
