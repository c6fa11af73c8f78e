"""JRN rules: emitters and consumers of the decision journal must agree
with the declared registry in ``src/repro_torch/obs/schema.py``.

The registry is *parsed, not imported* (`load_schema` reads the module's
AST), so the linter stays import-free and the check works even when the
package can't import.

* JRN001 — an emit site names a kind that isn't in the registry (an
  unresolvable constant, or a ``journal.record(t, "...")`` literal with an
  undeclared kind).
* JRN002 — emit-site field drift: the literal payload keys of an emit dict
  don't match the kind's declared required fields (missing or undeclared
  extras; ``open`` kinds only require the declared subset).
* JRN003 — a consumer filters on an undeclared kind or prefix
  (``ev["kind"] == ...``, ``journal.select(kind=/prefix=)``,
  ``.startswith(...)`` on a kind expression).
* JRN004 — a consumer, inside a kind-guarded branch, subscripts a field
  that kind doesn't declare.
* JRN005 — an emit dict in ``src/repro_torch`` spells its kind as a free string
  literal instead of a schema constant (the registry is the single source
  of truth; free strings are how drift starts).
"""

from __future__ import annotations

import ast
from dataclasses import dataclass

from .engine import Project, Violation, import_maps, scope_of

SCHEMA_REL = "src/repro_torch/obs/schema.py"
ENVELOPE = {"t_s", "kind"}


@dataclass
class JournalSchema:
    constants: dict[str, str]           # constant name -> kind string
    required: dict[str, frozenset[str]]  # kind -> required payload fields
    open_kinds: frozenset[str]
    prefixes: frozenset[str]


def load_schema(project: Project) -> JournalSchema | None:
    ctx = project.by_rel.get(SCHEMA_REL)
    if ctx is None:
        return None
    constants: dict[str, str] = {}
    for node in ctx.tree.body:
        if isinstance(node, ast.Assign) and len(node.targets) == 1 and \
                isinstance(node.targets[0], ast.Name) and \
                isinstance(node.value, ast.Constant) and \
                isinstance(node.value.value, str):
            name = node.targets[0].id
            if name.isupper():
                constants[name] = node.value.value
    required: dict[str, frozenset[str]] = {}
    open_kinds: set[str] = set()
    for node in ast.walk(ctx.tree):
        # SCHEMA entries: <KIND CONST>: EventSchema(<KIND>, (fields...),
        #                                           [open=True])
        if not (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Name)
                and node.func.id == "EventSchema" and node.args):
            continue
        kind_arg = node.args[0]
        if isinstance(kind_arg, ast.Name):
            kind = constants.get(kind_arg.id)
        elif isinstance(kind_arg, ast.Constant):
            kind = kind_arg.value
        else:
            kind = None
        if kind is None:
            continue
        fields: set[str] = set()
        if len(node.args) > 1 and isinstance(node.args[1],
                                             (ast.Tuple, ast.List)):
            for el in node.args[1].elts:
                if isinstance(el, ast.Constant) and isinstance(el.value,
                                                               str):
                    fields.add(el.value)
        required[kind] = frozenset(fields)
        for kw in node.keywords:
            if kw.arg == "open" and isinstance(kw.value, ast.Constant) \
                    and kw.value.value:
                open_kinds.add(kind)
    return JournalSchema(
        constants=constants, required=required,
        open_kinds=frozenset(open_kinds),
        prefixes=frozenset(k.split(".", 1)[0] for k in required))


# ------------------------------------------------------------- emit sites

def _kind_of_dict(d: ast.Dict) -> tuple[ast.AST | None, set[str]]:
    """(the value node of the "kind" key, the literal payload keys)."""
    kind_node = None
    keys: set[str] = set()
    for k, v in zip(d.keys, d.values):
        if isinstance(k, ast.Constant) and isinstance(k.value, str):
            if k.value == "kind":
                kind_node = v
            elif k.value != "t_s":
                keys.add(k.value)
    return kind_node, keys


def _check_emits(ctx, schema: JournalSchema, out: list[Violation]) -> None:
    if ctx.rel == SCHEMA_REL:
        return
    _mods, names = import_maps(ctx.tree)
    for node in ast.walk(ctx.tree):
        if not isinstance(node, ast.Dict):
            continue
        kind_node, keys = _kind_of_dict(node)
        if kind_node is None:
            continue
        scope = scope_of(node)
        kind: str | None = None
        if isinstance(kind_node, ast.Constant) and \
                isinstance(kind_node.value, str):
            kind = kind_node.value
            if ctx.in_src:
                out.append(Violation(
                    "JRN005", ctx.rel, node.lineno,
                    f"free-string event kind {kind!r} at an emit site — "
                    "use the repro_torch.obs.schema constant",
                    f"{scope}:{kind}"))
            if kind not in schema.required:
                out.append(Violation(
                    "JRN001", ctx.rel, node.lineno,
                    f"event kind {kind!r} is not declared in "
                    "repro_torch.obs.schema.SCHEMA",
                    f"{scope}:{kind}"))
                continue
        elif isinstance(kind_node, ast.Name):
            const = kind_node.id
            if not const.isupper():
                continue  # a variable, not a constant: dynamic kind
            origin = names.get(const, "")
            cname = origin.rsplit(".", 1)[-1] if origin else const
            kind = schema.constants.get(cname)
            if kind is None:
                out.append(Violation(
                    "JRN001", ctx.rel, node.lineno,
                    f"kind constant `{const}` does not resolve to a "
                    "repro_torch.obs.schema constant",
                    f"{scope}:{const}"))
                continue
        elif isinstance(kind_node, ast.Attribute):
            kind = schema.constants.get(kind_node.attr)
            if kind is None:
                out.append(Violation(
                    "JRN001", ctx.rel, node.lineno,
                    f"kind constant `{kind_node.attr}` does not resolve "
                    "to a repro_torch.obs.schema constant",
                    f"{scope}:{kind_node.attr}"))
                continue
        else:
            continue  # dynamically computed kind: out of static reach

        declared = schema.required[kind]
        missing = declared - keys
        extra = keys - declared
        for f in sorted(missing):
            out.append(Violation(
                "JRN002", ctx.rel, node.lineno,
                f"emit of {kind!r} is missing declared field {f!r}",
                f"{scope}:{kind}:{f}"))
        if kind not in schema.open_kinds:
            for f in sorted(extra):
                out.append(Violation(
                    "JRN002", ctx.rel, node.lineno,
                    f"emit of {kind!r} carries undeclared field {f!r} "
                    "(declare it in schema.SCHEMA or drop it)",
                    f"{scope}:{kind}:{f}"))

    # journal.record(t, "<kind>", ...) — literal kinds must be declared
    for node in ast.walk(ctx.tree):
        if isinstance(node, ast.Call) and \
                isinstance(node.func, ast.Attribute) and \
                node.func.attr == "record" and len(node.args) >= 2 and \
                isinstance(node.args[1], ast.Constant) and \
                isinstance(node.args[1].value, str):
            kind = node.args[1].value
            if kind not in schema.required:
                out.append(Violation(
                    "JRN001", ctx.rel, node.lineno,
                    f"journal.record() with undeclared kind {kind!r}",
                    f"{scope_of(node)}:{kind}"))


# -------------------------------------------------------------- consumers

def _is_kind_expr(node: ast.AST, aliases: dict[str, str]) -> str | None:
    """If `node` reads some event's "kind", return the event var name."""
    if isinstance(node, ast.Subscript) and \
            isinstance(node.slice, ast.Constant) and \
            node.slice.value == "kind" and \
            isinstance(node.value, ast.Name):
        return node.value.id
    if isinstance(node, ast.Name) and node.id in aliases:
        return aliases[node.id]
    return None


def _kind_aliases(func: ast.AST) -> dict[str, str]:
    """{alias var -> event var} for `k = ev["kind"]` assignments."""
    out: dict[str, str] = {}
    for node in ast.walk(func):
        if isinstance(node, ast.Assign) and len(node.targets) == 1 and \
                isinstance(node.targets[0], ast.Name):
            ev = _is_kind_expr(node.value, {})
            if ev is not None:
                out[node.targets[0].id] = ev
    return out


def _literal_strs(node: ast.AST) -> list[tuple[ast.AST, str]]:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return [(node, node.value)]
    if isinstance(node, (ast.Tuple, ast.List, ast.Set)):
        return [p for el in node.elts for p in _literal_strs(el)]
    return []


def _check_consumers(ctx, schema: JournalSchema,
                     out: list[Violation]) -> None:
    if ctx.rel == SCHEMA_REL:
        return
    aliases = _kind_aliases(ctx.tree)

    def check_kind_literal(node: ast.AST, lit: str) -> None:
        if lit not in schema.required:
            out.append(Violation(
                "JRN003", ctx.rel, node.lineno,
                f"consumer references undeclared event kind {lit!r}",
                f"{scope_of(node)}:{lit}"))

    for node in ast.walk(ctx.tree):
        # ev["kind"] == "x" / != / in (...) / not in (...)
        if isinstance(node, ast.Compare) and len(node.ops) == 1:
            sides = [(node.left, node.comparators[0]),
                     (node.comparators[0], node.left)]
            for kind_side, lit_side in sides:
                if _is_kind_expr(kind_side, aliases) is not None:
                    for lit_node, lit in _literal_strs(lit_side):
                        check_kind_literal(lit_node, lit)
        # journal.select(kind="x") / select(prefix="x")
        elif isinstance(node, ast.Call) and \
                isinstance(node.func, ast.Attribute) and \
                node.func.attr == "select":
            kind_args = list(node.args[:1]) + [
                kw.value for kw in node.keywords if kw.arg == "kind"]
            for a in kind_args:
                if isinstance(a, ast.Constant) and isinstance(a.value,
                                                              str):
                    check_kind_literal(a, a.value)
            for kw in node.keywords:
                if kw.arg == "prefix" and \
                        isinstance(kw.value, ast.Constant) and \
                        isinstance(kw.value.value, str):
                    p = kw.value.value.rstrip(".")
                    if p not in schema.prefixes:
                        out.append(Violation(
                            "JRN003", ctx.rel, node.lineno,
                            f"select(prefix={p!r}) matches no declared "
                            "kind",
                            f"{scope_of(node)}:{p}"))
        # ev["kind"].startswith("req.")
        elif isinstance(node, ast.Call) and \
                isinstance(node.func, ast.Attribute) and \
                node.func.attr == "startswith" and \
                _is_kind_expr(node.func.value, aliases) is not None and \
                node.args and isinstance(node.args[0], ast.Constant) and \
                isinstance(node.args[0].value, str):
            p = node.args[0].value
            if not any(k.startswith(p) for k in schema.required):
                out.append(Violation(
                    "JRN003", ctx.rel, node.lineno,
                    f"kind.startswith({p!r}) matches no declared kind",
                    f"{scope_of(node)}:{p}"))

    _check_guarded_fields(ctx, schema, aliases, out)


def _select_kind(call: ast.AST, schema: JournalSchema) -> str | None:
    """Literal kind of a `*.select(kind="x")` call, if declared."""
    if isinstance(call, ast.Call) and \
            isinstance(call.func, ast.Attribute) and \
            call.func.attr == "select":
        args = list(call.args[:1]) + [kw.value for kw in call.keywords
                                      if kw.arg == "kind"]
        for a in args:
            if isinstance(a, ast.Constant) and isinstance(a.value, str) \
                    and a.value in schema.required:
                return a.value
    return None


def _check_guarded_fields(ctx, schema: JournalSchema,
                          aliases: dict[str, str],
                          out: list[Violation]) -> None:
    def check_accesses(body: list[ast.AST] | ast.AST, ev_var: str,
                       kind: str) -> None:
        if kind in schema.open_kinds:
            return
        allowed = schema.required[kind] | ENVELOPE
        nodes = body if isinstance(body, list) else [body]
        for stmt in nodes:
            for node in ast.walk(stmt):
                if isinstance(node, ast.Subscript) and \
                        isinstance(node.value, ast.Name) and \
                        node.value.id == ev_var and \
                        isinstance(node.slice, ast.Constant) and \
                        isinstance(node.slice.value, str) and \
                        node.slice.value not in allowed:
                    out.append(Violation(
                        "JRN004", ctx.rel, node.lineno,
                        f"access to {node.slice.value!r} on a "
                        f"{kind!r} event, which does not declare it",
                        f"{scope_of(node)}:{kind}:{node.slice.value}"))

    for node in ast.walk(ctx.tree):
        # if ev["kind"] == "x": ...   /   if k == "x": ... (k aliased)
        if isinstance(node, ast.If) and \
                isinstance(node.test, ast.Compare) and \
                len(node.test.ops) == 1 and \
                isinstance(node.test.ops[0], ast.Eq):
            ev = _is_kind_expr(node.test.left, aliases)
            lit = node.test.comparators[0]
            if ev is not None and isinstance(lit, ast.Constant) and \
                    isinstance(lit.value, str) and \
                    lit.value in schema.required:
                check_accesses(node.body, ev, lit.value)
        # for ev in journal.select(kind="x"): ...
        elif isinstance(node, (ast.For, ast.AsyncFor)) and \
                isinstance(node.target, ast.Name):
            kind = _select_kind(node.iter, schema)
            if kind is not None:
                check_accesses(node.body, node.target.id, kind)
        # [ev[...] for ev in journal.select(kind="x")]
        # [ev[...] for ev in evs if ev["kind"] == "x"]
        elif isinstance(node, (ast.ListComp, ast.GeneratorExp,
                               ast.SetComp)):
            gen = node.generators[0]
            if not isinstance(gen.target, ast.Name):
                continue
            ev_var = gen.target.id
            kind = _select_kind(gen.iter, schema)
            if kind is None:
                for cond in gen.ifs:
                    if isinstance(cond, ast.Compare) and \
                            len(cond.ops) == 1 and \
                            isinstance(cond.ops[0], ast.Eq) and \
                            _is_kind_expr(cond.left, aliases) == ev_var:
                        lit = cond.comparators[0]
                        if isinstance(lit, ast.Constant) and \
                                isinstance(lit.value, str) and \
                                lit.value in schema.required:
                            kind = lit.value
                            break
            if kind is not None:
                check_accesses(node.elt, ev_var, kind)


def run(project: Project) -> list[Violation]:
    schema = load_schema(project)
    project.schema = schema
    if schema is None:
        return [Violation(
            "JRN001", SCHEMA_REL, 1,
            "journal schema registry src/repro_torch/obs/schema.py not found",
            ":registry-missing")]
    out: list[Violation] = []
    for ctx in project.files:
        _check_emits(ctx, schema, out)
        _check_consumers(ctx, schema, out)
    return out
