"""The invariant-linter engine: file collection, suppression, baseline.

`repro_torch.analysis` is a *purely static* pass: it parses the tree with
`ast` and never imports target code, so it can run before the package is
even importable (and can't be fooled by import-time side effects).  It is
the reference linter (`repro.analysis`) pointed at the port: the same
rules, the port's paths.  The engine owns everything rule-independent:

* walking the scan roots (``src/repro_torch``, which holds the port's
  examples, and the port's tests ``tests/test_torch_*.py``; a root may be a
  glob) into :class:`FileContext` objects with scope flags the rules key
  off (``decision_path``, ``facade_client``, ``in_src``);
* inline suppressions — ``# repro_torch: allow[RULE1,RULE2] reason`` on
  (or on the line above) the offending statement;
* the checked-in baseline (`baseline.json`): violations whose stable key
  matches a baselined entry are reported separately and don't fail the
  gate.  Keys are line-*insensitive* — ``rule:path:context`` where context
  is the enclosing dotted scope plus a rule-specific token — so refactors
  that merely move code don't churn the baseline.

Rules live in sibling modules (`determinism`, `journal_schema`,
`roundtrip`, `threads`, `facade`), each exposing ``run(project) ->
list[Violation]``; per-rule allowlists (the *sanctioned* exceptions, each
with a reason) live in `allowlists.py`.
"""

from __future__ import annotations

import ast
import json
import re
from dataclasses import dataclass, field
from pathlib import Path

DEFAULT_PATHS = ("src/repro_torch", "tests/test_torch_*.py")

SRC = "src/repro_torch/"
# the facade clients: the port's examples, the counterpart of the root
# examples/ and benchmarks/ that the reference linter scans
FACADE_CLIENTS = (SRC + "examples/",)

# Directories under the scan roots that hold *inputs* to the analyzer
# (seeded-violation fixtures for tests/test_analysis.py), not repo code.
EXCLUDED_PARTS = ("tests/fixtures",)

# Packages whose modules feed scheduler / planner / dispatch decisions.
# The determinism family (DET*) applies inside these; measurement-only and
# launcher code (kernels, models, serving adapters, launch scripts,
# training loops) is out of scope by design.
DECISION_PACKAGES = ("core", "controlplane", "dataplane", "stream",
                     "faults", "obs", "api", "data")

_PRAGMA_RE = re.compile(r"#\s*repro_torch:\s*allow\[([A-Z0-9*,\s]+)\]")


@dataclass(frozen=True)
class Violation:
    rule: str      # e.g. "DET001"
    path: str      # repo-relative posix path
    line: int
    message: str
    context: str   # enclosing scope + rule token; stable across line moves

    @property
    def key(self) -> str:
        """Baseline identity: deliberately excludes the line number."""
        return f"{self.rule}:{self.path}:{self.context}"

    def to_dict(self) -> dict:
        return {"rule": self.rule, "path": self.path, "line": self.line,
                "message": self.message, "key": self.key}


@dataclass
class FileContext:
    path: Path
    rel: str                 # posix path relative to the repo root
    source: str
    tree: ast.Module
    decision_path: bool      # determinism rules apply
    facade_client: bool      # the port's examples (facade rules apply)
    in_src: bool             # under src/repro_torch
    suppressed: dict[int, set[str]] = field(default_factory=dict)

    def is_suppressed(self, rule: str, line: int) -> bool:
        # a pragma suppresses its own line and the line directly below it
        # (so it can sit above a multi-line statement)
        for ln in (line, line - 1):
            rules = self.suppressed.get(ln)
            if rules and ("*" in rules or rule in rules):
                return True
        return False


class Project:
    """Everything the rules see: parsed files + the parsed journal schema."""

    def __init__(self, root: Path, files: list[FileContext]) -> None:
        self.root = root
        self.files = files
        self.by_rel = {f.rel: f for f in files}
        self.schema = None  # set by journal_schema.load_schema (lazy)


def annotate_scopes(tree: ast.Module) -> None:
    """Attach ``_q`` — the dotted enclosing-scope qualname ('' at module
    level) — to every node, so rules can report stable contexts without a
    parent map."""
    tree._q = ""  # type: ignore[attr-defined]

    def visit(node: ast.AST, q: str) -> None:
        for child in ast.iter_child_nodes(node):
            child._q = q  # type: ignore[attr-defined]
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.ClassDef)):
                visit(child, f"{q}.{child.name}" if q else child.name)
            else:
                visit(child, q)

    visit(tree, "")


def scope_of(node: ast.AST) -> str:
    return getattr(node, "_q", "")


def _scan_pragmas(source: str) -> dict[int, set[str]]:
    out: dict[int, set[str]] = {}
    for i, text in enumerate(source.splitlines(), start=1):
        m = _PRAGMA_RE.search(text)
        if m:
            out[i] = {r.strip() for r in m.group(1).split(",") if r.strip()}
    return out


def _classify(rel: str) -> tuple[bool, bool, bool]:
    in_src = rel.startswith(SRC)
    decision = in_src and any(
        rel.startswith(f"{SRC}{pkg}/") or rel == f"{SRC}{pkg}.py"
        for pkg in DECISION_PACKAGES)
    facade_client = rel.startswith(FACADE_CLIENTS)
    return decision, facade_client, in_src


def load_file(root: Path, path: Path) -> FileContext | None:
    rel = path.relative_to(root).as_posix()
    source = path.read_text(encoding="utf-8")
    try:
        tree = ast.parse(source, filename=rel)
    except SyntaxError:
        return None  # ruff's E9 gate owns syntax errors
    annotate_scopes(tree)
    decision, facade_client, in_src = _classify(rel)
    return FileContext(path=path, rel=rel, source=source, tree=tree,
                       decision_path=decision, facade_client=facade_client,
                       in_src=in_src, suppressed=_scan_pragmas(source))


def collect(root: Path, paths: tuple[str, ...] = DEFAULT_PATHS) -> Project:
    files: list[FileContext] = []
    for p in paths:
        base = root / p
        if any(c in p for c in "*?["):
            candidates = sorted(f for f in root.glob(p)
                                if f.is_file() and f.suffix == ".py")
        elif base.is_file() and base.suffix == ".py":
            candidates = [base]
        elif base.is_dir():
            candidates = sorted(base.rglob("*.py"))
        else:
            continue
        for f in candidates:
            rel = f.relative_to(root).as_posix()
            if any(rel.startswith(x + "/") for x in EXCLUDED_PARTS):
                continue
            ctx = load_file(root, f)
            if ctx is not None:
                files.append(ctx)
    return Project(root, files)


# ---------------------------------------------------------------- baseline

def load_baseline(path: Path | None) -> dict[str, str]:
    """key -> reason.  Every entry must carry a non-empty justification."""
    if path is None or not path.exists():
        return {}
    data = json.loads(path.read_text(encoding="utf-8"))
    out = {}
    for entry in data.get("entries", []):
        key, reason = entry["key"], entry.get("reason", "").strip()
        if not reason:
            raise ValueError(
                f"baseline entry {key!r} has no reason — every baselined "
                "violation needs a per-entry justification")
        out[key] = reason
    return out


@dataclass
class AnalysisResult:
    violations: list[Violation]      # new (gate-failing)
    baselined: list[Violation]       # matched a baseline entry
    stale_baseline: list[str]        # baseline keys that matched nothing
    files_scanned: int

    @property
    def ok(self) -> bool:
        return not self.violations

    def report(self) -> dict:
        return {
            "ok": self.ok,
            "files_scanned": self.files_scanned,
            "violations": [v.to_dict() for v in self.violations],
            "baselined": [v.to_dict() for v in self.baselined],
            "stale_baseline": list(self.stale_baseline),
            "counts": _counts(self.violations),
        }


def _counts(violations: list[Violation]) -> dict[str, int]:
    out: dict[str, int] = {}
    for v in violations:
        out[v.rule] = out.get(v.rule, 0) + 1
    return out


def run(root: Path, paths: tuple[str, ...] = DEFAULT_PATHS,
        baseline_path: Path | None = None) -> AnalysisResult:
    from . import facade, determinism, journal_schema, roundtrip, threads

    project = collect(root, paths)
    raw: list[Violation] = []
    for rule_mod in (determinism, journal_schema, roundtrip, threads,
                     facade):
        raw.extend(rule_mod.run(project))

    # inline pragma suppressions
    kept = []
    for v in raw:
        ctx = project.by_rel.get(v.path)
        if ctx is not None and ctx.is_suppressed(v.rule, v.line):
            continue
        kept.append(v)
    kept.sort(key=lambda v: (v.path, v.line, v.rule))

    baseline = load_baseline(baseline_path)
    new = [v for v in kept if v.key not in baseline]
    old = [v for v in kept if v.key in baseline]
    matched = {v.key for v in old}
    stale = sorted(k for k in baseline if k not in matched)
    return AnalysisResult(violations=new, baselined=old,
                          stale_baseline=stale,
                          files_scanned=len(project.files))


# ------------------------------------------------- shared AST helpers

MODULE_IMPORT_KINDS = (ast.Import, ast.ImportFrom)


def import_maps(tree: ast.Module) -> tuple[dict[str, str], dict[str, str]]:
    """(module-alias -> dotted module, imported-name -> dotted origin)."""
    mods: dict[str, str] = {}
    names: dict[str, str] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                mods[a.asname or a.name.split(".")[0]] = (
                    a.name if a.asname else a.name.split(".")[0])
                if a.asname:
                    mods[a.asname] = a.name
        elif isinstance(node, ast.ImportFrom) and node.module:
            for a in node.names:
                names[a.asname or a.name] = f"{node.module}.{a.name}"
    return mods, names


def dotted_call_name(func: ast.AST, mods: dict[str, str],
                     names: dict[str, str]) -> str | None:
    """Resolve a Call's func to a dotted origin ('numpy.random.default_rng')
    using the module's import bindings; None when the base is a local."""
    parts: list[str] = []
    cur = func
    while isinstance(cur, ast.Attribute):
        parts.append(cur.attr)
        cur = cur.value
    if not isinstance(cur, ast.Name):
        return None
    base = cur.id
    if base in mods:
        root = mods[base]
    elif base in names:
        root = names[base]
    elif not parts:
        return base  # bare builtin-style call: id(), sorted(), ...
    else:
        return None
    return ".".join([root] + list(reversed(parts)))
