"""CLI: ``python -m repro_torch.analysis [paths...] [--report out.json]``.

Exit codes: 0 — clean (modulo baseline); 2 — non-baselined violations
(or stale baseline entries, which must be pruned when fixed).
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

from .engine import DEFAULT_PATHS, run

DEFAULT_BASELINE = Path(__file__).with_name("baseline.json")


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="static invariant linter (see repro_torch.analysis docs)")
    ap.add_argument("paths", nargs="*", default=None,
                    help=f"scan roots (default: {' '.join(DEFAULT_PATHS)})")
    ap.add_argument("--root", type=Path, default=Path.cwd(),
                    help="repository root (default: cwd)")
    ap.add_argument("--report", type=Path, default=None,
                    help="write the JSON violations report here")
    ap.add_argument("--baseline", type=Path, default=DEFAULT_BASELINE,
                    help="baseline file (default: the checked-in one)")
    ap.add_argument("--no-baseline", action="store_true",
                    help="ignore the baseline (report everything as new)")
    args = ap.parse_args(argv)

    paths = tuple(args.paths) if args.paths else DEFAULT_PATHS
    baseline = None if args.no_baseline else args.baseline
    result = run(args.root, paths, baseline_path=baseline)

    if args.report is not None:
        args.report.write_text(json.dumps(result.report(), indent=2))

    for v in result.violations:
        print(f"{v.path}:{v.line}: {v.rule} {v.message}")
    for key in result.stale_baseline:
        print(f"baseline: stale entry {key} (fixed? prune it)")
    n, b = len(result.violations), len(result.baselined)
    print(f"repro_torch.analysis: {result.files_scanned} files, "
          f"{n} violation(s), {b} baselined, "
          f"{len(result.stale_baseline)} stale baseline entr(ies)")
    return 0 if result.ok and not result.stale_baseline else 2


if __name__ == "__main__":
    sys.exit(main())
