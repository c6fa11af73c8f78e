"""repro_torch.analysis — the static invariant linter (DESIGN.md section 14),
the reference's `repro.analysis` pointed at the port.

An AST-based pass over ``src/repro_torch`` (its examples included) and the
port's tests ``tests/test_torch_*.py`` that enforces, at lint time, the
contracts the test suite can only probe dynamically:

=======  ==============================================================
family   invariant
=======  ==============================================================
DET      decision paths are seed-deterministic on the virtual clock:
         no wall-clock reads (DET001) or unseeded RNG (DET002) outside
         the declared measurement seams, no id()-keyed identity
         (DET003), no ordering-sensitive set iteration (DET004)
JRN      journal emitters/consumers agree with the declared event
         registry in repro_torch.obs.schema (JRN001-005)
RTP      dataclass dict round-trips cover every field (RTP001-002)
THR      state shared between Thread targets and the serve path is a
         declared handoff (THR001)
FAC      the port's examples import through the facade; moved modules
         keep deprecation shims (FAC001-003)
=======  ==============================================================

Run it from the repository's root: ``PYTHONPATH=src python -m
repro_torch.analysis [--report out.json]``.  Suppress one finding inline
with ``# repro_torch: allow[RULE] reason``; grandfathered
findings live in ``baseline.json`` (every entry needs a reason);
by-design seams live in ``allowlists.py``.  The pass never imports
target code — it is pure `ast`.
"""

from .engine import AnalysisResult, Violation, run  # noqa: F401

__all__ = ["AnalysisResult", "Violation", "run"]
