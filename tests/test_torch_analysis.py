"""repro_torch.analysis — the port's invariant linter, held as
tests/test_analysis.py holds the reference's.

Each of that file's tests has its counterpart here, on the port's paths:
the reference's seeded-violation fixtures (tests/fixtures/analysis/*.py,
read, never edited) are staged with their `repro.` imports pointed at
`repro_torch.` into a scratch tree at the paths that put them in each
rule's scope under `src/repro_torch/`.  Beside them: the port's linter on
that tree hits the rules the reference's hits on the original fixtures;
the port's self-scan is clean with an empty baseline; and every allowlist
entry suppresses a finding the port really has.
"""

import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from repro_torch.analysis import allowlists, run
from repro_torch.analysis.engine import DEFAULT_PATHS

REPO = Path(__file__).resolve().parents[1]
FIXTURES = Path(__file__).resolve().parent / "fixtures" / "analysis"
SCHEMA_SRC = REPO / "src" / "repro_torch" / "obs" / "schema.py"
BASELINE = REPO / "src" / "repro_torch" / "analysis" / "baseline.json"

# fixture file -> where it must sit in the scratch tree for its rules to
# be in scope
STAGING = {
    "det_bad.py": "src/repro_torch/core/det_bad.py",
    "jrn_bad.py": "src/repro_torch/obs/jrn_bad.py",
    "rtp_bad.py": "src/repro_torch/api/rtp_bad.py",
    "thr_bad.py": "src/repro_torch/api/thr_bad.py",
    "fac_bad.py": "src/repro_torch/examples/fac_bad.py",
}


def port_fixture(name: str) -> str:
    """The reference's fixture with its imports pointed at the port."""
    return re.sub(r"\brepro\.", "repro_torch.", (FIXTURES / name).read_text())


def stage_tree(tmp_path, names=STAGING):
    """Stage fixtures (plus the port's schema registry) into a repo-shaped
    scratch tree and return its root."""
    root = tmp_path / "tree"
    for name, rel in names.items():
        dst = root / rel
        dst.parent.mkdir(parents=True, exist_ok=True)
        dst.write_text(port_fixture(name))
    schema_dst = root / "src/repro_torch/obs/schema.py"
    schema_dst.parent.mkdir(parents=True, exist_ok=True)
    shutil.copy(SCHEMA_SRC, schema_dst)
    return root


def rules_hit(result):
    return {v.rule for v in result.violations}


def _cli(*argv):
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis", *argv],
        capture_output=True, text=True,
        env={"PYTHONPATH": str(REPO / "src"), "PATH": "/usr/bin:/bin"})


# ------------------------------------------------------- fixture catches

def test_determinism_fixture_caught(tmp_path):
    result = run(stage_tree(tmp_path), DEFAULT_PATHS, baseline_path=None)
    hits = rules_hit(result)
    assert {"DET001", "DET002", "DET003", "DET004"} <= hits
    det = [v for v in result.violations if v.rule.startswith("DET")]
    assert all(v.path == "src/repro_torch/core/det_bad.py" for v in det)
    # the order-insensitive reducer (sum over the set) must NOT flag
    assert sum(v.rule == "DET004" for v in det) == 1


def test_unseeded_rng_variants_caught(tmp_path):
    det = [v for v in run(stage_tree(tmp_path), DEFAULT_PATHS,
                          baseline_path=None).violations
           if v.rule == "DET002"]
    msgs = " ".join(v.message for v in det)
    assert "random.random" in msgs          # global RNG
    assert "default_rng" in msgs            # unseeded generator


def test_journal_fixture_caught(tmp_path):
    result = run(stage_tree(tmp_path), DEFAULT_PATHS, baseline_path=None)
    hits = rules_hit(result)
    assert {"JRN001", "JRN002", "JRN003", "JRN004", "JRN005"} <= hits
    # the drifted plan.swap emit (missing "carried") is what JRN002 pins
    drift = [v for v in result.violations
             if v.rule == "JRN002" and "carried" in v.message]
    assert drift and drift[0].path == "src/repro_torch/obs/jrn_bad.py"


def test_roundtrip_fixture_caught(tmp_path):
    result = run(stage_tree(tmp_path), DEFAULT_PATHS, baseline_path=None)
    rtp = [v for v in result.violations if v.rule.startswith("RTP")]
    assert {"RTP001", "RTP002"} <= {v.rule for v in rtp}
    assert all("gamma" in v.message for v in rtp)


def test_threads_fixture_caught(tmp_path):
    result = run(stage_tree(tmp_path), DEFAULT_PATHS, baseline_path=None)
    thr = [v for v in result.violations if v.rule == "THR001"]
    assert thr and "Worker.results" in thr[0].message


def test_facade_fixture_caught(tmp_path):
    result = run(stage_tree(tmp_path), DEFAULT_PATHS, baseline_path=None)
    hits = rules_hit(result)
    assert {"FAC001", "FAC002"} <= hits
    fac = [v for v in result.violations if v.rule.startswith("FAC")]
    assert all(v.path == "src/repro_torch/examples/fac_bad.py" for v in fac)


def test_moved_module_shim_coverage(tmp_path):
    # the new homes exist in the scratch tree but the shims are missing /
    # broken -> FAC003; a tree without the new homes owes nothing
    root = stage_tree(tmp_path, {})
    bare = run(root, DEFAULT_PATHS, baseline_path=None)
    assert not any(v.rule == "FAC003" for v in bare.violations)
    (root / "src/repro_torch/controlplane").mkdir(parents=True)
    (root / "src/repro_torch/controlplane/milp.py").write_text("X = 1\n")
    (root / "src/repro_torch/core").mkdir(parents=True, exist_ok=True)
    # a shim that forgot to forward (no import of the new home)
    (root / "src/repro_torch/core/milp.py").write_text(
        "def __getattr__(name):\n    raise AttributeError(name)\n")
    result = run(root, DEFAULT_PATHS, baseline_path=None)
    fac3 = [v for v in result.violations if v.rule == "FAC003"]
    assert {v.path for v in fac3} == {"src/repro_torch/core/milp.py"}


# ------------------------------------------------------------- mechanics

def test_inline_pragma_suppresses(tmp_path):
    root = stage_tree(tmp_path, {"det_bad.py": STAGING["det_bad.py"]})
    f = root / STAGING["det_bad.py"]
    src = f.read_text()
    src = src.replace("stamp = time.time()",
                      "stamp = time.time()  # repro_torch: allow[DET001] test")
    f.write_text(src)
    result = run(root, DEFAULT_PATHS, baseline_path=None)
    assert not any(v.rule == "DET001" for v in result.violations)
    assert any(v.rule == "DET002" for v in result.violations)  # still hit


def test_baseline_grandfathers_and_goes_stale(tmp_path):
    root = stage_tree(tmp_path, {"det_bad.py": STAGING["det_bad.py"]})
    fresh = run(root, DEFAULT_PATHS, baseline_path=None)
    det001 = next(v for v in fresh.violations if v.rule == "DET001")
    baseline = tmp_path / "baseline.json"
    gone = "DET001:src/repro_torch/core/gone.py:nope:time.time"
    baseline.write_text(json.dumps({"entries": [
        {"key": det001.key, "reason": "grandfathered for the test"},
        {"key": gone, "reason": "matches nothing -> stale"},
    ]}))
    result = run(root, DEFAULT_PATHS, baseline_path=baseline)
    assert det001.key in {v.key for v in result.baselined}
    assert det001.key not in {v.key for v in result.violations}
    assert result.stale_baseline == [gone]


def test_baseline_requires_reason(tmp_path):
    baseline = tmp_path / "baseline.json"
    baseline.write_text(json.dumps({"entries": [{"key": "DET001:x:y"}]}))
    with pytest.raises(ValueError, match="reason"):
        run(tmp_path, DEFAULT_PATHS, baseline_path=baseline)


def test_baseline_key_is_line_insensitive(tmp_path):
    root = stage_tree(tmp_path, {"det_bad.py": STAGING["det_bad.py"]})
    f = root / STAGING["det_bad.py"]
    before = run(root, DEFAULT_PATHS, baseline_path=None)
    f.write_text("# a new leading comment shifts every line\n"
                 + f.read_text())
    after = run(root, DEFAULT_PATHS, baseline_path=None)
    assert {v.key for v in before.violations} == \
        {v.key for v in after.violations}
    assert {v.line for v in before.violations} != \
        {v.line for v in after.violations}


def test_cli_gate_fails_on_drifted_emit(tmp_path):
    """A deliberately drifted emit site fails the gate (exit 2) and lands
    in the JSON report; rule breakdown included."""
    root = stage_tree(tmp_path, {"jrn_bad.py": STAGING["jrn_bad.py"]})
    report = tmp_path / "report.json"
    proc = _cli("--root", str(root), "--no-baseline", "--report", str(report))
    assert proc.returncode == 2, proc.stdout + proc.stderr
    data = json.loads(report.read_text())
    assert not data["ok"]
    assert data["counts"].get("JRN002", 0) >= 1
    assert any(v["rule"] == "JRN002" for v in data["violations"])


def test_cli_clean_tree_exits_zero(tmp_path):
    root = tmp_path / "clean"
    (root / "src/repro_torch/obs").mkdir(parents=True)
    shutil.copy(SCHEMA_SRC, root / "src/repro_torch/obs/schema.py")
    proc = _cli("--root", str(root), "--no-baseline", "src/repro_torch")
    assert proc.returncode == 0, proc.stdout + proc.stderr


# ---------------------------------------------------------- the repo itself

def test_self_scan_clean_modulo_baseline():
    """src/repro_torch (its examples included) and the port's tests pass the
    analyzer against the checked-in baseline, with no stale entries."""
    result = run(REPO, DEFAULT_PATHS, baseline_path=BASELINE)
    assert result.files_scanned > 100
    lines = [f"{v.path}:{v.line}: {v.rule} {v.message}"
             for v in result.violations]
    assert not lines, "\n".join(lines)
    assert not result.stale_baseline, result.stale_baseline


def test_schema_registry_is_single_source_of_truth():
    """The port's observer carries no free-string event kinds (JRN005 would
    flag them)."""
    result = run(REPO, ("src/repro_torch/obs",), baseline_path=None)
    assert not any(v.rule == "JRN005" for v in result.violations)


# --------------------------------------- regression pins for fixed findings

def _mini_pipeline():
    from repro_torch.core.reservation import (NodeRes, PipelineRuntime,
                                              StageRuntime, VDevRes)
    nodes = [NodeRes(node_id=i, accel_class="hi", nic_bw=1e9)
             for i in range(3)]
    vd1 = [VDevRes(0, nodes[0], 0, "hi", 1)]
    vd2 = [VDevRes(1 + i, nodes[1 + i], 1 + i, "lo", 1) for i in range(2)]
    return PipelineRuntime(
        pipeline_id=0, model_name="m", unified_batch=2,
        stages=[
            StageRuntime(vdevs=vd1, latency_by_batch={1: 0.01, 2: 0.015},
                         in_bytes_per_req=0.0),
            StageRuntime(vdevs=vd2, latency_by_batch={1: 0.02, 2: 0.03},
                         in_bytes_per_req=1e6),
        ],
    )


def test_pool_identity_is_allocation_independent():
    """The port's copy of the reference's DET003 fix in core/reservation.py:
    pool/node identity keyed on NodeRes.node_id, so two independent builds
    agree exactly."""
    from repro_torch.core.reservation import probe, validate_bisection

    a, b = _mini_pipeline(), _mini_pipeline()
    ids_a, bw_a = a.stages[1]._pool_info()
    ids_b, bw_b = b.stages[1]._pool_info()
    assert ids_a == ids_b == frozenset({1, 2})  # stable node_id keys
    assert bw_a == bw_b
    assert validate_bisection(a) == validate_bisection(b)
    assert a.bisection_mode == b.bisection_mode
    ra, rb = probe(a, 2, now=0.0), probe(b, 2, now=0.0)
    assert ra.finish_time == rb.finish_time
    assert [v.vdev_id for v in ra.path] == [v.vdev_id for v in rb.path]


# ----------------------------------------------------- the port's own

def _scanned(root: Path) -> list[str]:
    from repro_torch.analysis.engine import collect

    return [f.rel for f in collect(root, DEFAULT_PATHS).files]


def test_same_rules_hit_as_the_references_linter_on_its_fixtures(tmp_path):
    """The port's linter on the staged port tree finds what the reference's
    finds on the original fixtures at the reference's paths: the same rule,
    fixture, line and context for every finding."""
    import test_analysis
    from repro.analysis import run as ref_run
    from repro.analysis.engine import DEFAULT_PATHS as REF_PATHS

    ref = ref_run(test_analysis.stage_tree(tmp_path / "ref"), REF_PATHS, baseline_path=None)
    mine = run(stage_tree(tmp_path / "port"), DEFAULT_PATHS, baseline_path=None)

    def found(result):  # a FAC context names the module, read as the port's
        return sorted((v.rule, Path(v.path).name, v.line,
                       re.sub(r"\brepro\.", "repro_torch.", v.context))
                      for v in result.violations)

    assert found(mine) == found(ref)
    assert {v.rule[:3] for v in mine.violations} == {"DET", "JRN", "RTP", "THR", "FAC"}


def test_self_scan_is_clean_with_an_empty_baseline():
    """No finding of the port is grandfathered: the baseline holds no entry
    and the scan of the port's default paths has no violation."""
    assert json.loads(BASELINE.read_text())["entries"] == []
    result = run(REPO, DEFAULT_PATHS, baseline_path=None)
    assert result.ok and not result.baselined, [v.key for v in result.violations]
    scanned = _scanned(REPO)
    assert "src/repro_torch/dataplane/plane.py" in scanned
    assert "src/repro_torch/examples/serve_pipeline.py" in scanned
    assert "tests/test_torch_analysis.py" in scanned
    assert not any(f.startswith(("src/repro/", "examples/")) for f in scanned)
    proc = _cli("--root", str(REPO))
    assert proc.returncode == 0 and " 0 violation(s), 0 baselined" in proc.stdout, proc.stdout


@pytest.mark.parametrize("table", ["WALL_CLOCK_ALLOWED", "THREAD_SHARED_ALLOWED",
                                   "ROUNDTRIP_EXCLUDED"])
def test_every_allowlist_entry_suppresses_a_finding_of_the_port(table, monkeypatch):
    """An allowlist names only seams the port has: with the table emptied,
    each of its entries shows up as a finding of its rule."""
    entries = dict(getattr(allowlists, table))
    assert entries
    monkeypatch.setattr(allowlists, table, {})
    found = run(REPO, DEFAULT_PATHS, baseline_path=None).violations

    def hit(v, key):
        if table == "ROUNDTRIP_EXCLUDED":  # context "Class.method:field"
            cls, field = key.split(".")
            return v.context.startswith(cls + ".") and v.context.endswith(":" + field)
        return key in v.context  # "scope:call" or "thread fn:Class.attr"

    for path, key in entries:
        assert any(v.path == path and hit(v, key) for v in found), (path, key)
