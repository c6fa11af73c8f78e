"""The port's serve CLI (`python -m repro_torch.launch.serve`) against the
reference's (`python -m repro.launch.serve`): the same arguments print the
same lines, character for character, apart from the solver's wall-clock
`solver=... ms` field; and its setup helpers equal `benchmarks/common.py`'s."""

import re
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
BASE = ["--hi", "1", "--lo", "3", "--horizon", "1.0"]
_SOLVER_MS = re.compile(r"solver=[0-9.]+ ms")


def _mask(out: str) -> str:
    return _SOLVER_MS.sub("solver=<wall> ms", out)


def _run_main(module: str, argv: list[str], monkeypatch, capsys) -> str:
    import importlib

    monkeypatch.syspath_prepend(str(REPO))  # the reference imports benchmarks.common
    monkeypatch.setattr(sys, "argv", [module, *argv])
    capsys.readouterr()
    importlib.import_module(module).main()
    return capsys.readouterr().out


@pytest.mark.parametrize("extra", [[], ["--planner", "np"], ["--planner", "dart"], ["--bursty"],
                                   ["--reactive"], ["--sweep"]],
                         ids=["ppipe", "np", "dart", "bursty", "reactive", "sweep"])
def test_serve_cli_prints_what_the_reference_prints(extra, monkeypatch, capsys):
    ref = _run_main("repro.launch.serve", BASE + extra, monkeypatch, capsys)
    mine = _run_main("repro_torch.launch.serve", BASE + extra, monkeypatch, capsys)
    assert "ClusterPlan:" in ref and ("max load factor" in ref if extra == ["--sweep"]
                                      else "attainment=" in ref)
    assert _mask(mine) == _mask(ref)


def test_serve_cli_runs_as_a_module():
    """`python -m repro_torch.launch.serve` as a user runs it, in a process
    of its own, prints what `main()` prints here."""
    out = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve", *BASE, "--lo", "2"],
                         cwd=REPO, env={"PYTHONPATH": str(REPO / "src"), "PATH": "/usr/bin:/bin"},
                         capture_output=True, text=True, timeout=300, check=True).stdout
    assert out.startswith("ClusterPlan: 1 pipeline(s)")
    assert "(ppipe, poisson, reservation data plane)" in out
    assert re.search(r"requests=\d+  attainment=\d\.\d{3}", out)


def test_serve_cli_archs_are_the_ports_registry(monkeypatch):
    from repro_torch.configs import ARCH_IDS
    from repro_torch.launch import serve

    assert ARCH_IDS == ["stablelm-3b", "qwen3-14b", "zamba2-2.7b"]
    monkeypatch.setattr(sys, "argv", ["serve", "--archs", "llama4-scout"])
    with pytest.raises(SystemExit):
        serve.main()


@pytest.mark.parametrize("arch", ["stablelm-3b", "qwen3-14b", "zamba2-2.7b"])
def test_launch_setup_helpers_equal_benchmarks_common(arch, monkeypatch):
    """`repro_torch.launch.common` is the reference's `benchmarks/common.py`
    for what the CLI needs: the same ModelSpec, profiles and latency
    tables, and the same load-factor search."""
    import dataclasses

    monkeypatch.syspath_prepend(str(REPO))
    from benchmarks import common as ref_common

    from repro.core.types import ClusterSpec as RefCluster
    from repro_torch.core.types import ClusterSpec
    from repro_torch.launch import common

    assert common.SERVE_SEQ == ref_common.SERVE_SEQ
    assert dataclasses.asdict(common.model_spec(arch)) == \
        dataclasses.asdict(ref_common.model_spec(arch))
    counts = {"tpu-hi": 1, "tpu-lo": 3}
    profiles, tables = common.make_setup([arch], ClusterSpec(counts=counts))
    ref_profiles, ref_tables = ref_common.make_setup([arch], RefCluster(counts=counts))
    assert dataclasses.asdict(profiles[arch]) == dataclasses.asdict(ref_profiles[arch])
    assert tables[arch].lat == ref_tables[arch].lat and tables[arch].lat
    for curve in (lambda lf: 1.0 - lf / 2, lambda lf: 1.0, lambda lf: 0.0):
        assert common.max_load_factor(curve) == ref_common.max_load_factor(curve)
