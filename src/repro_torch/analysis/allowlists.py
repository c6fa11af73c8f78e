"""Sanctioned exceptions to the invariant rules — each with a reason.

These are *allowlists*, not a baseline: the baseline (`baseline.json`)
grandfathers violations that should eventually be fixed; an allowlist entry
declares a seam that is correct by design and will stay.  Rules consult
these tables; adding an entry is a reviewed code change, which is the
point.  Every entry names code the port has: an entry that matches no
finding is removed (`tests/test_torch_analysis.py` holds each one to a
finding it suppresses).

Key shapes:

* ``WALL_CLOCK_ALLOWED``: ``(repo-relative path, dotted scope)`` — the
  scope and everything nested under it may read the wall clock.
* ``THREAD_SHARED_ALLOWED``: ``(repo-relative path, "Class.attr")`` — the
  attribute is mutated both from a Thread target and on the serve path,
  with an explicit handoff protocol making that safe.
* ``FACADE_DEEP_ALLOWED``: ``(repo-relative path, dotted module)`` — this
  client may deep-import that module.
"""

from __future__ import annotations

# ----------------------------------------------------------- DET001 seams
# Wall-clock reads feed *measurement*, never decisions: solver/warm/swap
# walls are reported in artifacts (solver_wall_s, warm_wall_s) and the
# dispatcher's measured-wall feedback loop calibrates latency tables from
# real execution on the card.  Scheduling and planning themselves run on
# the virtual clock.  (The stage executors' own host-side walls live in
# `serving/`, outside the decision packages.)
WALL_CLOCK_ALLOWED: dict[tuple[str, str], str] = {
    ("src/repro_torch/controlplane/milp.py", "solve_milp_multi"):
        "reports solver_wall_s on the returned plan (measurement only)",
    ("src/repro_torch/controlplane/baselines.py", "plan_dart_r"):
        "reports solver_wall_s on the returned plan (measurement only)",
    ("src/repro_torch/controlplane/templates.py", "plan_cluster"):
        "reports solver_wall_s on the returned plan (measurement only)",
    ("src/repro_torch/controlplane/planner.py", "Planner.plan"):
        "records last_wall_s for replan-cost accounting (measurement only)",
    ("src/repro_torch/api/session.py", "_PreparedSwap.__init__.work"):
        "the background warm's wall (warm_wall_s): eager runs and CUDA "
        "graph captures on the warm's own CUDA stream, reported in the "
        "SwapRecord, never read by a decision",
    ("src/repro_torch/api/session.py", "Session.swap"):
        "warm/swap transient walls reported in SwapRecord",
    ("src/repro_torch/dataplane/plane.py", "calibrate_runtime"):
        "measured-wall calibration seam: each stage timed on the card "
        "between stream synchronizations (never a device-wide one, which "
        "a background capture forbids) feeds the latency table before "
        "serving, never mid-decision",
    ("src/repro_torch/dataplane/dispatcher.py", "PoolDispatcher.submit_chain"):
        "measured-wall feedback seam (DESIGN.md section 5): the host-side "
        "submit stamp of a real batch; decisions stay on the virtual clock",
    ("src/repro_torch/dataplane/dispatcher.py", "PoolDispatcher._measure_through"):
        "measured-wall feedback seam: ready-time stamps of completed real "
        "batches, read after each stage's CUDA event has synchronized",
}

# ----------------------------------------------------------- THR001 seams
# (class-attribute handoffs between prepare_swap's background warm thread,
# which builds executors and captures their CUDA graphs on a stream of its
# own, and the serve path; every entry names its synchronization.)
THREAD_SHARED_ALLOWED: dict[tuple[str, str], str] = {
    ("src/repro_torch/api/session.py", "Session._exec_cache"):
        "all writers hold Session._compile_lock (background warm and "
        "serve-path _executors_for serialize on it)",
    ("src/repro_torch/api/session.py", "Session._params"):
        "idempotent build-once cache; writes serialized by _compile_lock "
        "via _warm_executors/_executors_for; the parameters are read-only "
        "on both streams",
    ("src/repro_torch/api/session.py", "Session._lbms"):
        "idempotent build-once cache; writes serialized by _compile_lock "
        "via _warm_executors/_executors_for",
    ("src/repro_torch/api/session.py", "_PreparedSwap.new_ranges"):
        "written only by the worker thread; __init__ sets the pre-thread "
        "default and every read happens after Thread.join() in wait() "
        "(join is a happens-before edge)",
    ("src/repro_torch/api/session.py", "_PreparedSwap.reused"):
        "worker-thread result slot; read only after Thread.join() in "
        "wait()",
    ("src/repro_torch/api/session.py", "_PreparedSwap.warm_wall_s"):
        "worker-thread result slot; read only after Thread.join() in "
        "wait()",
    ("src/repro_torch/api/session.py", "_PreparedSwap.error"):
        "worker-thread result slot; re-raised after Thread.join() in "
        "wait()",
}

# ----------------------------------------------------------- FAC rules
# Internal subsystems that must be reached through repro_torch.api /
# repro_torch.core (the examples may import any other root of the port:
# api, core, configs, data, stream, models, kernels, training).
FACADE_FORBIDDEN_ROOTS: tuple[str, ...] = (
    "repro_torch.dataplane", "repro_torch.controlplane", "repro_torch.obs",
    "repro_torch.serving", "repro_torch.faults", "repro_torch.launch",
)

# No example of the port deep-imports a private module (the reference's one
# entry is its benchmark against the frozen scheduler, which the port's
# benchmarks will bring).
FACADE_DEEP_ALLOWED: dict[tuple[str, str], str] = {}

# Moved modules that must keep a deprecation shim: old module -> the new
# home it must re-export (FAC003 verifies the shim file still imports the
# new module and forwards via module __getattr__ or explicit re-export).
MOVED_MODULES: dict[str, str] = {
    "src/repro_torch/core/milp.py": "repro_torch.controlplane.milp",
    "src/repro_torch/core/enumerate.py": "repro_torch.controlplane.templates",
    "src/repro_torch/core/baselines.py": "repro_torch.controlplane.baselines",
    # FailureInjector lives in repro_torch.faults; training.elastic
    # re-exports it
    "src/repro_torch/training/elastic.py": "repro_torch.faults",
}

# ----------------------------------------------------------- RTP rules
# Fields deliberately excluded from dict round-trips, with why.
ROUNDTRIP_EXCLUDED: dict[tuple[str, str], str] = {
    ("src/repro_torch/api/config.py", "ServeConfig.token_fn"):
        "a callable can't serialize; from_dict re-attaches it via its "
        "token_fn parameter",
}
