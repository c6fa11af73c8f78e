"""Command-line entry points of the port.

  serve.py   the serving launcher (`python -m repro_torch.launch.serve`):
             the MILP control plane plans pooled pipelines, the simulator
             drives the reservation data plane (no device work)
  common.py  its setup helpers, copied from the reference's
             `benchmarks/common.py` (SERVE_SEQ, model_spec, make_setup,
             max_load_factor)
  dryrun.py  the dry run (`python -m repro_torch.launch.dryrun`): each
             (arch x shape) cell's step traced on the meta device, its
             memory and FLOPs on one H100, no card needed
  hlo_analysis.py  the dry run's tracker and roofline terms
"""
