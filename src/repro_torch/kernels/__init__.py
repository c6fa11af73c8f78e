"""Hand-written Hopper kernels of the serving path.

Each kernel directory holds its CUDA source under `csrc/` and an `ops.py`
with the launching wrapper, its launch counter and the plain PyTorch version
of the same function.  `_lib.py` builds the sources with nvcc at first use.
"""
