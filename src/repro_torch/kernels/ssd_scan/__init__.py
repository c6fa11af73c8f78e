"""The ssd_scan kernel: CUDA source under csrc/, wrapper and plain version in ops.py."""
