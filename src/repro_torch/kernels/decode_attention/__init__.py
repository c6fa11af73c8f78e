"""The decode_attention kernel: CUDA source under csrc/, wrapper and plain version in ops.py."""
