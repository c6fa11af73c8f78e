from .collectives import compressed_psum, CompressionState  # noqa: F401
