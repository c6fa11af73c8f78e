"""Request traces (copied from the reference package)."""
