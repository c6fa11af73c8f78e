"""Dense decoder family in PyTorch (the dense subset of the reference's
`repro.models`)."""
