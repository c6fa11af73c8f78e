"""Stage-split execution: the compute leaf of the serving data plane."""
