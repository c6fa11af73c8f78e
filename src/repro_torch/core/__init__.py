"""Device-free PPipe core, copied from the reference package: value types,
the analytic cost model, pre-partitioning (blocks), plan dataclasses, the
reservation tables, runtime instantiation and Algorithm 1 (scheduler)."""
