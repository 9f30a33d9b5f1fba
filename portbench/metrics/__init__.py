"""Per-layer metric readers, one module a metric, found by the part of the
metric's name before its first dot: ``read(record, name)`` takes the
traced run's record and returns the value, or None where the run left
nothing to read."""
