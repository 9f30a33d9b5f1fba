"""Host-side utilities: NIfTI files, the YAML subset, small IO helpers, worker processes,
the device check of library entry points."""
