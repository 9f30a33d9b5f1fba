"""Host-side utilities (NIfTI output)."""
