"""Host-side data loading (cine video chunks)."""
