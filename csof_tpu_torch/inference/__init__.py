"""Serving remap and full-cine flow prediction."""
