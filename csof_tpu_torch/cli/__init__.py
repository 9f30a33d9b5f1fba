"""Command-line entries of the port."""
