"""SegFlow and its building blocks (torch.nn, NCHW inside)."""
