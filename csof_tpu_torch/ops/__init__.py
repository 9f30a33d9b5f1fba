"""Array ops: warp, correlation."""
