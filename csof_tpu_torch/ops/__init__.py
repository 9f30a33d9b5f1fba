"""Array ops: warp, correlation, losses."""
