"""Data-parallel training and sharded serving over ``torch.distributed``:
the process-group mesh, the global-batch Dice statistics, the sharded tile
forward, and a one-step dry run on n processes."""
