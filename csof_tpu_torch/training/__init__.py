"""SegFlow training: schedules and optimizer, checkpoints, the trainer."""
