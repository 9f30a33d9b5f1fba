"""Typed model configuration (mirror of csof_tpu.config.experiment), plans, folders."""
