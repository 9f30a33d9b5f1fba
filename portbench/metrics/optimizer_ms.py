"""Device ms of one optimizer update (clip, then SGD), by CUDA events around
each call of the trainer's ``optimizer.step``."""

import statistics


def read(record: dict, name: str):
    ms = record.get("optimizer_ms")
    return statistics.fmean(ms) if ms else None
