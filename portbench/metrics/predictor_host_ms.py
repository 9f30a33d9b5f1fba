"""Host ms a request spends outside the network's forward calls: the
predictor's crop, normalisation, softmax, copies to the host and uncrop,
from spans around the forward synchronized at their edges."""

import statistics


def read(record: dict, name: str):
    ms = record.get("predictor_host_ms")
    return statistics.fmean(ms) if ms else None
