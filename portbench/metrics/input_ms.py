"""Host ms a step inside the program's ``csof:train.input`` span (the batch
fitted to the mesh and copied to the device), in the traced run's
profiled slice. None where the program opens no such span."""

from portbench.yardstick import spans


def read(record: dict, name: str):
    sp = spans.of(record)
    return None if sp is None else sp.host_ms().get("train.input")
