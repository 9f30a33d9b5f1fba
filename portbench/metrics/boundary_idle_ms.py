"""Device-idle ms a step of the traced run's profiled slice whose gaps'
host midpoints lie outside the step's compute spans
(``csof:train.forward``, ``.loss``, ``.backward``, ``.optimizer``): in
the input, the loss read, or between steps. None where the program opens
none of those spans."""

from portbench.yardstick import spans


def read(record: dict, name: str):
    sp = spans.of(record)
    return None if sp is None else sp.boundary_idle_ms()
