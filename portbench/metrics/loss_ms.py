"""Device ms a step of the kernels launched inside the program's
``csof:train.loss`` span (the deep-supervision loss and the Dice
statistics), in the traced run's profiled slice. None where the program
opens no such span or the launches were not paired
(``yardstick/spans.py``)."""

from portbench.yardstick import spans


def read(record: dict, name: str):
    sp = spans.of(record)
    return None if sp is None else (sp.device_ms() or {}).get("train.loss")
