"""Device ms a step of the kernels, copies and fills launched inside the
program's ``csof:block3d.ztaps`` spans (a 3-D block's conv as one K6 launch a
z tap: the fold, the launches, the tap sum, the unfold and the bias), in the
traced run's profiled slice. None where the program opens no such span or
the launches were not paired (``yardstick/spans.py``)."""

from portbench.yardstick import spans


def read(record: dict, name: str):
    sp = spans.of(record)
    return None if sp is None else (sp.device_ms() or {}).get("block3d.ztaps")
