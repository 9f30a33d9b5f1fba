"""Device ms a step of the kernels launched inside the program's
``csof:block3d.norm_act`` spans (a 3-D block's eager InstanceNorm and
LeakyReLU), in the forward pass and in remat's recompute inside the
backward pass, in the traced run's profiled slice. None where the program
opens no such span or the launches were not paired (``yardstick/spans.py``)."""

from portbench.yardstick import spans


def read(record: dict, name: str):
    sp = spans.of(record)
    return None if sp is None else (sp.device_ms() or {}).get("block3d.norm_act")
