"""Device ms a step of the kernels launched inside the program's
``csof:block3d.*`` spans that lie inside ``csof:train.backward``: what remat
recomputes in the backward pass, in the traced run's profiled slice. None
where the program opens no ``block3d.*`` span or the launches were not paired
(``yardstick/spans.py``)."""

from portbench.yardstick import spans

PREFIX = "block3d."


def read(record: dict, name: str):
    sp = spans.of(record)
    if sp is None or sp.device_ms() is None:
        return None
    if not any(n.startswith(PREFIX) for n, _, _ in sp.spans):
        return None
    us = sum(e - s for owner, (_, s, e, at) in zip(sp.owners, sp.device)
             if owner is not None and owner.startswith(PREFIX)
             and sp.innermost(at, ("train.backward",)) is not None)
    return us / 1e3 / sp.steps
