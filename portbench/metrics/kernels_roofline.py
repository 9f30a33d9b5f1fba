"""The hand-written kernels' share of their roofline in the profiled slice,
in percent: the sum of each launch's bound (from the shapes the launch was
given, ``portbench.yardstick.bounds``) over the sum of the device time of
the kernels of ``csrc/``. None where the slice ran none of them."""

from portbench.shims import is_hand_kernel


def read(record: dict, name: str):
    sl, launches = record.get("slice"), record.get("launch_bounds")
    if sl is None or not launches:
        return None
    device_s = sum(e - s for n, s, e in sl.events if is_hand_kernel(n)) / 1e6
    if device_s <= 0.0:
        return None
    return 100.0 * sum(b for _, b in launches) / device_s
