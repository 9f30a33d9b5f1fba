"""The share of the profiled slice, in percent, in which no operation ran on
the device: the gaps in the union of the device events' intervals."""


def read(record: dict, name: str):
    sl = record.get("slice")
    if sl is None or sl.window_s <= 0.0:
        return None
    return 100.0 * (1.0 - sl.busy_s() / sl.window_s)
