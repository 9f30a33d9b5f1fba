"""The whole step's share of the chip's peak, in percent: the model FLOPs
the window's completed work needs (counted on the plain reference) over
the window's seconds times the peak of the configuration's dtype. The
window is the untraced one."""


def read(record: dict, name: str):
    f, s, peak = (record.get(k) for k in ("window_flops", "window_s", "peak_flops"))
    if not f or not s or not peak:
        return None
    return 100.0 * f / (s * peak)
