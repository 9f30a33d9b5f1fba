"""Training observability (port of ``csof_tpu/utils/logging.py``):
the timestamped training log, the progress figure, the debug dump and the
parameter count and summary of a torch module.

``plot_progress`` draws ``progress.png`` itself (:mod:`csof_tpu_torch.utils.png`),
since the card machine has no matplotlib: the JAX figure's content (train
loss in blue and validation loss in red on the left axis, the foreground
Dice dashed in green on a second 0-1 axis, epochs along x) at its 1000 x 600
pixels (figsize 10 x 6 at 100 dpi), with grid lines and tick marks at five
steps of each axis and a legend of line swatches in place of text. The
pixels are not matplotlib's.
"""

from __future__ import annotations

import datetime
import json
import re
import time
from pathlib import Path

import numpy as np
from torch import nn

from csof_tpu_torch.utils.png import Canvas, write_png

#: the JAX figure's size in pixels and its colours ("b", "r", "g")
PROGRESS_SIZE = (1000, 600)
_BLUE, _RED, _GREEN = (0, 0, 255), (255, 0, 0), (0, 128, 0)
_GREY, _BLACK = (220, 220, 220), (0, 0, 0)


class TrainingLog:
    """A text log ``training_log_<Y>_<M>_<D>_<hh>_<mm>_<ss>.txt`` in
    ``folder``, named at creation; each call appends one line, prefixed
    with ``"{datetime.now()}: "`` unless ``add_timestamp=False``, retrying an
    OSError up to five times, and prints it."""

    def __init__(self, folder: str | Path, also_print: bool = True):
        self.folder = Path(folder)
        self.folder.mkdir(parents=True, exist_ok=True)
        ts = datetime.datetime.now()
        self.file = self.folder / (f"training_log_{ts.year}_{ts.month}_{ts.day}_{ts.hour:02d}_"
                                   f"{ts.minute:02d}_{ts.second:02d}.txt")
        self.also_print = also_print

    def __call__(self, *args, add_timestamp: bool = True):
        msg = " ".join(str(a) for a in args)
        if add_timestamp:
            msg = f"{datetime.datetime.now()}: {msg}"
        for _ in range(5):
            try:
                with open(self.file, "a") as f:
                    f.write(msg + "\n")
                break
            except OSError:
                time.sleep(0.5)
        if self.also_print:
            print(msg, flush=True)


_LOG_NAME = re.compile(r"training_log_(\d+)_(\d+)_(\d+)_(\d+)_(\d+)_(\d+)\.txt$")
_STAMP = re.compile(r"^\d{4}-\d\d-\d\d \d\d:\d\d:\d\d(\.\d+)?: ")


def read_training_logs(folder: str | Path) -> list[list[str]]:
    """The lines of each ``training_log_*.txt`` in ``folder`` (either
    package's), oldest file first by the time in its name, each line
    without its timestamp prefix (a line written without one as it is)."""
    files = sorted((tuple(int(g) for g in m.groups()), f) for f in Path(folder).iterdir()
                   if (m := _LOG_NAME.fullmatch(f.name)))
    return [[_STAMP.sub("", line, count=1) for line in f.read_text().splitlines()]
            for _, f in files]


def _axis(values, lo=None, hi=None) -> tuple[float, float]:
    """The data range of an axis with a 5 % margin (matplotlib's)."""
    lo = float(np.min(values)) if lo is None else lo
    hi = float(np.max(values)) if hi is None else hi
    pad = 0.05 * (hi - lo) if hi > lo else 0.5
    return lo - pad, hi + pad


def plot_progress(folder: str | Path, train_losses, val_losses=None, eval_metrics=None,
                  fname: str = "progress.png") -> Path:
    """The loss and metric curves by epoch -> ``folder/fname``, an RGB PNG
    of ``PROGRESS_SIZE``."""
    width, height = PROGRESS_SIZE
    box = (125, 60, 900, 540)  # matplotlib's default subplot margins at 10 x 6 inches
    x0, y0, x1, y1 = box
    canvas = Canvas(width, height)
    n = max(len(train_losses), len(val_losses or []), len(eval_metrics or []), 1)
    xlo, xhi = _axis([1, n])
    losses = list(train_losses) + list(val_losses or [])
    ylo, yhi = _axis(losses if losses else [0.0, 1.0])
    mlo, mhi = _axis([0.0, 1.0], 0.0, 1.0)

    def px(e):
        return x0 + (np.asarray(e, float) - xlo) / (xhi - xlo) * (x1 - x0)

    def py(v, lo, hi):
        return y1 - (np.asarray(v, float) - lo) / (hi - lo) * (y1 - y0)

    for k in range(6):  # grid and tick marks at fifths of each axis
        gx, gy = x0 + k * (x1 - x0) // 5, y0 + k * (y1 - y0) // 5
        canvas.rect(gx, y0, gx + 1, y1, _GREY)
        canvas.rect(x0, gy, x1, gy + 1, _GREY)
        canvas.rect(gx, y1, gx + 1, y1 + 6, _BLACK)
        canvas.rect(x0 - 6, gy, x0, gy + 1, _BLACK)
        if eval_metrics:
            canvas.rect(x1, gy, x1 + 6, gy + 1, _BLACK)
    for bx0, by0, bx1, by1 in ((x0, y0, x1, y0 + 1), (x0, y1, x1, y1 + 1),
                               (x0, y0, x0 + 1, y1), (x1, y0, x1 + 1, y1 + 1)):
        canvas.rect(bx0, by0, bx1, by1, _BLACK)
    curves = [(train_losses, _BLUE, 0, (ylo, yhi)), (val_losses, _RED, 0, (ylo, yhi)),
              (eval_metrics, _GREEN, 6, (mlo, mhi))]
    for values, color, dash, (lo, hi) in curves:
        if values:
            epochs = np.arange(1, len(values) + 1)
            canvas.polyline(px(epochs), py(values, lo, hi), color, dash=dash)
    # legend swatches: the losses top left (loc=2), the metric top right (loc=1)
    for i, (values, color, dash, _) in enumerate(curves[:2]):
        if values:
            canvas.polyline([x0 + 15, x0 + 55], [y0 + 20 + 20 * i] * 2, color)
    if eval_metrics:
        canvas.polyline([x1 - 55, x1 - 15], [y0 + 20] * 2, _GREEN, dash=6)
    return write_png(Path(folder) / fname, canvas.pixels)


def dump_debug_json(folder: str | Path, obj: dict, fname: str = "debug.json") -> None:
    """``obj`` as indented JSON; arrays as lists, anything else as str."""
    def conv(o):
        if isinstance(o, (np.ndarray, np.generic)):
            return np.asarray(o).tolist()
        return str(o)

    Path(folder).mkdir(parents=True, exist_ok=True)
    (Path(folder) / fname).write_text(json.dumps(obj, indent=2, default=conv))


def count_parameters(module: nn.Module) -> int:
    """The number of parameter entries of a torch module."""
    return int(sum(p.numel() for p in module.parameters()))


def model_summary(module: nn.Module) -> str:
    """A module tree, one line a submodule that holds parameters
    (``name/``, indented by depth) and one a parameter (``name: shape =
    count``), then the total."""
    lines = []

    def walk(mod, depth):
        for name, p in mod.named_parameters(recurse=False):
            lines.append("  " * depth + f"{name}: {tuple(p.shape)} = {p.numel():,}")
        for name, child in mod.named_children():
            if any(True for _ in child.parameters()):
                lines.append("  " * depth + f"{name}/")
                walk(child, depth + 1)

    walk(module, 0)
    lines.append(f"total params: {count_parameters(module):,}")
    return "\n".join(lines)
