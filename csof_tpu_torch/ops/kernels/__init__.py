"""Hand-written CUDA kernels for Hopper, their wrappers and plain versions.

Each wrapper counts its launches in a module global; ``launch_counts`` reads
them all under the kernels' names and ``reset_launch_counts`` zeroes them.
"""

from __future__ import annotations

import importlib

#: (name, module, counter) of each kernel's launch counter; K6_dw counts
#: calls of K6's weight-gradient pair
_COUNTERS = (("K1", "corr", "launches"), ("K2", "corr", "bwd_launches"),
             ("K3", "skipfuse", "launches"), ("K4", "ncc", "launches"),
             ("K5", "norm_act", "launches"), ("K6", "conv", "launches"),
             ("K6_dx", "conv", "bwd_launches"), ("K6_dw", "conv", "dw_launches"),
             ("K7", "norm_act", "native_launches"),
             ("K7_dx", "norm_act", "native_bwd_launches"))


def _counters():
    for name, module, counter in _COUNTERS:
        yield name, importlib.import_module(f"{__name__}.{module}"), counter


def reset_launch_counts() -> None:
    """Set every kernel wrapper's launch counter to 0."""
    for _, module, counter in _counters():
        setattr(module, counter, 0)


def launch_counts() -> dict[str, int]:
    """Launches of K1-K7 since the last ``reset_launch_counts``, by kernel."""
    return {name: getattr(module, counter) for name, module, counter in _counters()}
