"""Torch's CPU threads in the processes that run the port's tests.

Under pytest-xdist every worker is one process among several on the same
cores. Torch's default intra-op pool (a thread a core in each process) then
makes the workers contend, and slows torch's CPU ops many times over. Each
``tests/test_torch_*.py`` calls ``pin()`` once at import: under xdist it
gives the worker its share of the cores; a single-process run keeps torch's
defaults.
"""

from __future__ import annotations

import os

import torch


def pin() -> None:
    """Under xdist, ``torch.set_num_threads(cores // workers)`` (at least
    1); otherwise nothing."""
    workers = os.environ.get("PYTEST_XDIST_WORKER_COUNT")
    if workers:
        torch.set_num_threads(max(1, len(os.sched_getaffinity(0)) // int(workers)))
