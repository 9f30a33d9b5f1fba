"""Worker processes for the host-side data plane.

``map_in_processes`` maps a module-level, numpy-only function over jobs in
``num_workers`` processes, in the jobs' order. The workers are started by
``forkserver``: a server process started fresh (not forked), which imports
the main module once and forks each worker from itself. So a pool opened by
a process that has already used CUDA, or runs other threads, neither copies
that state, as ``fork`` would, nor touches the device; and a worker costs a
fork, not an interpreter start. The functions it maps import no torch. As
with any pool that does not fork the caller, a script that opens one must
keep its own work under ``if __name__ == "__main__":``.
"""

from __future__ import annotations

import multiprocessing
from concurrent.futures import ProcessPoolExecutor
from typing import Callable, Iterable

#: imported once by the fork server, so that no worker imports them anew
_PRELOAD = ["__main__", "csof_tpu_torch.data.analysis", "csof_tpu_torch.data.cropping",
            "csof_tpu_torch.data.preprocessing"]


def map_in_processes(fn: Callable, jobs: Iterable, num_workers: int) -> list:
    """[fn(job) for job in jobs], in ``num_workers`` worker processes when
    there is more than one worker, else in this process."""
    jobs = list(jobs)
    if num_workers <= 1 or len(jobs) <= 1:
        return [fn(j) for j in jobs]
    ctx = multiprocessing.get_context("forkserver")
    ctx.set_forkserver_preload(_PRELOAD)  # read when the server starts, the first time
    with ProcessPoolExecutor(max_workers=min(num_workers, len(jobs)), mp_context=ctx) as ex:
        return list(ex.map(fn, jobs))
