"""The benchmark of the PyTorch and CUDA port (``csof_tpu_torch``) on one card.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

run from the root of a checkout. The cell is an entry of ``workloads`` in
``BENCHMARK.json``; its configuration (``portbench/configs/<config>.json``)
and traffic mix (``portbench/traffic/<mix>.json``) are files of their own,
and the mix names the driver (``portbench/drivers/<driver>.py``) that runs
it. A run sets up (weights and inputs from the seed, a warm-up of every
shape the mix sends), measures for ``--seconds``, and with ``--trace 1``
then runs the traced slices whose records the per-layer readers
(``portbench/metrics/<metric>.py``) read. Once the window has closed it
reads the peak device memory, frees the program's state and compares what
the timed path produced with the plain reference. The last line of standard
output is the result as one JSON object; the numbers compared, each beside
its limit, are the last lines of standard error and the last key of the
result. No card, fewer cards than the cell asks for, or a module of the JAX
package loaded in the process: a non-zero exit and no result.
"""

from __future__ import annotations

import argparse
import importlib
import json
import math
import os
import sys
import time
from pathlib import Path

from portbench import harness

#: top-level modules that must not be loaded in a run, compared whole
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "csof_tpu")


def process_age_s() -> float | None:
    """Seconds since this process started (its start time in /proc, on the
    boot clock), or None where that cannot be read."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        start = int(fields[19]) / os.sysconf("SC_CLK_TCK")
        return time.clock_gettime(time.CLOCK_BOOTTIME) - start
    except (OSError, ValueError, IndexError, AttributeError):
        return None


_T_IMPORT = time.perf_counter()
_AGE_AT_IMPORT = process_age_s()


def setup_clock() -> float:
    """Seconds since the process started."""
    base = _AGE_AT_IMPORT if _AGE_AT_IMPORT is not None else 0.0
    return base + time.perf_counter() - _T_IMPORT


def forbidden_loaded() -> list[str]:
    """The forbidden top-level names among the loaded modules."""
    return sorted({m.split(".", 1)[0] for m in list(sys.modules)} & set(FORBIDDEN_MODULES))


def load_cell(root, name: str) -> tuple[dict, dict, dict, dict]:
    """(benchmark, cell, configuration, traffic mix) of workload ``name``."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; the cells are {sorted(cells)}")
    cell = cells[name]
    conf = next(c for c in bench["configs"] if c["name"] == cell["config"])
    config = json.loads((root / conf["file"]).read_text())
    traffic = json.loads((root / "portbench" / "traffic" / f"{cell['traffic']}.json").read_text())
    return bench, cell, config, traffic


def cell_metrics(bench: dict, cell: dict, trace: bool) -> list[dict]:
    """The metrics this cell reports: its end-to-end ones, or with a trace
    its per-layer ones (those listing it, or without a list those whose
    end-to-end metric it reports)."""
    def in_cell(m):
        return cell["name"] in m["workloads"] if "workloads" in m else None

    e2e = [m for m in bench["end_to_end"] if in_cell(m) is not False]
    if not trace:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if (in_cell(m) if "workloads" in m else m["moves"] in names)]


def _number(v):
    return v if isinstance(v, (int, float)) and math.isfinite(v) else None


def measure(ctx, driver) -> dict:
    """Set up, measure, trace if asked, read the peak memory, free the
    program's state and check its outputs: {"setup_s", "result",
    "memory_peak_bytes", "readings"}."""
    import torch

    cuda = ctx.device != "cpu"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    harness.set_flags(ctx.config["torch_flags"], cuda)
    state = driver.setup(ctx)
    setup_s = setup_clock()
    result = driver.window(state, ctx)
    t_window = time.perf_counter()
    if ctx.trace:
        driver.traced(state, ctx, result)
    t_traced = time.perf_counter()
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    kept = driver.free(state)
    readings = driver.check(ctx, state, kept)
    phases = {"setup": setup_s, "window": result["elapsed_s"], "traced": t_traced - t_window,
              "check": time.perf_counter() - t_traced}
    print("phases (s): " + ", ".join(f"{k} {v:.3f}" for k, v in phases.items()), file=sys.stderr)
    return {"setup_s": setup_s, "result": result, "memory_peak_bytes": peak,
            "readings": readings}


def run(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)
    root = Path.cwd()
    bench, cell, config, traffic = load_cell(root, a.workload)

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"portbench: the cell needs {cell['chips']} CUDA device(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    harness.set_env(config["env"])
    driver = importlib.import_module(f"portbench.drivers.{traffic['driver']}")
    ctx = harness.Context(a.workload, config, traffic, a.seed, a.seconds, bool(a.trace))
    out = measure(ctx, driver)
    result, setup_s, peak = out["result"], out["setup_s"], out["memory_peak_bytes"]
    correct, checks = harness.judge(out["readings"], harness.read_limits(a.workload))
    correct = correct and result["failed"] == 0

    metrics = {}
    for m in cell_metrics(bench, cell, ctx.trace):
        if m["name"] == "setup_s":
            value = setup_s
        elif ctx.trace:
            reader = importlib.import_module(f"portbench.metrics.{m['name'].split('.')[0]}")
            value = reader.read(ctx.record, m["name"])
        else:
            value = result.get(m["name"])
        if _number(value) is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": cell["chips"],
              "memory_peak_bytes": peak}
    line = {"correct": correct, "attempted": result["attempted"], "failed": result["failed"],
            "metrics": metrics, "device": device}
    if ctx.trace:
        sl = ctx.record["slice"]
        device["busy_s"], device["window_s"] = sl.busy_s(), sl.window_s
        line["breakdown"] = {"device_ops": sl.device_ops(), "idle_gaps": sl.idle_gaps()}
    found = forbidden_loaded()
    if found:
        print(f"portbench: modules of the JAX package or JAX are loaded: {found}", file=sys.stderr)
        return 3
    line["checks"] = {k: {"value": _number(v["value"]), "limit": v["limit"]}
                      for k, v in checks.items()}
    for k, v in checks.items():
        print(f"check {k} {v['value']!r} limit {v['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(run())
