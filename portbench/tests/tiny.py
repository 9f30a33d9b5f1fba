"""Tiny CPU stand-ins of the benchmark's cells, for the tests: each cell's
configuration and mix as committed, with the sizes cut so that a run takes
seconds on the CPU. The program runs its CPU paths (the kernels' plain
versions); the check and the limits are the cell's own. ``segflow-review``
is not in ``BENCHMARK.json``: its configuration, mix, driver and limits stay
in the benchmark's files for a later cell, and are tested here."""

from __future__ import annotations

import copy
import importlib
import json
from pathlib import Path

from portbench import harness, run

ROOT = Path(__file__).resolve().parents[2]

TINY = {
    "segflow-review": (
        {"model": {"in_encoder_dims": [6, 16, 32], "out_encoder_dims": [8, 16, 32], "d_model": 32,
                   "dim_feedforward": 64}, "crop_size": 32},
        {"frames": 4, "slices": [2, 3], "per_size": 1, "height": 40, "width": 44,
         "check_sample": 2, "traced_requests": 1}),
    "unet2d-train-b40": (
        {"model": {"base_num_features": 4, "pool_op_kernel_sizes": [[2, 2]] * 3,
                   "conv_kernel_sizes": [[3, 3]] * 4, "patch_size": [32, 32], "batch_size": 4}},
        {"pool": 4}),
}


def _merge(base: dict, over: dict) -> dict:
    out = copy.deepcopy(base)
    for k, v in over.items():
        out[k] = _merge(out[k], v) if isinstance(v, dict) and isinstance(out.get(k), dict) else v
    return out


#: (configuration file, traffic mix) of the tested cells that BENCHMARK.json does not list
UNLISTED = {"segflow-review": ("portbench/configs/segflow_acdc.json", "review_one_client")}


def load(cell: str) -> tuple[dict, dict]:
    """(configuration, traffic mix) of ``cell`` as committed."""
    if cell not in UNLISTED:
        return run.load_cell(ROOT, cell)[2:]
    conf, mix = UNLISTED[cell]
    return (json.loads((ROOT / conf).read_text()),
            json.loads((ROOT / "portbench" / "traffic" / f"{mix}.json").read_text()))


def context(cell: str, seed: int = 7, seconds: float = 0.5) -> tuple[harness.Context, object]:
    """(the tiny run's context on the CPU, the cell's driver module)."""
    config, traffic = load(cell)
    conf_over, mix_over = TINY[cell]
    config, traffic = _merge(config, conf_over), _merge(traffic, mix_over)
    harness.set_env(config["env"])
    driver = importlib.import_module(f"portbench.drivers.{traffic['driver']}")
    return harness.Context(cell, config, traffic, seed, seconds, False, device="cpu"), driver


def measure(cell: str, seed: int = 7, seconds: float = 0.5) -> dict:
    """A tiny run's numbers and its verdict under the cell's limits."""
    ctx, driver = context(cell, seed, seconds)
    out = run.measure(ctx, driver)
    correct, checks = harness.judge(out["readings"], harness.read_limits(cell))
    return {**out, "correct": correct and out["result"]["failed"] == 0, "checks": checks}


if __name__ == "__main__":
    import sys

    print(json.dumps({k: v for k, v in measure(sys.argv[1]).items()
                      if k != "result"}, default=str, indent=1))
