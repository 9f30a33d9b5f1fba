"""The readings the limits of ``portbench/limits/<cell>.json`` are set from.

    python3 -m portbench.control --workload <cell> --seeds A-B [--control-seeds C-D]

On a card, at the cell's own sizes, one process: for each seed of
``--seeds`` the program's set-up and then what the check compares (the
serving cell: the predictor's outputs of a seeded sample of the pool with a
deepest study among them; the training cell: its first steps), judged
against the plain reference as a run judges it: the lower readings. For
each seed of ``--control-seeds`` the control judged the same way, the
reference in the precision below the configuration's put in the program's
place (serving: fp8 operands; training: TF32), and for the training cell the
planted half-batch fault too: the upper readings. One JSON line a seed on
standard output. The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import importlib
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

from portbench import generator, harness, run


def seed_range(text: str) -> list[int]:
    lo, _, hi = text.partition("-")
    return list(range(int(lo), int(hi or lo) + 1))


def serving_picks(state, seed: int, k: int) -> list[int]:
    rng = np.random.default_rng(generator.child_seed(seed, "control"))
    deepest = next(i for i, (v, _) in enumerate(state.pool) if v.shape[1] == state.max_depth)
    others = [i for i in range(len(state.pool)) if i != deepest]
    chosen = rng.choice(others, size=min(k, len(others)), replace=False)
    return [deepest, *(int(i) for i in chosen)]


def one_seed(ctx, driver, with_control: bool) -> dict:
    t0 = time.perf_counter()
    harness.set_flags(ctx.config["torch_flags"])
    state = driver.setup(ctx)
    row = {"seed": ctx.seed, "setup_s": time.perf_counter() - t0}
    if ctx.traffic["driver"] == "closed_loop_studies":
        picks = serving_picks(state, ctx.seed, ctx.traffic["check_sample"])
        state.kept = [(i, state.predictor.predict_video(*state.pool[i])) for i in picks]
        row["program"] = driver.check(ctx, state, driver.free(state))
        if with_control:
            row["control"] = driver.control(ctx, state, picks)
    else:
        row["program"] = driver.check(ctx, state, driver.free(state))
        if with_control:
            row["control"] = driver.control(ctx, state)
            row["half_batch"] = driver.half_batch_fault(ctx, state)
    harness.free_device()
    row["seconds"] = time.perf_counter() - t0
    return row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("portbench.control: no CUDA device", file=sys.stderr)
        return 2
    _, _, config, traffic = run.load_cell(Path.cwd(), a.workload)
    harness.set_env(config["env"])
    driver = importlib.import_module(f"portbench.drivers.{traffic['driver']}")
    controls = set(seed_range(a.control_seeds)) if a.control_seeds else set()
    for seed in sorted(set(seed_range(a.seeds)) | controls):
        ctx = harness.Context(a.workload, config, traffic, seed, 0.0, False)
        print(json.dumps(one_seed(ctx, driver, seed in controls)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
