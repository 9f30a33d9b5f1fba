"""Pick the best configuration, or pairwise ensemble, by validation Dice
(port of ``csof_tpu/evaluation/model_selection.py``, numpy).

Each configuration is scored by the mean foreground Dice of its softmax
argmax over the same validation cases; every pair of configurations, in
sorted order, is scored as ``ensemble_a+b`` (the mean softmax in the
arrays' dtype, ``sum(s) / len(s)``, whose rounding decides the argmax at
ties); the winner gets a postprocessing decision.
"""

from __future__ import annotations

import itertools
import json
from pathlib import Path

import numpy as np

from csof_tpu_torch.evaluation.metrics import dice
from csof_tpu_torch.evaluation.postprocessing import determine_postprocessing


def mean_fg_dice(pred_gt_pairs, classes) -> float:
    vals = []
    for p, g in pred_gt_pairs:
        for c in classes:
            d = dice(p == c, g == c)
            if not np.isnan(d):
                vals.append(d)
    return float(np.mean(vals)) if vals else 0.0


def ensemble_softmax(softmax_list):
    """Per case, the mean of the configurations' softmax arrays."""
    return [sum(s) / len(s) for s in zip(*softmax_list)]


def find_best_configuration(configs: dict[str, list[np.ndarray]], gts: list[np.ndarray],
                            classes, output_file: str | Path | None = None,
                            allow_ensembling: bool = True) -> dict:
    """``configs``: name -> per-case softmax arrays (C, *spatial) over the
    same validation cases; ``gts``: the per-case labels. Returns (and writes
    to ``output_file`` if given) ``{"best", "scores", "postprocessing"}``."""
    classes = [int(c) for c in classes if c > 0]
    scores: dict[str, float] = {}
    seg_sets: dict[str, list[np.ndarray]] = {}

    def score(name, softmaxes):
        seg_sets[name] = [s.argmax(0) for s in softmaxes]
        scores[name] = mean_fg_dice(list(zip(seg_sets[name], gts)), classes)

    for name, softmaxes in configs.items():
        score(name, softmaxes)
    if allow_ensembling and len(configs) > 1:
        for a, b in itertools.combinations(sorted(configs), 2):
            score(f"ensemble_{a}+{b}", ensemble_softmax([configs[a], configs[b]]))
    best = max(scores, key=scores.get)
    pp = determine_postprocessing(list(zip(seg_sets[best], gts)), classes)
    result = {"best": best, "scores": scores, "postprocessing": pp}
    if output_file:
        Path(output_file).write_text(json.dumps(result, indent=2))
    return result
