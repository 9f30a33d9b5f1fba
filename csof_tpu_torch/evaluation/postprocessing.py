"""Connected-component postprocessing (port of
``csof_tpu/evaluation/postprocessing.py``, numpy and scipy).

``determine_postprocessing`` decides, on validation pairs, whether keeping
only the largest connected component raises the mean foreground Dice: first
of the foreground union, then of each class on top of what was kept, each
step taken only where it scores strictly higher. Components are
``scipy.ndimage.label``'s with its default structure (face connectivity), so
they are the JAX package's. The decision is a JSON dict
``{"for_which_classes": [...], "dice_after": x}`` (a list entry is the
union of its classes) that ``apply_postprocessing`` applies.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
from scipy.ndimage import label as cc_label

from csof_tpu_torch.evaluation.metrics import dice


def remove_all_but_largest_component(seg: np.ndarray, for_which_classes,
                                     volume_per_voxel: float = 1.0,
                                     minimum_valid_object_size=None):
    """Keep the largest component of each entry of ``for_which_classes`` (a
    class id, or a list or tuple of ids taken as one region); the other
    components become background, unless ``minimum_valid_object_size``
    ({str(entry): size}) keeps those at least that large. Returns (seg,
    {str(entry): largest removed size}, {str(entry): kept size}). The sizes
    come from one ``bincount`` of the labels and the removal from one
    lookup, in one pass over the volume however many components there are
    (the JAX function takes a pass a component); ties for the largest keep
    the lowest label, as JAX's ``max`` over the sizes in label order does."""
    seg = seg.copy()
    largest_removed, kept_size = {}, {}
    for c in for_which_classes:
        mask = np.isin(seg, list(c)) if isinstance(c, (list, tuple)) else seg == c
        labels, n = cc_label(mask)
        if n <= 1:
            continue
        sizes = np.bincount(labels.ravel(), minlength=n + 1)[1:] * volume_per_voxel
        biggest = int(np.argmax(sizes))
        kept_size[str(c)] = sizes[biggest]
        min_sz = None
        if minimum_valid_object_size is not None:
            min_sz = minimum_valid_object_size.get(str(c))
        drop = np.ones(n, bool) if min_sz is None else sizes < min_sz
        drop[biggest] = False
        removed = 0.0
        for sz in sizes[drop]:
            removed = max(removed, sz)
        seg[np.concatenate([[False], drop])[labels] & mask] = 0
        largest_removed[str(c)] = removed
    return seg, largest_removed, kept_size


def _mean_fg_dice(preds, gts, classes) -> float:
    """Mean Dice over cases and classes, the classes absent from both
    prediction and reference (NaN) left out; 0 if none is left."""
    scores = []
    for p, g in zip(preds, gts):
        for c in classes:
            d = dice(p == c, g == c)
            if not np.isnan(d):
                scores.append(d)
    return float(np.mean(scores)) if scores else 0.0


def determine_postprocessing(pred_gt_pairs, classes, output_file: str | Path | None = None
                             ) -> dict:
    """The keep-largest-component decision over (prediction, reference)
    label pairs: the foreground union first, then each class in order, a
    step kept where it raises the mean Dice strictly. Written to
    ``output_file`` if given."""
    classes = [int(c) for c in classes if c > 0]
    gts = [g for _, g in pred_gt_pairs]
    preds = [p for p, _ in pred_gt_pairs]
    base = _mean_fg_dice(preds, gts, classes)
    decisions = []
    fg = [remove_all_but_largest_component(p, [tuple(classes)])[0] for p in preds]
    if _mean_fg_dice(fg, gts, classes) > base:
        decisions.append(tuple(classes))
        preds, base = fg, _mean_fg_dice(fg, gts, classes)
    for c in classes:
        cand = [remove_all_but_largest_component(p, [c])[0] for p in preds]
        if _mean_fg_dice(cand, gts, classes) > base:
            decisions.append(c)
            preds, base = cand, _mean_fg_dice(cand, gts, classes)
    result = {"for_which_classes": [list(d) if isinstance(d, tuple) else d for d in decisions],
              "dice_after": base}
    if output_file:
        Path(output_file).write_text(json.dumps(result, indent=2))
    return result


def apply_postprocessing(seg: np.ndarray, decision: dict) -> np.ndarray:
    """``seg`` with the decision's components removed (unchanged if none)."""
    fwc = [tuple(d) if isinstance(d, list) else d for d in decision.get("for_which_classes", [])]
    if not fwc:
        return seg
    return remove_all_but_largest_component(seg, fwc)[0]


def load_postprocessing(path: str | Path) -> dict:
    return json.loads(Path(path).read_text())
