"""Fold validation: predict every validation case, export, score (port of
``csof_tpu/training/validation.py``): the fold's validation split predicted
from its preprocessed arrays by the port's ``SlidingWindowPredictor``,
written as NIfTI in the original geometry, and scored per case and on the
mean into ``summary.json``.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

from csof_tpu_torch.config.plans import Plans
from csof_tpu_torch.data.dataset import do_split, load_case, load_dataset
from csof_tpu_torch.evaluation.evaluator import evaluate_case
from csof_tpu_torch.inference.export import save_segmentation_from_softmax
from csof_tpu_torch.inference.predictor import (
    PredictorConfig,
    SlidingWindowPredictor,
    serving_tile_batch,
)


def validate_fold(trainer, plans: Plans, preprocessed_dir: str | Path, fold: int,
                  output_folder: str | Path, step_size: float = 0.5, do_mirroring: bool = True,
                  splits_file: str | Path | None = None) -> dict:
    """trainer: an initialised or restored port ``Trainer`` of a U-Net, on
    its device."""
    output_folder = Path(output_folder)
    output_folder.mkdir(parents=True, exist_ok=True)
    ds = load_dataset(preprocessed_dir)
    _, val_keys = do_split(list(ds), fold, splits_file=splits_file)
    sp = plans.fullres_stage()
    net = trainer.model.eval()
    predictor = SlidingWindowPredictor(
        net, PredictorConfig(patch_size=tuple(sp.patch_size),
                             num_classes=plans.num_classes_with_background,
                             step_size=step_size, do_mirroring=do_mirroring,
                             tile_batch=serving_tile_batch(sp.patch_size)),
        device=trainer.device)

    all_scores = []
    for case in val_keys:
        data, props = load_case(ds[case])
        data = np.asarray(data)
        img, seg_gt = data[: plans.num_modalities], data[-1]
        if len(sp.patch_size) == 2:
            seg, softmax = predictor.predict_2d_stack(img)
        else:
            seg, softmax = predictor.predict(img)
        save_segmentation_from_softmax(softmax, output_folder / f"{case}.nii.gz", props)
        scores = evaluate_case(seg, np.maximum(seg_gt, 0), plans.all_classes, surface=True)
        scores["case"] = case
        all_scores.append(scores)

    mean = {}
    for c in plans.all_classes:
        key = str(int(c))
        mean[key] = {
            m: float(np.nanmean([s[key][m] for s in all_scores if np.isfinite(s[key][m])]
                                or [np.nan]))
            for m in all_scores[0][key]
        }
    summary = {"all": all_scores, "mean": mean}
    (output_folder / "summary.json").write_text(json.dumps(summary, indent=2, default=float))
    return summary
