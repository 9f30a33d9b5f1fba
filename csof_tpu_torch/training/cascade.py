"""The U-Net cascade: the low-resolution stage's predictions feed the
fullres stage as extra input channels (port of
``csof_tpu/training/cascade.py``).

The 3d_lowres network predicts every case of its preprocessed folder
(``preprocessed_3d_lowres/``, which ``csof_torch_plan_and_preprocess``
writes for two-stage 3D plans); each segmentation is resampled to the
fullres case's shape and saved as ``<case>_segFromPrevStage.npy``, the JAX
package's file. The fullres stage then appends the foreground classes'
one-hot maps to its input (``unet_from_plans(..., in_channels=...)``).
"""

from __future__ import annotations

from pathlib import Path
from typing import Callable

import numpy as np

from csof_tpu_torch.data.dataset import load_case
from csof_tpu_torch.ops.resample import resize_segmentation


def predict_next_stage(predict_fn: Callable[[np.ndarray], np.ndarray], dataset: dict[str, dict],
                       out_dir: str | Path,
                       target_shapes: dict[str, tuple[int, ...]] | None = None) -> Path:
    """Run ``predict_fn(data (c, *sp)) -> seg (*sp,)`` on every case of
    ``dataset`` (``load_dataset`` entries; the last channel, the
    segmentation, is dropped) and save ``<case>_segFromPrevStage.npy``
    (int8), resampled (linear, label by label) to ``target_shapes[case]``
    where given. ``predict_fn`` is typically the argmax of a
    :class:`csof_tpu_torch.inference.predictor.SlidingWindowPredictor`
    over the lowres network, on its device."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    for case, entry in dataset.items():
        data, _ = load_case(entry)
        seg = np.asarray(predict_fn(np.asarray(data[:-1])))
        if target_shapes and case in target_shapes:
            seg = resize_segmentation(seg, target_shapes[case], order=1)
        np.save(out_dir / f"{case}_segFromPrevStage.npy", seg.astype(np.int8))
    return out_dir


def load_prev_stage_onehot(prev_dir: str | Path, case: str,
                           num_classes: int) -> np.ndarray | None:
    """``(num_classes - 1, *sp)`` float32 one-hot of the foreground classes
    of the previous stage's segmentation (background dropped), or None
    where the case has no file."""
    p = Path(prev_dir) / f"{case}_segFromPrevStage.npy"
    if not p.exists():
        return None
    seg = np.load(p)
    return np.stack([(seg == c).astype(np.float32) for c in range(1, num_classes)])


def concat_prev_stage(data: np.ndarray, onehot: np.ndarray | None) -> np.ndarray:
    """``(c, *sp)`` case data with the previous stage's channels appended."""
    if onehot is None:
        return data
    if onehot.shape[1:] != data.shape[1:]:
        raise ValueError(f"prev-stage shape {onehot.shape[1:]} != data shape {data.shape[1:]}")
    return np.concatenate([data, onehot], axis=0)
