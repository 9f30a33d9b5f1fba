"""Experiment planning: spacing, patch, batch and pooling, written as plans
(port of ``csof_tpu/data/planning.py``, numpy only).

The JAX planner's algorithm, step for step, so that both packages write the
same ``plans_2D.json`` and ``plans_3D.json`` from the same
``dataset_properties.pkl``: the target spacing (median; the 10th percentile
on an axis more than 3x coarser), nnU-Net's pooling schedule
(``get_pool_and_conv_props``), the shrink-the-longest-axis loop against an
activation budget, the batch grown under it, the normalization scheme per
modality, and a 3D low-resolution cascade stage when the full-resolution
patch covers under a quarter of the median volume.
"""

from __future__ import annotations

import math
from pathlib import Path

import numpy as np

from csof_tpu_torch.config.plans import Plans, StagePlans

MIN_FEATURE_MAP_SIZE = 4
MAX_NUMPOOL_3D = 5
MAX_NUMPOOL_2D = 6
DEFAULT_BATCH_3D = 2
DEFAULT_BATCH_2D = 12
MAX_FILTERS_2D = 480
MAX_FILTERS_3D = 320
ANISO_THRESHOLD = 3


def get_pool_and_conv_props(spacing, patch_size, min_feature_map_size=MIN_FEATURE_MAP_SIZE,
                            max_numpool=999):
    """Per-axis pooling and conv-kernel schedule: pool every axis whose
    current spacing is within 2x of the finest, until the feature map or
    pool-count limit; conv kernels are 3 on the largest group of mutually
    isotropic axes, else 1. Returns (pools per axis, pool kernels, conv
    kernels, the patch padded to the divisors, the divisors)."""
    dim = len(spacing)
    cur_spacing = [float(s) for s in spacing]
    cur_size = [int(p) for p in patch_size]
    pool_kernels, conv_kernels = [], []
    num_pool_per_axis = [0] * dim

    while True:
        min_sp = min(cur_spacing)
        valid = [i for i in range(dim) if cur_spacing[i] / min_sp < 2]
        axes = []
        for a in range(dim):
            partners = [i for i in range(dim)
                        if cur_spacing[i] / cur_spacing[a] < 2 and cur_spacing[a] / cur_spacing[i] < 2]
            if len(partners) > len(axes):
                axes = partners
        conv = [3 if i in axes else 1 for i in range(dim)]
        valid = [i for i in valid if cur_size[i] >= 2 * min_feature_map_size]
        valid = [i for i in valid if num_pool_per_axis[i] < max_numpool]
        if not valid:
            break
        pool = [1] * dim
        for v in valid:
            pool[v] = 2
            num_pool_per_axis[v] += 1
            cur_spacing[v] *= 2
            cur_size[v] = int(math.ceil(cur_size[v] / 2))
        pool_kernels.append(pool)
        conv_kernels.append(conv)

    conv_kernels.append([3] * dim)  # the bottleneck level
    must_divide = [2**n for n in num_pool_per_axis]
    padded = pad_shape_to_divisible(patch_size, must_divide)
    return num_pool_per_axis, pool_kernels, conv_kernels, padded, must_divide


def pad_shape_to_divisible(shape, divisors) -> list[int]:
    return [int(s) if s % d == 0 else int(s + d - s % d) for s, d in zip(shape, divisors)]


def activation_voxels(patch_size, pool_kernels, base_features, conv_per_stage,
                      max_filters) -> float:
    """The U-Net's activation volume (feature-map voxels x features, encoder
    and decoder), the quantity the planner's budget bounds."""
    size = list(patch_size)
    feats = base_features
    total = np.prod(size) * feats * conv_per_stage * 2
    for pool in pool_kernels:
        size = [int(math.ceil(s / p)) for s, p in zip(size, pool)]
        feats = min(feats * 2, max_filters)
        total += np.prod(size) * feats * conv_per_stage * 2
    return float(total)


class ExperimentPlanner:
    """2D and 3D plans from ``dataset_properties.pkl``."""

    def __init__(self, dataset_properties: dict, task: str, base_num_features: int = 32,
                 conv_per_stage: int = 2,
                 # activation budgets in voxel-features: the JAX planner's
                 # defaults, kept so that both packages write equal plans
                 # (they are not sized for any device's memory here)
                 budget_3d: float = 6.0e8, budget_2d: float = 1.6e8):
        self.props = dataset_properties
        self.task = task
        self.base_num_features = base_num_features
        self.conv_per_stage = conv_per_stage
        self.budget_3d = budget_3d
        self.budget_2d = budget_2d

    def target_spacing(self) -> np.ndarray:
        """Median spacing; an axis more than 3x coarser than the finest takes
        its 10th percentile instead."""
        spacings = np.array(self.props["all_spacings"])
        target = np.median(spacings, axis=0)
        worst = np.argmax(target)
        if target[worst] / np.min(target) > ANISO_THRESHOLD:
            target[worst] = np.percentile(spacings[:, worst], 10)
        return target

    def median_shape_at(self, spacing: np.ndarray) -> np.ndarray:
        sizes = np.array(self.props["all_sizes"], float)
        spacings = np.array(self.props["all_spacings"], float)
        new_sizes = sizes * spacings / spacing[None, :]
        return np.round(np.median(new_sizes, axis=0)).astype(int)

    def _plan_stage(self, spacing, median_shape, is_2d: bool) -> StagePlans:
        max_numpool = MAX_NUMPOOL_2D if is_2d else MAX_NUMPOOL_3D
        max_filters = MAX_FILTERS_2D if is_2d else MAX_FILTERS_3D
        budget = self.budget_2d if is_2d else self.budget_3d
        if is_2d:
            spacing = spacing[-2:]
            patch = [int(s) for s in median_shape[-2:]]
        else:
            patch = [int(s) for s in median_shape]
        patch = [max(p, 2 * MIN_FEATURE_MAP_SIZE) for p in patch]

        prev_padded = None
        while True:
            _, pools, convs, padded, must_divide = get_pool_and_conv_props(
                spacing, patch, MIN_FEATURE_MAP_SIZE, max_numpool)
            vox = activation_voxels(padded, pools, self.base_num_features,
                                    self.conv_per_stage, max_filters)
            if vox <= budget or padded == prev_padded:
                break  # under budget, or shrunk to the floor on every axis
            prev_padded = padded
            # shrink the axis largest relative to the dataset median by one
            # divisibility unit
            ref_shape = median_shape[-2:] if is_2d else median_shape
            rel = [p / m for p, m in zip(padded, ref_shape)]
            ax = int(np.argmax(rel))
            patch = list(padded)
            patch[ax] = max(patch[ax] - must_divide[ax], 2 * MIN_FEATURE_MAP_SIZE)

        batch = DEFAULT_BATCH_2D if is_2d else DEFAULT_BATCH_3D
        while vox * (batch + 1) <= budget * (3 if is_2d else 2) and batch < 64:
            batch += 1
        return StagePlans(
            batch_size=int(batch),
            patch_size=tuple(int(p) for p in padded),
            current_spacing=tuple(float(s) for s in spacing),
            original_spacing=tuple(float(s) for s in
                                   np.median(np.array(self.props["all_spacings"]), axis=0)),
            pool_op_kernel_sizes=pools,
            conv_kernel_sizes=convs,
            do_dummy_2D_data_aug=bool((not is_2d) and spacing[0] > ANISO_THRESHOLD * min(spacing)),
            median_patient_size_in_voxels=tuple(
                int(x) for x in (median_shape[-2:] if is_2d else median_shape)),
        )

    def plan(self, num_modalities: int,
             modality_names: dict[int, str] | None = None) -> dict[str, Plans]:
        """{"2d": plans, "3d": plans}; the 3D plans hold {0: lowres, 1:
        fullres} when the cascade stage is planned, else {0: fullres}."""
        spacing = self.target_spacing()
        median_shape = self.median_shape_at(spacing)
        modality_names = modality_names or {i: "MRI" for i in range(num_modalities)}
        schemes = {}
        for c in range(num_modalities):
            name = modality_names.get(c, "MRI")
            schemes[c] = "CT" if name == "CT" else ("noNorm" if name == "noNorm" else "zscore")
        # normalize inside the nonzero mask only where cropping shrank the cases notably
        avg_reduction = float(np.mean(list(self.props.get("size_reductions", {1: 1.0}).values())))
        use_mask = {c: avg_reduction < 3 / 4 for c in range(num_modalities)}

        common = dict(
            task=self.task,
            num_modalities=num_modalities,
            num_classes=len(self.props["all_classes"]),
            all_classes=[int(c) for c in self.props["all_classes"]],
            normalization_schemes=schemes,
            use_mask_for_norm=use_mask,
            transpose_forward=(0, 1, 2),
            transpose_backward=(0, 1, 2),
            base_num_features=self.base_num_features,
            conv_per_stage=self.conv_per_stage,
            intensity_properties=self.props["intensityproperties"],
            modalities=modality_names,
        )
        fullres = self._plan_stage(spacing, median_shape, is_2d=False)
        stages3d = {0: fullres}
        if np.prod(fullres.patch_size) * 4 < np.prod(median_shape):
            # the cascade's low-resolution stage: spacing coarsened
            # isotropically until the volume nears the patch
            factor = (np.prod(median_shape) / (2.0 * np.prod(fullres.patch_size))) ** (1 / 3)
            low_spacing = spacing * factor
            low_shape = self.median_shape_at(low_spacing)
            stages3d = {0: self._plan_stage(low_spacing, low_shape, is_2d=False), 1: fullres}
        plans3d = Plans(plans_per_stage=stages3d, data_identifier="csof_3D", **common)
        plans2d = Plans(plans_per_stage={0: self._plan_stage(spacing, median_shape, is_2d=True)},
                        data_identifier="csof_2D", **common)
        return {"2d": plans2d, "3d": plans3d}


def plan_and_write(dataset_properties: dict, task: str, out_dir: str | Path,
                   num_modalities: int, modality_names=None) -> dict[str, Plans]:
    """Plan and write ``plans_2D.json`` and ``plans_3D.json`` into ``out_dir``."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    plans = ExperimentPlanner(dataset_properties, task).plan(num_modalities, modality_names)
    plans["2d"].to_json(out_dir / "plans_2D.json")
    plans["3d"].to_json(out_dir / "plans_3D.json")
    return plans
