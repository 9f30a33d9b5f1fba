"""Preprocessor of one case: crop -> transpose -> resample -> normalize.

``Preprocessor.run_case`` / ``run_case_from_files`` of
``csof_tpu/data/preprocessing.py`` (numpy/scipy), carried here so that the
port never imports the JAX package. The folder-level ``run`` is not carried.
"""

from __future__ import annotations

import numpy as np

from csof_tpu_torch.config.plans import Plans
from csof_tpu_torch.data.cropping import crop_case
from csof_tpu_torch.ops.normalize import normalize_case
from csof_tpu_torch.ops.resample import resample_patient


class Preprocessor:
    def __init__(self, plans: Plans, stage: int = 0):
        self.plans = plans
        self.stage = stage

    def run_case(self, data: np.ndarray, seg: np.ndarray | None, properties: dict,
                 force_separate_z: bool | None = None):
        """(c, z, y, x) cropped arrays -> (data, seg, properties) resampled
        to the stage's spacing (2D plans keep z) and normalized."""
        sp = self.plans.stage(self.stage)
        tf = list(self.plans.transpose_forward[: data.ndim - 1])
        data = data.transpose([0] + [1 + i for i in tf])
        if seg is not None:
            seg = seg.transpose([0] + [1 + i for i in tf])
        original_spacing = np.array(properties["original_spacing"])[tf]
        target_spacing = np.array(sp.current_spacing)
        if len(target_spacing) == 2:
            target_spacing = np.array([original_spacing[0], *sp.current_spacing])

        data = np.nan_to_num(data)
        data, seg = resample_patient(data, seg, original_spacing, target_spacing,
                                     order_data=3, order_seg=1,
                                     force_separate_z=force_separate_z,
                                     order_z_data=0, order_z_seg=0)
        if seg is not None:
            seg[seg < -1] = 0
        properties = dict(properties)
        properties["size_after_resampling"] = data[0].shape
        properties["spacing_after_resampling"] = tuple(float(s) for s in target_spacing)
        data = normalize_case(data, self.plans.normalization_schemes,
                              self.plans.use_mask_for_norm, seg=seg,
                              intensity_properties=self.plans.intensity_properties)
        if seg is not None:
            # per-class foreground coordinates (at most 10,000, sampled) for
            # the oversampling patch sampler
            rng = np.random.RandomState(1234)
            class_locations = {}
            for c in self.plans.all_classes:
                coords = np.argwhere(seg[0] == c)
                if len(coords) > 10_000:
                    coords = coords[rng.choice(len(coords), 10_000, replace=False)]
                class_locations[int(c)] = coords
            properties["class_locations"] = class_locations
        return data, seg, properties

    def run_case_from_files(self, data_files, seg_file, force_separate_z=None):
        data, seg, properties = crop_case(data_files, seg_file)
        return self.run_case(data, seg, properties, force_separate_z)
