"""Experiment plans: the data and architecture contract of the nnU-Net path.

The ``StagePlans`` / ``Plans`` dataclasses of ``csof_tpu/config/plans.py``
with their JSON round trip, carried here so that the port never imports the
JAX package (``tests/test_torch_unet.py`` holds the two to the same files).
The legacy-pickle import is not carried.
"""

from __future__ import annotations

import json
from dataclasses import asdict, dataclass, field
from pathlib import Path
from typing import Any


@dataclass
class StagePlans:
    """Per-resolution-stage architecture and data geometry."""

    batch_size: int
    patch_size: tuple[int, ...]
    current_spacing: tuple[float, ...]
    original_spacing: tuple[float, ...]
    # one entry per downsampling step, each a per-axis stride list
    pool_op_kernel_sizes: list[list[int]]
    # one entry per resolution level (n_pool + 1), per-axis conv kernel
    conv_kernel_sizes: list[list[int]]
    do_dummy_2D_data_aug: bool = False
    median_patient_size_in_voxels: tuple[int, ...] | None = None

    @property
    def num_pool(self) -> int:
        return len(self.pool_op_kernel_sizes)

    @property
    def ndim(self) -> int:
        return len(self.patch_size)


@dataclass
class Plans:
    """Task-level plans."""

    task: str
    num_modalities: int
    num_classes: int  # foreground classes, background excluded
    all_classes: list[int]
    normalization_schemes: dict[int, str]  # per modality: "zscore" | "CT" | "CT2" | "noNorm"
    use_mask_for_norm: dict[int, bool]
    transpose_forward: tuple[int, ...]
    transpose_backward: tuple[int, ...]
    base_num_features: int = 32
    conv_per_stage: int = 2
    plans_per_stage: dict[int, StagePlans] = field(default_factory=dict)
    intensity_properties: dict[int, dict[str, float]] | None = None
    data_identifier: str = "csof"
    keep_only_largest_region: Any = None
    min_region_size_per_class: Any = None
    modalities: dict[int, str] = field(default_factory=dict)

    @property
    def num_classes_with_background(self) -> int:
        return self.num_classes + 1

    @property
    def fullres_stage_id(self) -> int:
        """Highest-resolution stage (cascade plans: {0: lowres, 1: fullres})."""
        return max(self.plans_per_stage)

    def fullres_stage(self) -> StagePlans:
        return self.plans_per_stage[self.fullres_stage_id]

    def stage(self, stage: int | None = None) -> StagePlans:
        if stage is None:
            if len(self.plans_per_stage) != 1:
                raise ValueError(
                    "stage must be given when plans contain multiple stages "
                    f"(found {sorted(self.plans_per_stage)})"
                )
            stage = next(iter(self.plans_per_stage))
        return self.plans_per_stage[stage]

    def to_json(self, path: str | Path) -> None:
        d = asdict(self)
        d["plans_per_stage"] = {str(k): v for k, v in d["plans_per_stage"].items()}
        for key in ("normalization_schemes", "use_mask_for_norm", "modalities"):
            d[key] = {str(k): v for k, v in d[key].items()}
        if d.get("intensity_properties"):
            d["intensity_properties"] = {str(k): v for k, v in d["intensity_properties"].items()}
        Path(path).write_text(json.dumps(d, indent=2, default=_jsonify))

    @classmethod
    def from_json(cls, path: str | Path) -> Plans:
        d = json.loads(Path(path).read_text())
        d["plans_per_stage"] = {
            int(k): StagePlans(**_tuplify_stage(v)) for k, v in d["plans_per_stage"].items()
        }
        for key in ("normalization_schemes", "use_mask_for_norm", "modalities"):
            d[key] = {int(k): v for k, v in d.get(key, {}).items()}
        if d.get("intensity_properties"):
            d["intensity_properties"] = {int(k): v for k, v in d["intensity_properties"].items()}
        d["transpose_forward"] = tuple(d["transpose_forward"])
        d["transpose_backward"] = tuple(d["transpose_backward"])
        return cls(**d)


def task002_heart_2d(num_classes: int = 1) -> Plans:
    """The 2d plans of nnU-Net's Task002_Heart (left atrium MRI), the geometry
    of the reference's expected epoch times: patch 320x256 at 1.25 mm in
    plane, 6 (2, 2) pools, 3x3 kernels at all 7 levels, base 32 features, one
    z-scored modality; ``num_classes`` foreground classes."""
    stage = StagePlans(batch_size=40, patch_size=(320, 256), current_spacing=(1.25, 1.25),
                       original_spacing=(1.25, 1.25), pool_op_kernel_sizes=[[2, 2]] * 6,
                       conv_kernel_sizes=[[3, 3]] * 7)
    return Plans(task="Task002_Heart", num_modalities=1, num_classes=num_classes,
                 all_classes=list(range(1, num_classes + 1)),
                 normalization_schemes={0: "zscore"}, use_mask_for_norm={0: False},
                 transpose_forward=(0, 1, 2), transpose_backward=(0, 1, 2),
                 base_num_features=32, plans_per_stage={0: stage}, modalities={0: "MRI"})


def _jsonify(o):
    import numpy as np

    if isinstance(o, np.integer):
        return int(o)
    if isinstance(o, np.floating):
        return float(o)
    if isinstance(o, np.ndarray):
        return o.tolist()
    if isinstance(o, Path):
        return str(o)
    raise TypeError(f"not JSON serializable: {type(o)}")


def _tuplify_stage(d: dict) -> dict:
    d = dict(d)
    for k in ("patch_size", "current_spacing", "original_spacing"):
        d[k] = tuple(d[k])
    if d.get("median_patient_size_in_voxels"):
        d["median_patient_size_in_voxels"] = tuple(d["median_patient_size_in_voxels"])
    return d
