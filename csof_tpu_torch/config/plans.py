"""Experiment plans: the data and architecture contract of the nnU-Net path.

The ``StagePlans`` / ``Plans`` dataclasses of ``csof_tpu/config/plans.py``
with their JSON round trip and the import of a legacy nnU-Net plans pickle,
carried here so that the port never imports the JAX package
(``tests/test_torch_unet.py`` and ``tests/test_torch_reference_import.py``
hold the two to the same plans).
"""

from __future__ import annotations

import json
import pickle
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


    @classmethod
    def from_reference_pickle(cls, path: str | Path, task: str | None = None) -> Plans:
        """Import a legacy nnU-Net ``*_plans_{2D,3D}.pkl`` (the reference's
        on-disk plans; a pickle, so only files of a trusted source)."""
        with open(path, "rb") as f:
            p = pickle.load(f)
        stages = {}
        for k, sp in p["plans_per_stage"].items():
            stages[int(k)] = StagePlans(
                batch_size=int(sp["batch_size"]),
                patch_size=tuple(int(x) for x in sp["patch_size"]),
                current_spacing=tuple(float(x) for x in sp["current_spacing"]),
                original_spacing=tuple(float(x) for x in sp["original_spacing"]),
                pool_op_kernel_sizes=[list(map(int, x)) for x in sp["pool_op_kernel_sizes"]],
                conv_kernel_sizes=[list(map(int, x)) for x in sp["conv_kernel_sizes"]],
                do_dummy_2D_data_aug=bool(sp.get("do_dummy_2D_data_aug", False)),
                median_patient_size_in_voxels=tuple(
                    int(x) for x in sp.get("median_patient_size_in_voxels", ())) or None,
            )
        return cls(
            task=task or str(p.get("dataset_properties", {}).get("task", "unknown")),
            num_modalities=int(p["num_modalities"]),
            num_classes=int(p["num_classes"]),
            all_classes=[int(c) for c in p["all_classes"]],
            normalization_schemes={int(k): v for k, v in dict(p["normalization_schemes"]).items()},
            use_mask_for_norm={int(k): bool(v) for k, v in dict(p["use_mask_for_norm"]).items()},
            transpose_forward=tuple(p.get("transpose_forward", (0, 1, 2))),
            transpose_backward=tuple(p.get("transpose_backward", (0, 1, 2))),
            base_num_features=int(p.get("base_num_features", 32)),
            conv_per_stage=int(p.get("conv_per_stage", 2)),
            plans_per_stage=stages,
            intensity_properties=p.get("dataset_properties", {}).get("intensityproperties"),
            modalities={int(k): v for k, v in dict(p.get("modalities", {})).items()},
        )


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


def task002_heart_3d(num_classes: int = 1) -> Plans:
    """The 3d_fullres plans of nnU-Net's Task002_Heart, the geometry the JAX
    package's epoch benchmark builds (``tools/bench_epoch.py``): patch
    80x192x160 at 1.37 x 1.25 x 1.25 mm, batch 2, base 32 features (capped
    at 320), pools (1, 2, 2), 3 x (2, 2, 2), (1, 2, 2), kernels (1, 3, 3)
    then (3, 3, 3) at the 5 deeper levels, one z-scored modality;
    ``num_classes`` foreground classes. nnU-Net v1's planner
    (:func:`csof_tpu_torch.data.planning.get_pool_and_conv_props`) gives
    this spacing (3, 3, 3) kernels at every level and pools 4 x (2, 2, 2)
    then (1, 2, 2): level 0 here departs from it."""
    spacing = (1.37, 1.25, 1.25)
    stage = StagePlans(batch_size=2, patch_size=(80, 192, 160), current_spacing=spacing,
                       original_spacing=spacing,
                       pool_op_kernel_sizes=[[1, 2, 2], [2, 2, 2], [2, 2, 2], [2, 2, 2], [1, 2, 2]],
                       conv_kernel_sizes=[[1, 3, 3]] + [[3, 3, 3]] * 5)
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
