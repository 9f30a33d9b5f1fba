"""Experiment configuration: the same dataclasses, fields and defaults as
``csof_tpu/config/experiment.py`` (``OptimConfig``, ``LossWeights``,
``SegFlowModelConfig``, ``RaftModelConfig``, ``VoxelMorphModelConfig``,
``DataConfig``, ``ExperimentConfig``), and its YAML layer:
``ExperimentConfig.to_yaml`` writes the bytes the JAX package's writes, and
``from_dict`` / ``load_experiment_config`` nest, turn lists into tuples and
refuse unknown keys as it does. YAML goes through
:mod:`csof_tpu_torch.utils.yaml_subset`, the port's reader and writer of
the subset configs use, so the port needs no PyYAML.

The port trains every model kind: ``segflow``, ``unet2d``, ``unet3d``,
``raft`` and ``voxelmorph``. Every ``SegFlowModelConfig`` field is
read: each ``corr_fuse`` mode (``fused_cm`` for serving only, as in JAX),
``fuse_q_hoist``, ``deep_supervision``, both ``dec_upsample`` modes, and
``remat`` (``torch.utils.checkpoint``). The port's temporal loop is always a
Python loop with the frame-0 prime step, and every JAX temporal path
computes the same math, so ``scan_unroll``, ``scan_while1`` and
``attn_fused`` (the two bottlenecks run unfused) change nothing but the
program form. So does ``RaftModelConfig.scan_unroll``: the port's RAFT
runs the same refinement loop for any value, -1 included, which the JAX
package's ``lax.scan`` refuses (ROADMAP fault F4).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Literal

from csof_tpu_torch.utils import yaml_subset

ModelKind = Literal["unet2d", "unet3d", "raft", "voxelmorph", "segflow"]


@dataclass
class OptimConfig:
    """Optimizer and learning-rate schedule (:mod:`csof_tpu_torch.training.schedules`)."""

    optimizer: Literal["adamw", "sgd"] = "adamw"
    scheduler: Literal["cosine", "poly", "constant"] = "cosine"
    initial_lr: float = 1e-4
    weight_decay: float = 1e-4
    warmup_percent: float = 0.1
    sgd_momentum: float = 0.99
    nesterov: bool = True
    poly_exponent: float = 0.9
    eta_min: float = 1e-7
    grad_clip_norm: float = 12.0
    # if the online foreground dice is still 0 at this epoch, SGD momentum
    # drops to momentum_rescue_value and the weights are drawn anew; 0 disables
    momentum_rescue_epoch: int = 100
    momentum_rescue_value: float = 0.95


@dataclass
class LossWeights:
    """Flow-model loss weights (:mod:`csof_tpu_torch.training.trainer`'s
    SegFlow, VoxelMorph and RAFT losses)."""

    image_flow_global: float = 0.5      # NCC(warped, fixed)
    regularization_xy: float = 1.0      # spatial flow-gradient^2
    regularization_z: float = 0.0       # temporal flow-gradient^2
    seg_registered: float = 0.0         # Dice(warp(seg_ES), seg_ED)
    segmentation: float = 0.0           # supervised seg loss on labeled frames
    cycle_flow: float = 0.0
    cycle_registered: float = 0.0
    global_motion_forward: float = 0.01
    raft_sequence_gamma: float = 0.8


@dataclass(frozen=True)
class SegFlowModelConfig:
    """Joint seg+flow video model hyperparameters."""

    in_encoder_dims: tuple[int, ...] = (6, 64, 128)
    out_encoder_dims: tuple[int, ...] = (32, 64, 128)
    d_model: int = 128
    bottleneck_heads: int = 4
    nb_layers: int = 1
    dim_feedforward: int = 1024
    norm: Literal["group", "batch", "instance"] = "group"
    activation: str = "gelu"
    conv_depth: tuple[int, ...] = (1, 1, 1)
    corr_radius: tuple[int, ...] = (4, 4, 4)
    corr_stride: tuple[int, ...] = (2, 1, 1)
    use_cost_volume: bool = True
    corr_fuse: Literal[
        "concat", "split", "project", "mean1", "concat_cm", "fused_cm"
    ] = "concat"
    fuse_q_hoist: bool = False
    attn_fused: bool = False
    use_gru: bool = True
    dec_upsample: Literal["expand", "linear"] = "expand"
    deep_supervision: bool = False
    kernel_size: int = 3
    pos_1d: Literal["sin", "learn"] = "sin"
    backward_flow: bool = True
    remat: bool = False
    scan_unroll: int = 1
    scan_while1: bool = False
    dtype: str = "bfloat16"


@dataclass(frozen=True)
class RaftModelConfig:
    """RAFT hyperparameters (:class:`csof_tpu_torch.models.raft.RAFT`);
    ``scan_unroll`` is a program form of the JAX package, read and unused."""

    iters: int = 12
    corr_levels: int = 4
    corr_radius: int = 4
    hidden_dim: int = 128
    context_dim: int = 128
    feature_dim: int = 256
    dtype: str = "bfloat16"
    scan_unroll: int = 1


@dataclass(frozen=True)
class VoxelMorphModelConfig:
    """VoxelMorph hyperparameters
    (:class:`csof_tpu_torch.models.voxelmorph.VoxelMorph`)."""

    enc_features: tuple[int, ...] = (16, 32, 32, 32)
    dec_features: tuple[int, ...] = (32, 32, 32, 32, 32, 16, 16)
    int_steps: int = 7
    diffeomorphic: bool = True
    dtype: str = "bfloat16"


@dataclass
class DataConfig:
    """Video sampling (:class:`csof_tpu_torch.data.loaders.VideoChunkLoader`);
    ``do_data_aug`` runs :mod:`csof_tpu_torch.data.augment` inside the train
    step, on the device, for ``unet2d`` and ``segflow``."""

    video_length: int = 6
    batch_size: int = 1
    image_size: int = 224
    crop_size: int = 128
    do_data_aug: bool = True
    oversample_foreground_percent: float = 0.33
    num_workers: int = 4


@dataclass
class ExperimentConfig:
    model: ModelKind = "segflow"
    task: str = "Task027_ACDC"
    fold: int = 0
    max_num_epochs: int = 180
    num_batches_per_epoch: int = 250
    num_val_batches_per_epoch: int = 50
    deep_supervision: bool = True
    seed: int = 12345
    optim: OptimConfig = field(default_factory=OptimConfig)
    loss_weights: LossWeights = field(default_factory=LossWeights)
    segflow: SegFlowModelConfig = field(default_factory=SegFlowModelConfig)
    raft: RaftModelConfig = field(default_factory=RaftModelConfig)
    voxelmorph: VoxelMorphModelConfig = field(default_factory=VoxelMorphModelConfig)
    data: DataConfig = field(default_factory=DataConfig)
    # ranks per mesh axis under a process group (csof_tpu_torch.parallel.mesh)
    mesh_data: int = -1
    mesh_model: int = 1

    def to_yaml(self, path: str | Path) -> None:
        """Write the config as ``yaml.safe_dump(asdict(self), sort_keys=False)``
        writes it, byte for byte."""
        Path(path).write_text(yaml_subset.safe_dump(dataclasses.asdict(self)))

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "ExperimentConfig":
        return _from_dict(cls, d)


def _from_dict(cls, d: dict[str, Any]):
    if not dataclasses.is_dataclass(cls):
        return d
    names = {f.name: f for f in dataclasses.fields(cls)}
    unknown = set(d) - set(names)
    if unknown:
        raise KeyError(f"unknown config keys for {cls.__name__}: {sorted(unknown)}")
    kwargs = {}
    for k, v in d.items():
        f = names[k]
        if dataclasses.is_dataclass(f.type) or (isinstance(f.type, str) and f.type in _NESTED):
            sub = _NESTED[f.type] if isinstance(f.type, str) else f.type
            kwargs[k] = _from_dict(sub, v) if isinstance(v, dict) else v
        elif isinstance(v, list):
            kwargs[k] = tuple(v)
        else:
            kwargs[k] = v
    return cls(**kwargs)


_NESTED = {
    "OptimConfig": OptimConfig,
    "LossWeights": LossWeights,
    "SegFlowModelConfig": SegFlowModelConfig,
    "RaftModelConfig": RaftModelConfig,
    "VoxelMorphModelConfig": VoxelMorphModelConfig,
    "DataConfig": DataConfig,
}


def load_experiment_config(path: str | Path) -> ExperimentConfig:
    """Read a YAML experiment config (as the JAX package's ``yaml.safe_load``
    reads it, for the subset configs use)."""
    d = yaml_subset.safe_load(Path(path).read_text()) or {}
    return ExperimentConfig.from_dict(d)
