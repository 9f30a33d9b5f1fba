"""Experiment configuration: the same dataclasses, fields and defaults as
``csof_tpu/config/experiment.py`` (``OptimConfig``, ``LossWeights``,
``SegFlowModelConfig``, ``RaftModelConfig``, ``VoxelMorphModelConfig``,
``DataConfig``, ``ExperimentConfig``), without the YAML layer
(``csof_tpu.config`` imports ``yaml``, which the port does not need). Of the
model kinds only ``segflow`` is ported; the RAFT and VoxelMorph configs are
kept so that an ``ExperimentConfig`` has the same fields in both packages.

``SegFlowModelConfig`` fields the port reads: ``out_encoder_dims``,
``d_model``, ``bottleneck_heads``, ``dim_feedforward``, ``norm``,
``corr_radius``, ``corr_stride``, ``use_cost_volume``, ``corr_fuse``
(concat, concat_cm, fused_cm), ``use_gru``, ``dec_upsample`` (expand) and
``dtype``. The others are kept so that a config moves between the two
packages unchanged: the port's temporal loop is always a Python loop with the
frame-0 prime step (what the JAX package runs under ``scan_unroll > T``), and
every JAX temporal path computes the same math, so ``scan_unroll`` and
``scan_while1`` change nothing here; ``remat`` only names the step module's
scope (the trainer refuses it: rematerialisation is not ported).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Literal

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
    """Flow-model loss weights (:func:`csof_tpu_torch.training.trainer.make_segflow_loss`)."""

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
    """RAFT hyperparameters (model not ported)."""

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
    """VoxelMorph hyperparameters (model not ported)."""

    enc_features: tuple[int, ...] = (16, 32, 32, 32)
    dec_features: tuple[int, ...] = (32, 32, 32, 32, 32, 16, 16)
    int_steps: int = 7
    diffeomorphic: bool = True
    dtype: str = "bfloat16"


@dataclass
class DataConfig:
    """Video sampling (:class:`csof_tpu_torch.data.loaders.VideoChunkLoader`).
    ``do_data_aug=True`` is refused by the trainer: augmentation is not ported."""

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
    # devices per mesh axis in the JAX package; the port trains on one device
    mesh_data: int = -1
    mesh_model: int = 1
