"""SegFlow model configuration: the same fields and defaults as
``csof_tpu/config/experiment.py`` ``SegFlowModelConfig``, without the YAML
layer (``csof_tpu.config`` imports ``yaml``, which the port does not need).

Fields the port reads: ``out_encoder_dims``, ``d_model``, ``bottleneck_heads``,
``dim_feedforward``, ``norm``, ``corr_radius``, ``corr_stride``,
``use_cost_volume``, ``corr_fuse`` (concat, concat_cm, fused_cm),
``use_gru``, ``dec_upsample`` (expand) and ``dtype``. The others are kept so
that a config moves between the two packages unchanged: the port's temporal
loop is always a Python loop with the frame-0 prime step (what the JAX
package runs under ``scan_unroll > T``), and every JAX temporal path
computes the same math, so ``scan_unroll``, ``scan_while1`` and ``remat``
change nothing here.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Literal


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
