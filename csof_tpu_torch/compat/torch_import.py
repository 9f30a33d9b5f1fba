"""Import reference nnU-Net (v1) ``Generic_UNet`` weights into the port's
``GenericUNet`` (port of ``csof_tpu/compat/torch_import.py``
``import_generic_unet_weights`` / ``load_reference_checkpoint``).

Both are torch modules, so every tensor keeps its layout (a transposed
conv's (in, out, *k) too); only the names change, 2D and 3D alike:

- ``conv_blocks_context.{d}.blocks.{i}.conv`` / ``.instnorm`` ->
  ``StackedConvs_{d}.ConvNormAct_{i}.Conv_0`` / ``.InstanceNorm_0``;
- the bottleneck ``conv_blocks_context.{num_pool}.{0,1}.blocks.{i}`` ->
  ``StackedConvs_{num_pool}.ConvNormAct_{j}`` in order;
- ``tu.{u}`` -> ``ConvTranspose_{u}`` (the reference's has no bias: the
  port's keeps its own);
- ``conv_blocks_localization.{u}.{0,1}.blocks.{i}`` ->
  ``StackedConvs_{num_pool + 1 + u}.ConvNormAct_{j}``;
- ``seg_outputs.{u}`` (deepest first) -> ``seg_head_{num_pool - 1 - u}``.

And the reference's Swin attention and blocks into the port's
:class:`~csof_tpu_torch.models.swin.WindowAttention` /
:class:`~csof_tpu_torch.models.swin.SwinBlock`
(``import_window_attention_weights``, ``import_swin_block_weights``):
``qkv`` / ``proj`` -> ``Dense_0`` / ``Dense_1`` (a torch ``Linear`` is
(out, in) on both sides), ``norm1`` / ``norm2`` -> ``LayerNorm_0`` /
``LayerNorm_1``, ``mlp.fc1`` / ``mlp.fc2`` -> ``Dense_0`` / ``Dense_1``,
and the relative position bias table into ``rel_pos_bias`` (size, heads):
``relative_position_bias_table`` has that layout, ``rpe_table`` (the MTL
model's ``WindowAttentionConvRpe``) is the same table stored (heads, size).
"""

from __future__ import annotations

import re
from collections.abc import Mapping
from pathlib import Path

import torch
from torch import nn


def _n_blocks(sd: Mapping, base: str) -> int:
    n = 0
    while f"{base}.{n}.conv.weight" in sd:
        n += 1
    return n


def _stack_sources(sd: Mapping, bases: list[str]) -> list[str]:
    return [f"{base}.{i}" for base in bases for i in range(_n_blocks(sd, base))]


def import_generic_unet_weights(state_dict: Mapping[str, torch.Tensor],
                                model: nn.Module) -> dict[str, torch.Tensor]:
    """The port ``model``'s state dict with every tensor the reference
    ``state_dict`` holds put in its place (as float32 copies); the model is
    not changed. Raises where a mapped tensor's shape differs."""
    sd = {k: torch.as_tensor(v) for k, v in state_dict.items()}
    out = {k: v.clone() for k, v in model.state_dict().items()}
    first = r"conv_blocks_context\.\d+(\.0)?\.blocks\.0\.conv\.weight"
    num_pool = sum(1 for k in sd if re.fullmatch(first, k)) - 1

    def put(dst: str, src: str) -> None:
        if tuple(sd[src].shape) != tuple(out[dst].shape):
            raise ValueError(f"{src} {tuple(sd[src].shape)} does not fit {dst} "
                             f"{tuple(out[dst].shape)}")
        out[dst] = sd[src].to(out[dst].dtype).clone()

    def stacked(name: str, sources: list[str]) -> None:
        for i, src in enumerate(sources):
            blk = f"{name}.ConvNormAct_{i}"
            for p in ("weight", "bias"):
                put(f"{blk}.Conv_0.{p}", f"{src}.conv.{p}")
                put(f"{blk}.InstanceNorm_0.{p}", f"{src}.instnorm.{p}")

    for d in range(num_pool):
        stacked(f"StackedConvs_{d}", _stack_sources(sd, [f"conv_blocks_context.{d}.blocks"]))
    stacked(f"StackedConvs_{num_pool}", _stack_sources(
        sd, [f"conv_blocks_context.{num_pool}.{sub}.blocks" for sub in (0, 1)]))
    u = 0
    while f"tu.{u}.weight" in sd:
        put(f"ConvTranspose_{u}.weight", f"tu.{u}.weight")
        if f"tu.{u}.bias" in sd:
            put(f"ConvTranspose_{u}.bias", f"tu.{u}.bias")
        stacked(f"StackedConvs_{num_pool + 1 + u}", _stack_sources(
            sd, [f"conv_blocks_localization.{u}.{sub}.blocks" for sub in (0, 1)]))
        put(f"seg_head_{num_pool - 1 - u}.weight", f"seg_outputs.{u}.weight")
        u += 1
    return out


def load_reference_checkpoint(model_file: str | Path,
                              model: nn.Module) -> dict[str, torch.Tensor]:
    """The port ``model``'s state dict with the weights of a reference
    ``model_*.model`` checkpoint (a dict holding ``state_dict``, or a bare
    state dict; DataParallel's ``module.`` prefixes stripped). The file is
    a pickle with the reference trainer's objects in it, so it loads with
    ``weights_only=False``: only files of a trusted source."""
    ckpt = torch.load(model_file, map_location="cpu", weights_only=False)
    sd = ckpt.get("state_dict", ckpt)
    sd = {k.removeprefix("module."): v for k, v in sd.items()}
    return import_generic_unet_weights(sd, model)


def _swin_put(out: dict, sd: Mapping, dst: str, src: str, transpose: bool = False) -> None:
    value = sd[src].T if transpose else sd[src]
    if tuple(value.shape) != tuple(out[dst].shape):
        raise ValueError(f"{src} {tuple(value.shape)} does not fit {dst} {tuple(out[dst].shape)}")
    out[dst] = value.to(out[dst].dtype).clone()


def _window_attention_into(out: dict, sd: Mapping, prefix: str) -> None:
    for dst, src in (("Dense_0", "qkv"), ("Dense_1", "proj")):
        for p in ("weight", "bias"):
            _swin_put(out, sd, f"{prefix}{dst}.{p}", f"{src}.{p}")
    if "relative_position_bias_table" in sd:
        _swin_put(out, sd, f"{prefix}rel_pos_bias", "relative_position_bias_table")
    else:
        _swin_put(out, sd, f"{prefix}rel_pos_bias", "rpe_table", transpose=True)


def import_window_attention_weights(state_dict: Mapping[str, torch.Tensor],
                                    model: nn.Module) -> dict[str, torch.Tensor]:
    """The port ``WindowAttention``'s state dict with a reference
    ``WindowAttention`` (``qkv``, ``proj``, ``relative_position_bias_table``)
    or ``WindowAttentionConvRpe`` (``rpe_table``) put in its place; the
    model is not changed."""
    sd = {k: torch.as_tensor(v) for k, v in state_dict.items()}
    out = {k: v.clone() for k, v in model.state_dict().items()}
    _window_attention_into(out, sd, "")
    return out


def import_swin_block_weights(state_dict: Mapping[str, torch.Tensor],
                              model: nn.Module) -> dict[str, torch.Tensor]:
    """The port ``SwinBlock``'s state dict with a reference
    ``SwinTransformerBlock`` (``norm1``, ``attn.*``, ``norm2``,
    ``mlp.fc1``, ``mlp.fc2``) put in its place; the model is not changed."""
    sd = {k: torch.as_tensor(v) for k, v in state_dict.items()}
    out = {k: v.clone() for k, v in model.state_dict().items()}
    for dst, src in (("LayerNorm_0", "norm1"), ("LayerNorm_1", "norm2"),
                     ("Dense_0", "mlp.fc1"), ("Dense_1", "mlp.fc2")):
        for p in ("weight", "bias"):
            _swin_put(out, sd, f"{dst}.{p}", f"{src}.{p}")
    attn = {k.removeprefix("attn."): v for k, v in sd.items() if k.startswith("attn.")}
    _window_attention_into(out, attn, "WindowAttention_0.")
    return out
