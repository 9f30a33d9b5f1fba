"""Load a flax parameter tree of the JAX package into a port module.

The inverse of ``csof_tpu/compat/torch_import.py``. Port modules are named
after the flax scopes, so a leaf ``a/b/Conv_0/kernel`` fills the parameter
``a.b.Conv_0.weight``; the layout rule follows from the torch module type:

- conv ``kernel`` (kh, kw, in, out) -> ``weight`` (out, in, kh, kw);
- ``ConvTranspose`` ``kernel`` (k, k, in, out) -> ``weight`` (in, out, k, k),
  mirrored in both spatial axes (``csof_tpu/models/blocks.py:611-616``);
- Dense ``kernel`` (in, out) -> Linear ``weight`` (out, in);
- norm ``scale`` -> ``weight``; ``bias`` -> ``bias``.

A ``bottleneck_dual`` scope (SegFlow with ``attn_fused``: the two
cross-attention bottlenecks' parameters stacked on a leading axis of 2,
``csof_tpu/models/segflow.py`` ``fuse_bottleneck_params``) is first split
into ``bottleneck_prev`` (index 0) and ``bottleneck_ed`` (index 1), the
scopes of the unfused layout that the port runs.

The map is built by walking the flax tree, so flax's auto-numbered scopes
(``Dense_k``, ``LayerNorm_k``, ``GroupNorm_k``; the U-Net's
``StackedConvs_0..2n`` in call order with ``ConvNormAct_i/Conv_0`` and
``InstanceNorm_0`` inside, beside the named ``ConvTranspose_u`` and
``seg_head_level``) need no hand-written list.
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch
from torch import nn

from csof_tpu_torch.models.blocks import ConvTranspose


def _leaves(tree: Mapping, prefix: tuple[str, ...] = ()):
    for key, value in tree.items():
        if isinstance(value, Mapping):
            yield from _leaves(value, prefix + (str(key),))
        else:
            yield prefix + (str(key),), value


def _map_leaves(fn, tree: Mapping) -> dict:
    return {k: _map_leaves(fn, v) if isinstance(v, Mapping) else fn(v) for k, v in tree.items()}


def unstack_bottleneck_dual(tree: Mapping) -> dict:
    """``tree`` with every ``bottleneck_dual`` subtree (leading axis 2)
    replaced by ``bottleneck_prev`` (index 0) and ``bottleneck_ed`` (index
    1); the input is not changed."""
    out = {}
    for key, value in tree.items():
        if not isinstance(value, Mapping):
            out[key] = value
        elif key != "bottleneck_dual":
            out[key] = unstack_bottleneck_dual(value)
        else:
            for i, name in enumerate(("bottleneck_prev", "bottleneck_ed")):
                if name in tree:
                    raise KeyError(f"both bottleneck_dual and {name} in one scope")

                def pick(a, i=i):
                    a = np.asarray(a)
                    if a.ndim == 0 or a.shape[0] != 2:
                        raise ValueError(f"bottleneck_dual leaf of shape {a.shape}: "
                                         "no leading pair axis of 2")
                    return a[i]

                out[name] = _map_leaves(pick, value)
    return out


def _convert(module: nn.Module, name: str, arr: np.ndarray) -> tuple[str, np.ndarray]:
    if name == "kernel":
        if isinstance(module, ConvTranspose):
            return "weight", np.flip(arr, (0, 1)).transpose(2, 3, 0, 1)
        if isinstance(module, nn.Conv2d):
            return "weight", arr.transpose(3, 2, 0, 1)
        if isinstance(module, nn.Linear):
            return "weight", arr.T
    elif name == "scale":
        return "weight", arr
    elif name == "bias":
        return "bias", arr
    raise KeyError(f"no rule for leaf {name!r} of a {type(module).__name__}")


def load_flax_params(module: nn.Module, params: Mapping) -> None:
    """Fill every parameter of ``module`` from the flax tree ``params``
    (``variables["params"]`` with numpy leaves). Raises on a leaf that maps
    to no parameter or to a parameter of another shape, and on a parameter
    that no leaf fills."""
    targets = dict(module.named_parameters())
    filled: set[str] = set()
    for path, leaf in _leaves(unstack_bottleneck_dual(params)):
        scope, name = path[:-1], path[-1]
        where = "/".join(path)
        try:
            sub = module.get_submodule(".".join(scope))
        except AttributeError as e:
            raise KeyError(f"flax leaf {where}: no torch module {'.'.join(scope)}") from e
        pname, value = _convert(sub, name, np.asarray(leaf, dtype=np.float32))
        key = ".".join(scope + (pname,))
        if key not in targets or key in filled:
            raise KeyError(f"flax leaf {where}: torch parameter {key} missing or already filled")
        target = targets[key]
        if tuple(value.shape) != tuple(target.shape):
            raise ValueError(f"flax leaf {where}: shape {value.shape} does not fit {key} "
                             f"{tuple(target.shape)}")
        with torch.no_grad():
            target.copy_(torch.from_numpy(np.ascontiguousarray(value)))
        filled.add(key)
    missing = sorted(set(targets) - filled)
    if missing:
        raise KeyError(f"torch parameters no flax leaf filled: {missing}")
