"""Load a flax parameter tree of the JAX package into a port module.

The inverse of ``csof_tpu/compat/torch_import.py``. Port modules are named
after the flax scopes, so a leaf ``a/b/Conv_0/kernel`` fills the parameter
``a.b.Conv_0.weight``; the layout rule follows from the torch module type:

- conv ``kernel`` (*k, in, out) -> ``weight`` (out, in, *k), 2-D
  (kh, kw) or 3-D (kz, ky, kx);
- ``ConvTranspose`` ``kernel`` (*k, in, out) -> ``weight`` (in, out, *k),
  mirrored in every spatial axis (``csof_tpu/models/blocks.py:611-616``);
- Dense ``kernel`` (in, out) -> Linear ``weight`` (out, in); a
  ``DenseGeneral`` kernel split into (in, heads, head_dim) or (heads,
  head_dim, out) (flax attention) flattened first, its bias too;
- norm ``scale`` -> ``weight``; ``bias`` -> ``bias``.

A ``bottleneck_dual`` scope (SegFlow with ``attn_fused``: the two
cross-attention bottlenecks' parameters stacked on a leading axis of 2,
``csof_tpu/models/segflow.py`` ``fuse_bottleneck_params``) is first split
into ``bottleneck_prev`` (index 0) and ``bottleneck_ed`` (index 1), the
scopes of the unfused layout that the port runs.

``hoist_fuse_q_params`` moves a SegFlow ``split`` checkpoint's query convs
out of the step scope into the top-level ``fuse_q_{lvl}`` of
``fuse_q_hoist``, on a port ``state_dict``, as the JAX package's function
of that name moves them on flax variables.

A U-Net whose conv stacks JAX wrapped in ``nn.remat`` (the default for
3-D plans) holds them as ``CheckpointStackedConvs_k``; ``call_order_stacks``
gives them the port's call-order names first.

The flow models name their modules after JAX's scopes too: RAFT's
``FeatureEncoder_0``, ``FeatureEncoder_1``, ``context_encoder`` and
``Scan_RaftUpdateStep_0/UpdateBlock_0`` (``nn.scan`` with broadcast
parameters stores one copy for every iteration), VoxelMorph's
``VxmUNet_0/Conv_0..k`` and ``flow_head``, FinalFlow's ``current_encoder``,
``past_encoder``, ``fuse_{l}``, ``Scan_GRUStep_0/ConvGRUCell_0``,
``flow_decoder`` and ``st_transformer`` or ``conv3d_1`` / ``conv3d_2``; so
their trees, and the optimizer moments of RAFT's and VoxelMorph's
``TrainState``, load by the same walk. So do MTL's (``Encoder_0`` or
``SwinEncoder_0``, ``TransformerBottleneck_0``, ``seg_decoder``,
``rec_decoder``, ``df_head``), the temporal model's (``encoder``,
``bottleneck``, ``bus_read``, ``decoder``; flax's ``nn.vmap`` over frames
keeps one unbatched copy of the decoder's parameters) and the deformable
layer's (``DeformableAttention2D_0`` with ``offsets`` and ``weights``), and
the generative family's (the denoisers' ``ConvNormAct_k`` / ``Dense_k``, the
ControlNet's ``base_*`` / ``control_*``, the KL autoencoder's ``enc_i``,
``moments``, ``dec_i``, ``out``, the Swin GAN's ``stage_i`` / ``merge_i``,
the VQ-VAE's ``VectorQuantizer_0``). A parameter flax declares with
``self.param`` (Swin's ``rel_pos_bias``, the temporal ``memory_bus``, the
VQ-VAE's ``codebook``) is a torch parameter of the same name and layout.

The map is built by walking the flax tree, so flax's auto-numbered scopes
(``Dense_k``, ``LayerNorm_k``, ``GroupNorm_k``; the U-Net's
``StackedConvs_0..2n`` in call order with ``ConvNormAct_i/Conv_0`` and
``InstanceNorm_0`` inside, beside the named ``ConvTranspose_u`` and
``seg_head_level``) need no hand-written list.

``load_flax_train_state`` restores a whole flax ``TrainState`` (as
:mod:`csof_tpu_torch.compat.flax_msgpack` reads it from a JAX checkpoint)
into a port model and its :class:`csof_tpu_torch.training.schedules.Optimizer`:
the weights, the step, and the optax state of the two chains the JAX
package builds, each moment tree mapped by the same rule as the weights.
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch
from torch import nn

from csof_tpu_torch.models.blocks import Conv, ConvTranspose


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


def call_order_stacks(tree: Mapping) -> dict:
    """A U-Net tree with the conv stacks flax wrapped in ``nn.remat`` renamed
    to the port's call-order names. The JAX package's remat levels (every
    3-D plan's U-Net) are scoped ``CheckpointStackedConvs_k``, numbered apart
    from the plain ``StackedConvs_k``; the port's stacks are
    ``StackedConvs_0 .. 2n`` in call order (encoder levels 0..n, then the
    decoder's n-1..0), remat or not. JAX remats the levels below a bound,
    which the number of remat scopes gives. A tree without remat scopes is
    returned as it is."""
    remat = [k for k in tree if str(k).startswith("CheckpointStackedConvs_")]
    if not remat:
        return dict(tree)
    plain = [k for k in tree if str(k).startswith("StackedConvs_")]
    n = (len(remat) + len(plain) - 1) // 2
    levels = list(range(n + 1)) + list(range(n - 1, -1, -1))  # of the stacks in call order
    bound = next((b for b in range(n + 2) if sum(lv < b for lv in levels) == len(remat)), None)
    if bound is None or len(remat) + len(plain) != 2 * n + 1:
        raise KeyError(f"conv stacks {sorted(remat + plain)} fit no U-Net's remat levels")
    out = {k: v for k, v in tree.items() if k not in remat and k not in plain}
    seen = {"CheckpointStackedConvs": 0, "StackedConvs": 0}
    for i, level in enumerate(levels):
        kind = "CheckpointStackedConvs" if level < bound else "StackedConvs"
        out[f"StackedConvs_{i}"] = tree[f"{kind}_{seen[kind]}"]
        seen[kind] += 1
    return out


def _as_array(leaf) -> np.ndarray:
    """A float32 numpy array of a leaf (numpy, or a torch tensor such as the
    msgpack reader's bfloat16 leaves)."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().float().cpu().numpy()
    return np.asarray(leaf, dtype=np.float32)


def _convert(module: nn.Module, name: str, arr: np.ndarray) -> tuple[str, np.ndarray]:
    if name == "kernel":
        sp = tuple(range(arr.ndim - 2))  # the spatial axes of a conv kernel
        if isinstance(module, ConvTranspose):
            return "weight", np.flip(arr, sp).transpose(len(sp), len(sp) + 1, *sp)
        if isinstance(module, Conv):
            return "weight", arr.transpose(len(sp) + 1, len(sp), *sp)
        if isinstance(module, nn.Linear):  # DenseGeneral's split kernels flattened
            return "weight", arr.reshape(module.in_features, module.out_features).T
    elif name == "scale":
        return "weight", arr
    elif name == "bias":
        return "bias", arr.reshape(-1)
    elif isinstance(getattr(module, name, None), nn.Parameter):
        return name, arr  # a raw flax param (rel_pos_bias, memory_bus): the same layout
    raise KeyError(f"no rule for leaf {name!r} of a {type(module).__name__}")


def flax_to_torch_arrays(module: nn.Module, params: Mapping) -> dict[str, np.ndarray]:
    """{torch parameter name: array in the torch layout} of every leaf of the
    flax tree ``params`` (``variables["params"]``, or an optimizer moment of
    the same structure). Raises on a leaf that maps to no parameter or to a
    parameter of another shape, and on a parameter that no leaf fills."""
    targets = dict(module.named_parameters())
    out: dict[str, np.ndarray] = {}
    tree = call_order_stacks(unstack_bottleneck_dual(_map_leaves(_as_array, params)))
    for path, leaf in _leaves(tree):
        scope, name = path[:-1], path[-1]
        where = "/".join(path)
        try:
            sub = module.get_submodule(".".join(scope))
        except AttributeError as e:
            raise KeyError(f"flax leaf {where}: no torch module {'.'.join(scope)}") from e
        pname, value = _convert(sub, name, leaf)
        key = ".".join(scope + (pname,))
        if key not in targets or key in out:
            raise KeyError(f"flax leaf {where}: torch parameter {key} missing or already filled")
        if tuple(value.shape) != tuple(targets[key].shape):
            raise ValueError(f"flax leaf {where}: shape {value.shape} does not fit {key} "
                             f"{tuple(targets[key].shape)}")
        out[key] = np.ascontiguousarray(value)
    missing = sorted(set(targets) - set(out))
    if missing:
        raise KeyError(f"torch parameters no flax leaf filled: {missing}")
    return out


def load_flax_params(module: nn.Module, params: Mapping) -> None:
    """Fill every parameter of ``module`` from the flax tree ``params``
    (``variables["params"]`` with numpy leaves), with the checks of
    :func:`flax_to_torch_arrays`."""
    targets = dict(module.named_parameters())
    with torch.no_grad():
        for key, value in flax_to_torch_arrays(module, params).items():
            targets[key].copy_(torch.tensor(value))


def _node(tree: Mapping, path: tuple[str, ...], keys: set[str]) -> Mapping:
    """tree[path[0]][path[1]]..., which must be a dict with exactly ``keys``."""
    node = tree
    for i, k in enumerate(path):
        if not isinstance(node, Mapping) or k not in node:
            raise KeyError(f"optimizer state: no {'/'.join(path[:i + 1])}")
        node = node[k]
    if not isinstance(node, Mapping) or set(node) != keys:
        got = sorted(node) if isinstance(node, Mapping) else type(node).__name__
        raise KeyError(f"optimizer state {'/'.join(path)}: leaves {got} do not fit the "
                       f"expected {sorted(keys)}")
    return node


def load_flax_train_state(model: nn.Module, optimizer, state: Mapping) -> None:
    """Restore a flax ``TrainState`` state dict (``{"step", "params",
    "opt_state"}``, as ``flax.serialization.to_state_dict`` gives it and a
    JAX checkpoint stores it) into ``model`` and ``optimizer`` (the port's
    :class:`~csof_tpu_torch.training.schedules.Optimizer` over ``model``'s
    parameters):

    - ``params["params"]`` through :func:`load_flax_params`;
    - ``step`` becomes ``optimizer.count`` (the schedule's position);
    - the optax state of the JAX package's chains
      (``csof_tpu/training/schedules.py`` ``build_optimizer``):
      ``clip_by_global_norm`` -> ``adamw``: ``ScaleByAdamState`` ``mu`` /
      ``nu`` / ``count`` become AdamW's ``exp_avg`` / ``exp_avg_sq`` /
      ``step``; ``clip_by_global_norm`` -> ``add_decayed_weights`` ->
      ``sgd``: ``TraceState.trace`` becomes SGD's ``momentum_buffer``. Each
      moment goes to the parameter of its path, in the parameter's layout.

    Raises on a leaf it cannot place (another collection, another chain, a
    moment leaf without a parameter) and on a parameter nothing filled."""
    variables = state["params"]
    if set(variables) != {"params"}:
        raise KeyError(f"variable collections {sorted(variables)}: only 'params' is ported")
    load_flax_params(model, variables["params"])
    by_name = dict(model.named_parameters())
    owned = {id(p) for p in optimizer.params}
    kind = optimizer.cfg.optimizer
    opt_state = state["opt_state"]
    _node(opt_state, ("0",), set())  # clip_by_global_norm keeps no state
    if kind == "adamw":
        _node(opt_state, ("1",), {"0", "1", "2"})
        adam = _node(opt_state, ("1", "0"), {"count", "mu", "nu"})
        _node(opt_state, ("1", "1"), set())  # the decayed-weights step of adamw
        _node(opt_state, ("1", "2"), {"count"})  # the schedule's count
        count = float(np.asarray(adam["count"]))
        moments = {"exp_avg": adam["mu"], "exp_avg_sq": adam["nu"]}
    elif kind == "sgd":
        _node(opt_state, ("1",), {"0", "1"})
        _node(opt_state, ("1", "0"), set())  # add_decayed_weights keeps no state
        _node(opt_state, ("1", "1"), {"0", "1"})
        trace = _node(opt_state, ("1", "1", "0"), {"trace"})
        _node(opt_state, ("1", "1", "1"), {"count"})
        moments = {"momentum_buffer": trace["trace"]}
    else:
        raise ValueError(f"optimizer {kind!r} has no optax counterpart")
    arrays = {}
    for slot, tree in moments.items():
        if set(tree) != {"params"}:
            raise KeyError(f"optimizer moment {slot}: collections {sorted(tree)}")
        arrays[slot] = flax_to_torch_arrays(model, tree["params"])
    inner = optimizer.inner
    inner.state.clear()
    for name, p in by_name.items():
        if id(p) not in owned:
            raise KeyError(f"parameter {name} is not in the optimizer")
        slots = {slot: torch.tensor(a[name]).to(p) for slot, a in arrays.items()}
        if kind == "adamw":
            slots["step"] = torch.tensor(count)
        inner.state[p] = slots
    optimizer.count = int(np.asarray(state["step"]))


def hoist_fuse_q_params(state_dict: Mapping[str, torch.Tensor]) -> dict:
    """A SegFlow ``state_dict`` with every ``<step>.skip_fuse_{lvl}.conv_q``
    parameter moved to ``fuse_q_{lvl}`` (``csof_tpu/models/segflow.py``
    ``hoist_fuse_q_params``): the same tensors, so a ``split`` checkpoint
    loads into a ``fuse_q_hoist`` model. The input is not changed."""
    out = {}
    for key, value in state_dict.items():
        parts = key.split(".")
        if len(parts) == 4 and parts[1].startswith("skip_fuse_") and parts[2] == "conv_q":
            key = f"fuse_q_{parts[1].removeprefix('skip_fuse_')}.{parts[3]}"
        out[key] = value
    return out
