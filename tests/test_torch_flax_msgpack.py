"""The port's flax msgpack reader (``csof_tpu_torch.compat.flax_msgpack``)
against ``flax.serialization.msgpack_restore``: the bytes of small SegFlow
and U-Net ``TrainState``s of both optimizer chains, a bfloat16 leaf, flax's
chunked leaves, every msgpack integer width (packed by the ``msgpack``
package), and the errors. Arrays must be equal exactly (the same bytes)."""

import jax
import jax.numpy as jnp
import msgpack
import numpy as np
import pytest
import torch
import torch_threads
from flax import serialization
from flax.training.train_state import TrainState

from csof_tpu.config import experiment as jexp
from csof_tpu.models.segflow import SegFlow as JaxSegFlow
from csof_tpu.models.unet import GenericUNet as JaxUNet
from csof_tpu.training.schedules import build_optimizer
from csof_tpu_torch.compat import flax_msgpack
from csof_tpu_torch.compat.flax_msgpack import MsgpackError, msgpack_restore

torch_threads.pin()

SMALL_SEGFLOW = jexp.SegFlowModelConfig(out_encoder_dims=(8, 16), d_model=16, bottleneck_heads=2,
                                        dim_feedforward=32, corr_radius=(2, 2),
                                        corr_stride=(1, 1), dtype="float32")


def assert_same_tree(got, ref, where="root"):
    """Equal structure, key order and leaves; arrays equal bit for bit."""
    if isinstance(ref, dict):
        assert isinstance(got, dict) and list(got) == list(ref), where
        for k in ref:
            assert_same_tree(got[k], ref[k], f"{where}/{k}")
    elif isinstance(ref, list):
        assert isinstance(got, list) and len(got) == len(ref), where
        for i, (g, r) in enumerate(zip(got, ref)):
            assert_same_tree(g, r, f"{where}[{i}]")
    elif isinstance(ref, (np.ndarray, np.generic)) and ref.dtype == jnp.bfloat16:
        assert isinstance(got, torch.Tensor) and got.dtype == torch.bfloat16, where
        assert tuple(got.shape) == ref.shape, where
        np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                      np.asarray(ref).view(np.int16), err_msg=where)
    elif isinstance(ref, (np.ndarray, np.generic)):
        assert type(got) is type(ref) and got.dtype == ref.dtype, where
        assert np.shape(got) == np.shape(ref), where
        np.testing.assert_array_equal(got, ref, err_msg=where)
    else:
        assert type(got) is type(ref) and got == ref, where


_PARAMS = {}


def _params(model: str):
    """Flax variables of a small SegFlow or U-Net, made once: the shapes of
    the model's init, filled from a numpy seed."""
    if model not in _PARAMS:
        if model == "segflow":
            net, example = JaxSegFlow(cfg=SMALL_SEGFLOW, num_classes=4), jnp.zeros((2, 16, 16, 1))
        else:
            net = JaxUNet(num_classes=3, base_num_features=8, pool_kernel_sizes=((2, 2),) * 2,
                          conv_kernel_sizes=((3, 3),) * 3, deep_supervision=True)
            example = jnp.zeros((1, 16, 16, 1))
        shapes = jax.eval_shape(net.init, jax.random.PRNGKey(0), example)
        rng = np.random.RandomState(0)
        _PARAMS[model] = (net, jax.tree_util.tree_map(
            lambda s: jnp.asarray(rng.randn(*s.shape), s.dtype), shapes))
    return _PARAMS[model]


def _train_state(model: str, optimizer: str):
    net, params = _params(model)
    tx = build_optimizer(jexp.OptimConfig(optimizer=optimizer), 10)
    state = TrainState.create(apply_fn=net.apply, params=params, tx=tx)
    grads = jax.tree_util.tree_map(jnp.ones_like, state.params)
    # step 1: non-zero moments
    return jax.jit(lambda st, g: st.apply_gradients(grads=g))(state, grads)


@pytest.mark.parametrize("optimizer", ["adamw", "sgd"])
@pytest.mark.parametrize("model", ["segflow", "unet2d"])
def test_reader_equals_flax_on_a_train_state(model, optimizer):
    data = serialization.to_bytes(_train_state(model, optimizer))
    ref = serialization.msgpack_restore(data)
    got = msgpack_restore(data)
    assert_same_tree(got, ref)
    assert set(got) == {"step", "params", "opt_state"}


def test_bfloat16_leaves_become_torch_bfloat16():
    rng = np.random.RandomState(0)
    tree = {"w": jnp.asarray(rng.randn(3, 5), jnp.bfloat16),
            "s": jnp.asarray(1.5, jnp.bfloat16),
            "odd": jnp.asarray([np.inf, -np.inf, np.nan, -0.0, 1e-40], jnp.bfloat16)}
    data = serialization.msgpack_serialize(tree)
    got = msgpack_restore(data)
    assert_same_tree(got, serialization.msgpack_restore(data))
    assert got["s"].shape == ()


def test_chunked_leaves_are_joined(monkeypatch):
    # flax chunks arrays above MAX_CHUNK_SIZE bytes; made small on the
    # writing side only, so that small arrays are chunked
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 64)
    rng = np.random.RandomState(1)
    tree = {"big": rng.randn(7, 9).astype(np.float32),
            "nested": {"b16": jnp.asarray(rng.randn(70), jnp.bfloat16),
                       "ints": np.arange(100, dtype=np.int64).reshape(4, 25)},
            "small": np.ones(3, np.float32)}
    data = serialization.msgpack_serialize(tree)
    assert b"__msgpack_chunked_array__" in data
    monkeypatch.undo()
    got = msgpack_restore(data)
    assert_same_tree(got, serialization.msgpack_restore(data))
    np.testing.assert_array_equal(got["big"], tree["big"])


INTS = [0, 1, 127, 128, 255, 256, 65535, 65536, 2**32 - 1, 2**32, 2**64 - 1,
        -1, -32, -33, -128, -129, -32768, -32769, -2**31, -2**31 - 1, -2**63]


def test_every_integer_width_and_scalar_type():
    values = {"ints": INTS, "floats": [0.5, -2.25, 1e300], "none": None, "t": True, "f": False,
              "s": "x" * 40, "s8": "y" * 300, "s16": "z" * 70000, "b": b"\x00\xff",
              "b16": b"q" * 300, "arr16": list(range(20)), "map16": {str(i): i for i in range(20)},
              "complex": 1.5 - 2j, "np_scalar": np.float32(2.5), "i8": np.int8(-3)}
    data = serialization.msgpack_serialize(values)
    assert_same_tree(msgpack_restore(data), serialization.msgpack_restore(data))
    for v in INTS:
        assert msgpack_restore(msgpack.packb(v)) == v
    assert msgpack_restore(msgpack.packb(1.25, use_single_float=True)) == 1.25
    assert msgpack_restore(msgpack.packb(-7.5)) == -7.5
    big = {"k": list(range(70000))}  # array32
    assert msgpack_restore(msgpack.packb(big)) == big


@pytest.mark.parametrize("blob,match", [
    (msgpack.packb(msgpack.ExtType(5, b"abc")), "ext type 5"),
    (msgpack.packb([1, 2])[:-1], "truncated"),
    (msgpack.packb(1) + b"\x01", "trailing"),
    (b"\xc1", "0xc1"),
    (msgpack.packb({1: 2}), "map key"),
])
def test_bytes_outside_the_subset_raise_with_their_offset(blob, match):
    with pytest.raises(MsgpackError, match=match) as info:
        msgpack_restore(blob)
    assert "byte offset" in str(info.value)


def test_a_checkpoint_file_with_bfloat16_moments_reads_like_flax(tmp_path):
    state = _train_state("segflow", "adamw")
    state = state.replace(opt_state=jax.tree_util.tree_map(
        lambda x: x.astype(jnp.bfloat16) if x.dtype == jnp.float32 else x, state.opt_state))
    path = tmp_path / "model_final_checkpoint.msgpack"
    path.write_bytes(serialization.to_bytes(state))
    assert_same_tree(flax_msgpack.load_msgpack(path),
                     serialization.msgpack_restore(path.read_bytes()))
