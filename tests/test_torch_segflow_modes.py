"""The PyTorch port's SegFlow against the JAX package's in every configuration
the JAX ``SegFlowModelConfig`` runs beyond the served ones: the ``split``,
``project`` and ``mean1`` skip fuses, ``fuse_q_hoist`` (and its checkpoint
map), deep supervision, the linear decoder upsample and ``remat``; the
program-form knobs load and change nothing. The same flax parameters
(crossed over through load_flax_params), the same numpy video."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads
from test_torch_segflow import SMALL, TOL, _video, small_params

from csof_tpu.config.experiment import SegFlowModelConfig as JaxConfig
from csof_tpu.models.segflow import SegFlow as JaxSegFlow
from csof_tpu.models.segflow import hoist_fuse_q_params as jax_hoist
from csof_tpu_torch.compat.flax_import import hoist_fuse_q_params, load_flax_params
from csof_tpu_torch.config.experiment import SegFlowModelConfig
from csof_tpu_torch.models.segflow import SegFlow

torch_threads.pin()

#: three levels, so that the decoders have a deep-supervision head (the
#: last level has none)
DS3 = dict(SMALL, out_encoder_dims=(8, 8, 16), corr_radius=(2, 2, 2), corr_stride=(2, 1, 1))
CONFIGS = {
    "split": dict(SMALL, corr_fuse="split"),
    "split_hoist": dict(SMALL, corr_fuse="split", fuse_q_hoist=True),
    "project": dict(SMALL, corr_fuse="project"),
    "mean1": dict(SMALL, corr_fuse="mean1"),
    "deep_supervision": dict(DS3, deep_supervision=True),
    "linear": dict(SMALL, dec_upsample="linear"),
    "remat": dict(SMALL, corr_fuse="split", remat=True),
}
KEYS = ("seg_logits", "flow", "cum_flow", "registered")
#: bfloat16: the frameworks round at other points, and a flow a bf16 unit
#: apart moves the next frame's warp, so the differences compound over the
#: frames; at three levels through one more level a frame. The float32 check
#: is the one that holds the math; bf16 holds the rounding's drift: each
#: element within (atol, rtol), where the largest atol these inputs need at
#: rtol 0.1 is 0.203 (deep supervision's cum_flow, 0.246 apart at most; the
#: two-level configurations need 0.14 at most), and the mean difference of
#: each output within BF16_MEAN (0.0143 at most), which a wrong term exceeds
BF16_TOL, BF16_MEAN = (2.5e-1, 1e-1), 3e-2


def _jax_outputs(cfg_kw, params, video):
    model = JaxSegFlow(cfg=JaxConfig(**cfg_kw))
    out = jax.jit(lambda p, v: jax.vmap(lambda x: model.apply({"params": p}, x))(v))(
        params, jnp.asarray(video))
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), out)


def _port(cfg_kw, params):
    model = SegFlow(SegFlowModelConfig(**cfg_kw), num_classes=4)
    load_flax_params(model, params)
    return model


def _assert_outputs_match(out, ref, dtype):
    bf16 = dtype == "bfloat16"
    atol, rtol = BF16_TOL if bf16 else TOL[dtype]
    assert set(out) == set(ref)
    pairs = [(k, out[k], ref[k]) for k in KEYS]
    for k in ("seg_ds", "flow_ds"):
        assert len(out.get(k, ())) == len(ref.get(k, ()))
        pairs += [(f"{k}[{i}]", a, b) for i, (a, b) in enumerate(zip(out.get(k, ()),
                                                                      ref.get(k, ())))]
    for k, a, b in pairs:
        a = a.float().numpy()
        np.testing.assert_allclose(a, b, atol=atol, rtol=rtol, err_msg=k)
        if bf16:
            assert float(np.abs(a - b).mean()) <= BF16_MEAN, k


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", list(CONFIGS))
def test_configuration_matches_jax(name, dtype):
    """Forward outputs at float32 within ``test_torch_segflow.TOL``
    (reduction order), at bfloat16 within BF16_TOL and BF16_MEAN; deep
    supervision's auxiliary heads too. ``fuse_q_hoist`` runs
    on the JAX tree of the split model mapped by JAX's
    ``hoist_fuse_q_params``."""
    cfg_kw = dict(CONFIGS[name], dtype=dtype)
    if name == "split_hoist":
        split = small_params(JaxConfig(**dict(cfg_kw, fuse_q_hoist=False)))
        params = jax_hoist({"params": split})["params"]
        assert "fuse_q_0" in params and "conv_q" not in params["ScanSegFlowStep_0"]["skip_fuse_0"]
    else:
        params = small_params(JaxConfig(**cfg_kw))
    video = _video(seed=7)
    ref = _jax_outputs(cfg_kw, params, video)
    assert float(np.abs(ref["flow"]).max()) > 0.1  # flows large enough to move the warp
    model = _port(cfg_kw, params)
    with torch.no_grad():
        out = model(torch.from_numpy(video))
    _assert_outputs_match(out, ref, dtype)
    if name == "deep_supervision":
        assert len(out["seg_ds"]) == len(out["flow_ds"]) == 1
        assert out["seg_ds"][0].shape == out["seg_logits"].shape
        assert out["flow_ds"][0].shape == out["flow"].shape
        assert not out["flow_ds"][0][:, 0].any()  # frame 0's flow is the identity


def test_hoist_maps_a_port_state_dict_as_jax_maps_its_tree():
    """A split checkpoint moved into the fuse_q_hoist layout by JAX's
    ``hoist_fuse_q_params`` (on the flax tree) and by the port's (on a
    state_dict) gives the same model."""
    kw = CONFIGS["split"]
    params = small_params(JaxConfig(**kw), seed=2)
    hoisted_kw = dict(kw, fuse_q_hoist=True)
    via_jax = _port(hoisted_kw, jax_hoist({"params": params})["params"])
    via_port = SegFlow(SegFlowModelConfig(**hoisted_kw), 4)
    state = hoist_fuse_q_params(_port(kw, params).state_dict())
    via_port.load_state_dict(state)  # strict: every key moved, none left over
    ref = via_jax.state_dict()
    assert set(state) == set(ref) and all(torch.equal(ref[k], v) for k, v in state.items())
    assert "fuse_q_1.weight" in state and not any(".conv_q." in k for k in state)


@pytest.mark.parametrize("knob", [dict(scan_unroll=8), dict(scan_unroll=-1),
                                  dict(scan_while1=True), dict(scan_unroll=3, remat=True)])
def test_program_forms_load_and_change_nothing(knob):
    """``scan_unroll`` and ``scan_while1`` select the JAX package's temporal
    program form; the port loads them and computes the same outputs
    (``remat`` renames the step scope, the tree is the same otherwise)."""
    cfg = SegFlowModelConfig(**dict(SMALL, corr_fuse="concat", dtype="float32"))
    base = SegFlow(cfg, 4, generator=torch.Generator().manual_seed(1))
    other = SegFlow(dataclasses.replace(cfg, **knob), 4)
    state = base.state_dict()
    if other.step_name != base.step_name:
        state = {k.replace(base.step_name, other.step_name): v for k, v in state.items()}
    other.load_state_dict(state)
    video = torch.from_numpy(_video(seed=3, b=1))
    with torch.no_grad():
        a, b = base(video), other(video)
    for k in KEYS:
        assert torch.equal(a[k], b[k]), k


def test_remat_gradients_equal_the_plain_step():
    """``remat`` recomputes each step in the backward
    (torch.utils.checkpoint): the gradients are the plain step's."""
    kw = dict(SMALL, corr_fuse="split", dtype="float32")
    plain = SegFlow(SegFlowModelConfig(**kw), 4, generator=torch.Generator().manual_seed(4))
    remat = SegFlow(SegFlowModelConfig(**dict(kw, remat=True)), 4)
    remat.load_state_dict({k.replace("ScanSegFlowStep_0", "ScanCheckpointSegFlowStep_0"): v
                           for k, v in plain.state_dict().items()})
    video = torch.from_numpy(_video(seed=5, b=1))
    for model in (plain, remat):
        out = model(video)
        (out["cum_flow"].square().mean() + out["seg_logits"].square().mean()
         + out["registered"].mean()).backward()
    grads = {k.replace("ScanCheckpointSegFlowStep_0", "ScanSegFlowStep_0"): p.grad
             for k, p in remat.named_parameters()}
    for k, p in plain.named_parameters():
        torch.testing.assert_close(grads[k], p.grad, atol=1e-6, rtol=1e-5, msg=k)
