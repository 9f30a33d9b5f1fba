"""The PyTorch port's SegFlow against the JAX package's, at a small size:
the same flax parameters (crossed over through load_flax_params), the same
numpy video, both corr_fuse modes the port serves."""

import dataclasses
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from csof_tpu.config.experiment import SegFlowModelConfig as JaxConfig
from csof_tpu.models.segflow import SegFlow as JaxSegFlow
from csof_tpu_torch.compat.flax_import import load_flax_params
from csof_tpu_torch.config.experiment import SegFlowModelConfig
from csof_tpu_torch.models.segflow import SegFlow
from csof_tpu_torch.ops.kernels import corr as k1
from csof_tpu_torch.ops.kernels import skipfuse as k3

SMALL = dict(out_encoder_dims=(8, 16), d_model=16, bottleneck_heads=2, dim_feedforward=32,
             corr_radius=(2, 2), corr_stride=(2, 1))
KEYS = ("seg_logits", "flow", "cum_flow", "registered")
# f32: reduction order only. bf16: the frameworks round at other points
# inside fused elementwise ops, and the difference compounds over frames.
TOL = {"float32": (5e-4, 1e-3), "bfloat16": (1e-1, 5e-2)}


def small_params(cfg: JaxConfig, seed: int = 0):
    """A flax parameter tree of the small SegFlow: structure and shapes from
    flax (``eval_shape`` of init, no compile), values drawn from a seed so
    that every leaf is non-trivial: kernels N(0, 1/fan_in), norm scales near
    1, biases near 0. Flows come out around a pixel, so the warp matters."""
    video = jax.ShapeDtypeStruct((3, 16, 16, 1), jnp.float32)
    shapes = jax.eval_shape(JaxSegFlow(cfg=cfg).init, jax.random.PRNGKey(0), video)["params"]
    rng = np.random.RandomState(seed)

    def fill(path, leaf):
        name = path[-1].key
        if name == "kernel":
            return (rng.randn(*leaf.shape) / np.sqrt(np.prod(leaf.shape[:-1]))).astype(np.float32)
        return ((name == "scale") + 0.1 * rng.randn(*leaf.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


@pytest.fixture(scope="module")
def params():
    return small_params(JaxConfig(corr_fuse="concat_cm", dtype="float32", **SMALL))


@pytest.fixture(scope="module")
def fused_params():
    """The small SegFlow's tree with attn_fused: the two bottlenecks stacked
    under bottleneck_dual."""
    return small_params(JaxConfig(corr_fuse="concat_cm", dtype="float32", attn_fused=True,
                                  **SMALL))


def _video(seed=0, b=2, t=3, hw=16):
    return np.random.RandomState(seed).rand(b, t, hw, hw, 1).astype(np.float32)


def _jax_forward(cfg_kw, params, video):
    model = JaxSegFlow(cfg=JaxConfig(**cfg_kw))
    fwd = jax.jit(lambda p, v: jax.vmap(lambda x: model.apply({"params": p}, x))(v))
    out = fwd(params, jnp.asarray(video))
    return {k: np.asarray(out[k], np.float32) for k in KEYS}


@pytest.mark.parametrize("mode,dtype", [
    ("fused_cm", "float32"), ("concat_cm", "float32"), ("fused_cm", "bfloat16"),
])
def test_segflow_matches_jax(params, mode, dtype):
    cfg_kw = dict(SMALL, corr_fuse=mode, dtype=dtype)
    video = _video()
    ref = _jax_forward(cfg_kw, params, video)
    model = SegFlow(SegFlowModelConfig(**cfg_kw), num_classes=4)
    load_flax_params(model, params)
    k1.launches = k3.launches = 0
    with torch.no_grad():
        out = model(torch.from_numpy(video))
    assert k1.launches == 0 and k3.launches == 0  # CPU tensors: plain versions
    assert out["seg_logits"].shape == (2, 3, 16, 16, 4)
    assert out["flow"].shape == out["cum_flow"].shape == (2, 3, 2, 16, 16)
    assert out["registered"].shape == (2, 3, 16, 16)
    assert float(np.abs(ref["flow"]).max()) > 0.1  # flows large enough to move the warp
    atol, rtol = TOL[dtype]
    for k in KEYS:
        np.testing.assert_allclose(out[k].float().numpy(), ref[k], atol=atol, rtol=rtol,
                                   err_msg=k)


def test_attn_fused_matches_jax(fused_params):
    """attn_fused (P1): the JAX model runs both bottlenecks as one
    pair-batched call on parameters stacked under bottleneck_dual; the port
    runs the two unfused layers on the unstacked halves, at the unfused
    tolerance."""
    step = fused_params["ScanSegFlowStep_0"]
    assert "bottleneck_dual" in step and "bottleneck_prev" not in step
    cfg_kw = dict(SMALL, corr_fuse="fused_cm", dtype="float32", attn_fused=True)
    video = _video(seed=4)
    ref = _jax_forward(cfg_kw, fused_params, video)
    model = SegFlow(SegFlowModelConfig(**cfg_kw), num_classes=4)
    load_flax_params(model, fused_params)
    with torch.no_grad():
        out = model(torch.from_numpy(video))
    assert float(np.abs(ref["flow"]).max()) > 0.1
    atol, rtol = TOL["float32"]
    for k in KEYS:
        np.testing.assert_allclose(out[k].float().numpy(), ref[k], atol=atol, rtol=rtol,
                                   err_msg=k)


@pytest.mark.parametrize("layout", ["unfused", "attn_fused"])
def test_converter_consumes_every_leaf_once_and_fills_every_parameter(request, layout):
    params = request.getfixturevalue("params" if layout == "unfused" else "fused_params")
    model = SegFlow(SegFlowModelConfig(**SMALL, attn_fused=layout == "attn_fused"),
                    num_classes=4)
    n_leaves = len(jax.tree_util.tree_leaves(params))
    step = model.ScanSegFlowStep_0
    per_bottleneck = len(list(step.bottleneck_ed.parameters()))
    # the stacked tree holds each bottleneck leaf once, for both layers
    assert n_leaves + (per_bottleneck if layout == "attn_fused" else 0) == len(
        list(model.parameters()))
    load_flax_params(model, params)
    if layout == "attn_fused":
        dual = params["ScanSegFlowStep_0"]["bottleneck_dual"]
        for i, layer in enumerate((step.bottleneck_prev, step.bottleneck_ed)):
            assert np.array_equal(layer.LayerNorm_0.weight.detach().numpy(),
                                  np.asarray(dual["LayerNorm_0"]["scale"])[i])
        short = jax.tree_util.tree_map(lambda x: x, params)
        del short["ScanSegFlowStep_0"]["bottleneck_dual"]["LayerNorm_0"]["bias"]
        # both layers miss the leaf (the message lists them sorted)
        with pytest.raises(KeyError, match=r"bottleneck_ed\.LayerNorm_0\.bias.*"
                                           r"bottleneck_prev\.LayerNorm_0\.bias"):
            load_flax_params(model, short)
    extra = dict(params, stray={"kernel": np.zeros((1, 1), np.float32)})
    with pytest.raises(KeyError, match="stray"):
        load_flax_params(model, extra)
    missing = jax.tree_util.tree_map(lambda x: x, params)
    del missing["seg_decoder"]["Conv_0"]["bias"]
    with pytest.raises(KeyError, match="seg_decoder.Conv_0.bias"):
        load_flax_params(model, missing)
    wrong = jax.tree_util.tree_map(lambda x: x, params)
    wrong["query_encoder"]["ConvNormAct_0"]["Conv_0"]["kernel"] = np.zeros((3, 3, 2, 8))
    with pytest.raises(ValueError, match="shape"):
        load_flax_params(model, wrong)


@pytest.mark.parametrize("name", ["OptimConfig", "LossWeights", "SegFlowModelConfig",
                                  "RaftModelConfig", "VoxelMorphModelConfig", "DataConfig",
                                  "ExperimentConfig"])
def test_config_mirrors_the_jax_fields_and_defaults(name):
    from csof_tpu.config import experiment as jexp
    from csof_tpu_torch.config import experiment as texp

    def fields(cls):
        return [(f.name, f.default, getattr(f.default_factory, "__name__", None))
                for f in dataclasses.fields(cls)]

    assert fields(getattr(texp, name)) == fields(getattr(jexp, name))
    assert dataclasses.asdict(getattr(texp, name)()) == dataclasses.asdict(getattr(jexp, name)())


def test_unported_modes_are_refused():
    for kw in (dict(corr_fuse="split"), dict(dec_upsample="linear"),
               dict(corr_fuse="fused_cm", norm="instance"), dict(d_model=32)):
        with pytest.raises(ValueError):
            SegFlow(SegFlowModelConfig(**dict(SMALL, **kw)))


def test_training_forward_raises_clearly():
    """fused_cm (K3) refuses gradients; concat trains, and the gradient
    reaches every parameter."""
    model = SegFlow(SegFlowModelConfig(**dict(SMALL, corr_fuse="fused_cm", dtype="float32")))
    with pytest.raises(RuntimeError, match="forward-only"):
        model(torch.from_numpy(_video(b=1)))
    model = SegFlow(SegFlowModelConfig(**dict(SMALL, corr_fuse="concat", dtype="float32")),
                    generator=torch.Generator().manual_seed(0))
    out = model(torch.from_numpy(_video(b=1)))
    (out["seg_logits"].square().mean() + out["cum_flow"].square().mean()
     + out["registered"].mean()).backward()
    assert all(p.grad is not None and bool(p.grad.abs().sum() > 0)
               for p in model.parameters())


def test_port_imports_no_jax_flax_or_yaml():
    """A fresh interpreter with jax, flax and yaml blocked imports the port
    and runs the small forward."""
    code = textwrap.dedent("""
        import sys
        sys.modules["jax"] = sys.modules["flax"] = sys.modules["yaml"] = None
        import torch
        from csof_tpu_torch.config.experiment import SegFlowModelConfig
        from csof_tpu_torch.inference.flow_predictor import FlowPredictor, predict_and_export_case
        from csof_tpu_torch.inference.serving import apply_serving_config
        from csof_tpu_torch.models.segflow import SegFlow
        from csof_tpu_torch.data.loaders import VideoChunkLoader
        from csof_tpu_torch.ops.losses import ncc_loss
        from csof_tpu_torch.training.checkpoint import save_checkpoint
        from csof_tpu_torch.training.schedules import build_optimizer
        from csof_tpu_torch.training.trainer import Trainer, make_segflow_loss
        cfg = apply_serving_config(SegFlowModelConfig(out_encoder_dims=(8, 16), d_model=16,
            bottleneck_heads=2, dim_feedforward=32, dtype="float32"), 2)
        model = SegFlow(cfg, 4, generator=torch.Generator().manual_seed(0))
        with torch.inference_mode():
            out = model(torch.rand(1, 2, 16, 16, 1))
        assert torch.isfinite(out["seg_logits"]).all()
        from csof_tpu_torch.config.plans import Plans, StagePlans
        from csof_tpu_torch.data.preprocessing import Preprocessor
        from csof_tpu_torch.inference.export import save_segmentation_from_softmax
        from csof_tpu_torch.inference.predictor import (PredictorConfig,
                                                        SlidingWindowPredictor, predict_case)
        from csof_tpu_torch.models.unet import GenericUNet, unet_from_plans
        from csof_tpu_torch.ops.kernels import conv, norm_act
        net = GenericUNet(2, base_num_features=4, pool_kernel_sizes=((2, 2),),
                          conv_kernel_sizes=((3, 3),) * 2, fused_norm_act=True,
                          conv_impl="pallas", generator=torch.Generator().manual_seed(0))
        pred = SlidingWindowPredictor(net, PredictorConfig((32, 32), 2, tile_batch=2), "cpu")
        seg, probs = pred.predict_2d_stack(torch.rand(1, 2, 40, 36).numpy())
        assert seg.shape == (2, 40, 36) and abs(probs.sum(0) - 1).max() < 1e-5
        bad = [m for m in sys.modules if m == "csof_tpu" or m.startswith("csof_tpu.")]
        assert not bad, bad
        print("ok")
    """)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=120, cwd=Path(__file__).resolve().parents[1])
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def test_generator_init_is_seeded_and_flax_like():
    cfg = SegFlowModelConfig(**SMALL)
    a = SegFlow(cfg, 4, generator=torch.Generator().manual_seed(3)).state_dict()
    b = SegFlow(cfg, 4, generator=torch.Generator().manual_seed(3)).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    # he_normal conv (fan_in 9): std sqrt(2/9); norms ones/zeros; seg head normal(1)
    w = a["query_encoder.ConvNormAct_0.Conv_0.weight"]
    assert float(w.abs().max()) <= 2 * (2 / 9) ** 0.5 / 0.8796 + 1e-6
    assert torch.equal(a["query_encoder.ConvNormAct_0.GroupNorm_0.weight"], torch.ones(8))
    assert torch.equal(a["query_encoder.ConvNormAct_0.Conv_0.bias"], torch.zeros(8))
    flow_head = a["ScanSegFlowStep_0.flow_decoder.Conv_0.weight"]
    assert float(flow_head.std()) < 1e-4
