"""Serving layer of the PyTorch port: the serving remap, the host-side
processor and NIfTI writer it carries, and FlowPredictor +
predict_and_export_case against the JAX package's on a small cine."""

import gzip

import numpy as np
import pytest
import torch_threads
from test_torch_segflow import small_params

from csof_tpu.config.experiment import SegFlowModelConfig as JaxConfig
from csof_tpu.inference import flow_predictor as jfp
from csof_tpu.inference import processor as jproc
from csof_tpu.inference import serving as jserving
from csof_tpu.models.segflow import SegFlow as JaxSegFlow
from csof_tpu.utils.nifti import load_nifti
from csof_tpu.utils.nifti import save_nifti as jsave_nifti
from csof_tpu_torch.compat.flax_import import load_flax_params
from csof_tpu_torch.config.experiment import SegFlowModelConfig
from csof_tpu_torch.inference import flow_predictor, processor, serving
from csof_tpu_torch.models.segflow import SegFlow
from csof_tpu_torch.ops.kernels import skipfuse as k3
from csof_tpu_torch.utils.nifti import save_nifti

torch_threads.pin()


@pytest.mark.parametrize("norm,mode", [
    ("group", "concat"), ("group", "concat_cm"), ("batch", "concat"), ("group", "split"),
])
def test_serving_remap_matches_jax_for_groupnorm(norm, mode):
    cfg = serving.apply_serving_config(SegFlowModelConfig(norm=norm, corr_fuse=mode), 12)
    ref = jserving.apply_serving_config(JaxConfig(norm=norm, corr_fuse=mode), 12)
    assert (cfg.corr_fuse, cfg.scan_unroll) == (ref.corr_fuse, ref.scan_unroll)
    assert serving.serving_kwargs(12) == jserving.serving_kwargs(12)


def test_instance_norm_checkpoints_keep_their_mode():
    """The JAX remap sends norm=instance to fused_cm, whose kernel only does
    GroupNorm; the port keeps concat_cm and runs K1 + the module chain."""
    cfg = serving.apply_serving_config(SegFlowModelConfig(norm="instance",
                                                          corr_fuse="concat_cm"), 12)
    assert cfg.corr_fuse == "concat_cm"
    SegFlow(SegFlowModelConfig(out_encoder_dims=(8, 16), d_model=16, norm="instance",
                               corr_fuse=cfg.corr_fuse))


def test_serve_fuse_opt_out(monkeypatch):
    monkeypatch.setenv("CSOF_SERVE_FUSE", "0")
    assert serving.apply_serving_config(SegFlowModelConfig(), 12).corr_fuse == "concat"


@pytest.mark.parametrize("hw,cs", [((40, 52), 16), ((12, 10), 16)])
def test_processor_matches_jax_package(hw, cs):
    rng = np.random.RandomState(0)
    frames = rng.rand(3, *hw).astype(np.float32)
    frames[:, 5:11, 20 % hw[1]:] += 2.0
    mine, theirs = processor.Processor(cs), jproc.Processor(cs)
    np.testing.assert_array_equal(mine.get_mask(frames[0]), theirs.get_mask(frames[0]))
    (a, ra), (b, rb) = mine.crop(frames), theirs.crop(frames)
    assert ra == rb
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(mine.uncrop(a, ra, fill=1.0), theirs.uncrop(b, rb, fill=1.0))


@pytest.mark.parametrize("dtype", [np.uint8, np.int64, np.float64, np.float32])
def test_save_nifti_writes_the_jax_package_bytes(tmp_path, dtype):
    data = (np.random.RandomState(1).rand(2, 3, 4, 5) * 9).astype(dtype)
    save_nifti(data, tmp_path / "a.nii.gz", spacing_xyz=(1.5, 1.5, 10.0))
    jsave_nifti(data, tmp_path / "b.nii.gz", spacing_xyz=(1.5, 1.5, 10.0))
    assert gzip.open(tmp_path / "a.nii.gz").read() == gzip.open(tmp_path / "b.nii.gz").read()


def test_flow_predictor_and_export_match_jax(tmp_path):
    """Serving config, TTA on, crop 16, a (T=3, D=2, 24, 28) cine."""
    small = dict(out_encoder_dims=(8, 16), d_model=16, bottleneck_heads=2, dim_feedforward=32,
                 corr_radius=(2, 2), corr_stride=(2, 1), dtype="float32")
    jcfg = jserving.apply_serving_config(JaxConfig(**small), 3)
    cfg = serving.apply_serving_config(SegFlowModelConfig(**small), 3)
    assert cfg.corr_fuse == jcfg.corr_fuse == "fused_cm"
    jmodel = JaxSegFlow(cfg=jcfg)
    params = small_params(jcfg, seed=1)
    rng = np.random.RandomState(2)
    video = rng.rand(3, 2, 24, 28).astype(np.float32)
    video[:, :, 6:18, 8:22] += 1.5  # a bright "heart" for the ROI mask
    props = {"spacing_after_resampling": (8.0, 1.25, 1.25)}

    ref = jfp.predict_and_export_case(
        jfp.FlowPredictor(lambda v: jmodel.apply({"params": params}, v), crop_size=16),
        video, props, tmp_path / "jax", "case")
    model = SegFlow(cfg, num_classes=4)
    load_flax_params(model, params)
    k3.launches = 0
    got = flow_predictor.predict_and_export_case(
        flow_predictor.FlowPredictor(model, crop_size=16, device="cpu"), video, props, tmp_path / "torch",
        "case")
    assert k3.launches == 0
    assert got["roi_record"] == ref["roi_record"]
    assert float(np.abs(ref["flow"]).max()) > 0.1
    for k, tol in (("softmax", 1e-4), ("flow", 5e-4), ("registered", 5e-4)):
        assert got[k].shape == ref[k].shape, k
        np.testing.assert_allclose(got[k], ref[k], atol=tol, rtol=1e-3, err_msg=k)
    assert (got["seg"] == ref["seg"]).mean() > 0.999
    np.testing.assert_allclose(np.load(tmp_path / "torch/Flow/case.npz")["flow"],
                               np.load(tmp_path / "jax/Flow/case.npz")["flow"], atol=5e-4)
    for sub in ("Registered", "Segmentation"):
        a = load_nifti(tmp_path / "torch" / sub / "case.nii.gz")
        b = load_nifti(tmp_path / "jax" / sub / "case.nii.gz")
        assert a.itk_spacing == b.itk_spacing
        np.testing.assert_allclose(a.data_czyx, b.data_czyx, atol=5e-4)


@pytest.mark.parametrize("name", ["split", "deep_supervision"])
def test_flow_predictor_serves_the_other_modes_as_jax(tmp_path, name):
    """The remap leaves split (its own parameter tree) as it is; a deep
    supervision model serves under fused_cm, and FlowPredictor drops its
    auxiliary heads, as the JAX package's does."""
    small = dict(out_encoder_dims=(8, 16), d_model=16, bottleneck_heads=2, dim_feedforward=32,
                 corr_radius=(2, 2), corr_stride=(2, 1), dtype="float32")
    if name == "split":
        small["corr_fuse"] = "split"
    else:
        small.update(out_encoder_dims=(8, 8, 16), corr_radius=(2, 2, 2), corr_stride=(2, 1, 1),
                     deep_supervision=True)
    jcfg = jserving.apply_serving_config(JaxConfig(**small), 3)
    cfg = serving.apply_serving_config(SegFlowModelConfig(**small), 3)
    assert cfg.corr_fuse == jcfg.corr_fuse == ("split" if name == "split" else "fused_cm")
    jmodel = JaxSegFlow(cfg=jcfg)
    params = small_params(jcfg, seed=3)
    rng = np.random.RandomState(4)
    video = rng.rand(3, 2, 24, 28).astype(np.float32)
    video[:, :, 6:18, 8:22] += 1.5
    ref = jfp.FlowPredictor(lambda v: jmodel.apply({"params": params}, v),
                            crop_size=16).predict_video(video)
    model = SegFlow(cfg, num_classes=4)
    load_flax_params(model, params)
    got = flow_predictor.FlowPredictor(model, crop_size=16, device="cpu").predict_video(video)
    assert set(got) == set(ref)
    for k, tol in (("softmax", 1e-4), ("flow", 5e-4), ("registered", 5e-4)):
        assert got[k].shape == ref[k].shape, k
        np.testing.assert_allclose(got[k], ref[k], atol=tol, rtol=1e-3, err_msg=k)


def test_flow_predictor_targets_the_card_by_default():
    predictor = flow_predictor.FlowPredictor(SegFlow(SegFlowModelConfig(
        out_encoder_dims=(8, 16), d_model=16, bottleneck_heads=2, dim_feedforward=32)))
    assert predictor.device.type == "cuda"
