"""The port's nnU-Net 2D inference path against the JAX package's, on the
CPU at a small size (47 s on one core with a cold JAX compile cache).

The host modules it carries (plans, padding, tiling, resampling,
normalization, cropping, NIfTI reading, preprocessing, export) must give the
same arrays and files. K5 and K6's plain versions are held against the JAX
Pallas kernels in interpret mode, and the U-Net, the sliding-window
predictor and ``predict_case`` against the JAX package with the same flax
parameters and both of its kernel switches on (``CSOF_FUSED_NORM=1``,
``CSOF_CONV2D_IMPL=pallas``), as the JAX package's own kernel tests run
them. Tolerances: float32 differs by the order of float32 sums only (1e-4
absolute on logits); bfloat16 by a few bf16 ulps (2^-8 relative each), since
the two frameworks round the same float32 values at other points.
"""

import dataclasses
import gzip

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from csof_tpu.config import plans as jplans
from csof_tpu.data import cropping as jcrop
from csof_tpu.data.preprocessing import Preprocessor as JaxPreprocessor
from csof_tpu.inference import export as jexport
from csof_tpu.inference.predictor import PredictorConfig as JaxPredictorConfig
from csof_tpu.inference.predictor import SlidingWindowPredictor as JaxPredictor
from csof_tpu.models.unet import GenericUNet as JaxUNet
from csof_tpu.models.unet import unet_from_plans as jax_unet_from_plans
from csof_tpu.ops import normalize as jnorm
from csof_tpu.ops import padcrop as jpad
from csof_tpu.ops import resample as jres
from csof_tpu.ops import sliding_window as jsw
from csof_tpu.ops.pallas.conv import conv3x3_cols
from csof_tpu.ops.pallas.norm_act import instance_norm_leaky_relu_pallas
from csof_tpu.utils import nifti as jnifti
from csof_tpu_torch.compat.flax_import import load_flax_params
from csof_tpu_torch.config import plans as tplans
from csof_tpu_torch.config.plans import Plans, StagePlans
from csof_tpu_torch.data import cropping
from csof_tpu_torch.data.preprocessing import Preprocessor
from csof_tpu_torch.inference import export
from csof_tpu_torch.inference.predictor import (
    PredictorConfig,
    SlidingWindowPredictor,
    predict_case,
)
from csof_tpu_torch.models.unet import GenericUNet, unet_from_plans
from csof_tpu_torch.ops import normalize, padcrop, resample
from csof_tpu_torch.ops import sliding_window as sw
from csof_tpu_torch.ops.kernels import conv as k6
from csof_tpu_torch.ops.kernels import norm_act as k5
from csof_tpu_torch.utils import nifti

SMALL = dict(num_classes=3, base_num_features=8, pool_kernel_sizes=((2, 2), (2, 2)),
             conv_kernel_sizes=((3, 3),) * 3)
PATCH = (64, 64)
UNET_TOL = {"float32": (1e-4, 1e-4), "bfloat16": (6e-2, 2e-2)}
PROB_TOL = (1e-5, 1e-5)  # softmax of float32 logits that agree to 1e-4


@pytest.fixture
def switches_on(monkeypatch):
    monkeypatch.setenv("CSOF_FUSED_NORM", "1")
    monkeypatch.setenv("CSOF_CONV2D_IMPL", "pallas")


def _plans(module, patch=PATCH, spacing=(1.25, 1.25), pools=((2, 2), (2, 2))):
    """Small 2D plans of the JAX package's (``module`` = jplans) or the
    port's config module; three classes with background."""
    stage = module.StagePlans(batch_size=2, patch_size=tuple(patch),
                              current_spacing=spacing, original_spacing=spacing,
                              pool_op_kernel_sizes=[list(p) for p in pools],
                              conv_kernel_sizes=[[3, 3]] * (len(pools) + 1))
    return module.Plans(task="Task002_Heart", num_modalities=1, num_classes=2,
                        all_classes=[1, 2], normalization_schemes={0: "zscore"},
                        use_mask_for_norm={0: False}, transpose_forward=(0, 1, 2),
                        transpose_backward=(0, 1, 2), base_num_features=8,
                        plans_per_stage={0: stage})


def _flax_params(net, seed=0):
    """Flax parameters of ``net``: shapes from ``eval_shape`` of init (no
    compile), values from a seed, every leaf non-trivial."""
    x = jax.ShapeDtypeStruct((1, *PATCH, 1), jnp.float32)
    shapes = jax.eval_shape(net.init, jax.random.PRNGKey(0), x)["params"]
    rng = np.random.RandomState(seed)

    def fill(path, leaf):
        name = path[-1].key
        if name == "kernel":
            return (rng.randn(*leaf.shape) / np.sqrt(np.prod(leaf.shape[:-1]))).astype(np.float32)
        return ((name == "scale") + 0.1 * rng.randn(*leaf.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


@pytest.fixture(scope="module")
def params():
    return _flax_params(JaxUNet(**SMALL))


def _port_unet(params, dtype=torch.float32, **kw):
    net = GenericUNet(in_channels=1, dtype=dtype, fused_norm_act=True, conv_impl="pallas",
                      **SMALL, **kw)
    load_flax_params(net, params)
    return net.eval()


# -- host modules ----------------------------------------------------------


def test_plans_json_round_trip_both_ways(tmp_path):
    mine, theirs = _plans(tplans), _plans(jplans)
    mine.intensity_properties = {0: {"mean": 1.0, "sd": 2.0}}
    theirs.intensity_properties = {0: {"mean": 1.0, "sd": 2.0}}
    mine.to_json(tmp_path / "a.json")
    theirs.to_json(tmp_path / "b.json")
    assert (tmp_path / "a.json").read_text() == (tmp_path / "b.json").read_text()
    back = Plans.from_json(tmp_path / "b.json")
    theirs_back = jplans.Plans.from_json(tmp_path / "a.json")
    assert dataclasses.asdict(back) == dataclasses.asdict(theirs_back)
    assert isinstance(back.plans_per_stage[0], StagePlans)
    assert back.fullres_stage().patch_size == PATCH


@pytest.mark.parametrize("shape,new", [
    ((1, 5, 7), (9, 8)), ((2, 3, 10, 11), (3, 16, 16)), ((1, 20, 30), (20, 17)),
])
def test_pad_nd_image_matches(shape, new):
    img = np.random.RandomState(0).rand(*shape).astype(np.float32)
    a, sa = padcrop.pad_nd_image(img, new)
    b, sb = jpad.pad_nd_image(img, new, return_slicer=True)
    np.testing.assert_array_equal(a, b)
    assert sa == sb


@pytest.mark.parametrize("patch,image", [
    ((320, 256), (320, 320)), ((64, 64), (80, 72)), ((16, 16), (40, 52)),
    ((8, 16, 16), (10, 20, 33)),
])
def test_tiling_math_matches_exactly(patch, image):
    assert sw.compute_steps(patch, image, 0.5) == jsw.compute_steps(patch, image, 0.5)
    bucket = sw.bucket_image_shape(image, patch, 0.5, 32)
    assert bucket == jsw.bucket_image_shape(image, patch, 0.5, 32)
    grid = sw.step_grid(patch, bucket, 0.5)
    np.testing.assert_array_equal(grid, jsw.step_grid(patch, bucket, 0.5))
    assert grid.dtype == np.int32
    g = sw.gaussian_importance_map(tuple(patch))
    np.testing.assert_array_equal(g, jsw.gaussian_importance_map(tuple(patch)))


@pytest.mark.parametrize("spacing,target,separate", [
    ((10.0, 1.0, 1.0), (10.0, 1.25, 1.25), None), ((2.0, 1.0, 1.5), (1.5, 1.5, 1.5), None),
    ((5.0, 1.0, 1.0), (2.5, 1.0, 1.0), None), ((1.0, 1.0, 1.0), (1.0, 0.8, 1.2), True),
])
def test_resample_patient_matches(spacing, target, separate):
    rng = np.random.RandomState(1)
    data = rng.rand(1, 5, 14, 12).astype(np.float32)
    seg = rng.randint(-1, 3, (1, 5, 14, 12)).astype(np.float32)
    a = resample.resample_patient(data, seg, spacing, target, 3, 1, separate)
    b = jres.resample_patient(data, seg, spacing, target, 3, 1, separate)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("scheme,masked", [("zscore", False), ("zscore", True), ("CT", True),
                                           ("CT2", False), ("noNorm", False)])
def test_normalize_case_matches(scheme, masked):
    rng = np.random.RandomState(2)
    data = (rng.rand(1, 3, 10, 9) * 300 - 50).astype(np.float32)
    seg = np.where(rng.rand(1, 3, 10, 9) > 0.2, 0.0, -1.0).astype(np.float32)
    props = {0: {"percentile_00_5": -20.0, "percentile_99_5": 200.0, "mean": 60.0, "sd": 40.0}}
    args = (data, {0: scheme}, {0: masked}, seg, props)
    np.testing.assert_array_equal(normalize.normalize_case(*args), jnorm.normalize_case(*args))


def _write_case(tmp_path, name, shape=(4, 40, 36), spacing_xyz=(1.0, 1.0, 5.0), seed=3):
    """A NIfTI modality with a zero border (so cropping removes it) and a
    bright disk."""
    rng = np.random.RandomState(seed)
    vol = np.zeros(shape, np.float32)
    z, h, w = shape
    yy, xx = np.mgrid[0:h - 6, 0:w - 5]
    disk = ((yy - (h - 6) / 2) ** 2 + (xx - (w - 5) / 2) ** 2 < 80).astype(np.float32)
    vol[:, 3:h - 3, 2:w - 3] = 50 + 20 * rng.rand(z, h - 6, w - 5) + 150 * disk
    path = tmp_path / f"{name}_0000.nii.gz"
    affine = np.diag([*spacing_xyz, 1.0])
    affine[:3, 3] = (-3.0, 7.5, 2.0)
    jnifti.save_nifti(vol, path, affine=affine)
    seg_path = tmp_path / f"{name}_seg.nii.gz"
    jnifti.save_nifti((vol > 150).astype(np.uint8), seg_path, affine=affine)
    return path, seg_path


def _same_props(a: dict, b: dict):
    assert a.keys() == b.keys()
    for k in a:
        if k == "class_locations":
            assert a[k].keys() == b[k].keys()
            for c in a[k]:
                np.testing.assert_array_equal(a[k][c], b[k][c])
        elif isinstance(a[k], np.ndarray) or isinstance(b[k], np.ndarray):
            np.testing.assert_array_equal(a[k], b[k])
        else:
            assert a[k] == b[k], k


def test_load_nifti_and_crop_case_match(tmp_path):
    path, seg_path = _write_case(tmp_path, "case")
    mine, theirs = nifti.load_nifti(path), jnifti.load_nifti(path)
    np.testing.assert_array_equal(mine.data_czyx, theirs.data_czyx)
    np.testing.assert_array_equal(mine.affine, theirs.affine)
    assert (mine.itk_spacing, mine.origin, mine.direction) == (
        theirs.itk_spacing, theirs.origin, theirs.direction)
    for seg in (None, seg_path):
        da, sa, pa = cropping.crop_case([path], seg)
        db, sb, pb = jcrop.crop_case([path], seg)
        np.testing.assert_array_equal(da, db)
        np.testing.assert_array_equal(sa, sb)
        _same_props(pa, pb)
        assert da.shape[1:] == (4, 34, 31)  # the zero border cropped


def test_preprocessor_run_case_matches(tmp_path):
    path, seg_path = _write_case(tmp_path, "case")
    plans_t, plans_j = _plans(tplans), _plans(jplans)
    plans_t.use_mask_for_norm = plans_j.use_mask_for_norm = {0: True}
    for seg in (None, seg_path):
        a = Preprocessor(plans_t).run_case_from_files([path], seg)
        b = JaxPreprocessor(plans_j).run_case_from_files([path], seg)
        for x, y in zip(a[:2], b[:2]):
            np.testing.assert_array_equal(x, y)
        _same_props(a[2], b[2])
    assert a[0].shape == (1, 4, 27, 25)  # in-plane 1.0 -> 1.25 mm, z kept


def test_save_segmentation_from_softmax_writes_the_same_file(tmp_path):
    path, _ = _write_case(tmp_path, "case")
    plans_j = _plans(jplans)
    data, _, props = JaxPreprocessor(plans_j).run_case_from_files([path], None)
    softmax = np.random.RandomState(4).dirichlet(np.ones(3), data.shape[1:]).astype(np.float32)
    softmax = np.moveaxis(softmax, -1, 0)
    export.save_segmentation_from_softmax(softmax, tmp_path / "a.nii.gz", props, save_npz=True)
    jexport.save_segmentation_from_softmax(softmax, tmp_path / "b.nii.gz", props, save_npz=True)
    with gzip.open(tmp_path / "a.nii.gz") as fa, gzip.open(tmp_path / "b.nii.gz") as fb:
        assert fa.read() == fb.read()
    np.testing.assert_array_equal(np.load(tmp_path / "a.npz")["softmax"],
                                  np.load(tmp_path / "b.npz")["softmax"])


# -- K5 and K6: plain versions against the Pallas kernels (interpret) -------


# K5: the same float32 statistics summed in another order; bf16 rounds once
NORM_TOL = {"float32": (2e-5, 2e-5), "bfloat16": (2e-2, 8e-3)}
# K6: the same float32 tap sums in another order; bf16 rounds once
CONV_TOL = {"float32": (1e-5, 1e-5), "bfloat16": (2e-2, 1e-2)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,c,h,w", [(2, 8, 24, 40), (3, 5, 5, 4), (1, 4, 70, 3)])
def test_norm_act_plain_matches_the_pallas_kernel(n, c, h, w, dtype):
    rng = np.random.RandomState(5)
    x = (rng.randn(n, c, h, w) * 3 + 1).astype(np.float32)
    x[0, 1] = 0.5  # a constant plane
    scale = (1 + 0.3 * rng.randn(c)).astype(np.float32)
    bias = (0.3 * rng.randn(c)).astype(np.float32)
    td = getattr(torch, dtype)
    got = k5.norm_act_plain(torch.from_numpy(x).to(td), torch.from_numpy(scale),
                            torch.from_numpy(bias))
    assert got.dtype == td
    ref = instance_norm_leaky_relu_pallas(jnp.asarray(x.transpose(0, 2, 3, 1), dtype), scale,
                                          bias, interpret=True)
    ref = np.asarray(ref, np.float32).transpose(0, 3, 1, 2)
    assert np.isfinite(ref).all() and bool(torch.isfinite(got).all())
    atol, rtol = NORM_TOL[dtype]
    np.testing.assert_allclose(got.float().numpy(), ref, atol=atol, rtol=rtol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,ci,co,h,w,out_f32", [
    (2, 1, 8, 12, 40, False), (1, 6, 16, 9, 20, False), (2, 5, 4, 8, 33, True),
])
def test_conv3x3_plain_matches_the_pallas_kernel(n, ci, co, h, w, out_f32, dtype):
    rng = np.random.RandomState(6)
    x = rng.randn(n, ci, h, w).astype(np.float32)
    wt = (rng.randn(co, ci, 3, 3) / np.sqrt(9 * ci)).astype(np.float32)
    td = getattr(torch, dtype)
    got = k6.conv3x3_plain(torch.from_numpy(x).to(td), torch.from_numpy(wt), out_f32=out_f32)
    assert got.dtype == (torch.float32 if out_f32 else td)
    ref = conv3x3_cols(jnp.asarray(x.transpose(0, 2, 3, 1), dtype),
                       jnp.asarray(wt.transpose(2, 3, 1, 0), dtype), True, out_f32)
    ref = np.asarray(ref, np.float32).transpose(0, 3, 1, 2)
    atol, rtol = CONV_TOL["float32" if out_f32 else dtype]
    np.testing.assert_allclose(got.float().numpy(), ref, atol=atol, rtol=rtol)


def test_kernel_wrappers_are_forward_only_and_use_plain_versions_on_the_cpu():
    """K5 stays forward-only (its TPU kernel has no VJP); K6 takes gradients
    since its backward is ported (Conv3x3Function). On CPU tensors both run
    their plain versions and count no launch."""
    x = torch.randn(1, 4, 8, 8, requires_grad=True)
    with pytest.raises(RuntimeError, match="forward-only"):
        k5.instance_norm_leaky_relu(x, torch.ones(4), torch.zeros(4))
    k5.launches = k6.launches = k6.bwd_launches = 0
    w = torch.randn(4, 4, 3, 3, requires_grad=True)
    y = k6.conv3x3(x, w, torch.zeros(4))
    y.sum().backward()
    assert x.grad is not None and w.grad is not None
    with torch.no_grad():
        k5.instance_norm_leaky_relu(k6.conv3x3(x, w), torch.ones(4), torch.zeros(4))
    assert k5.launches == k6.launches == k6.bwd_launches == 0


# -- the U-Net --------------------------------------------------------------


def _jax_logits(dtype, params, x_nchw):
    net = JaxUNet(dtype=jnp.dtype(dtype), **SMALL)
    out = jax.jit(net.apply)({"params": params}, jnp.asarray(x_nchw.transpose(0, 2, 3, 1)))
    return [np.asarray(o, np.float32).transpose(0, 3, 1, 2) for o in out]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_unet_matches_flax_with_both_switches_on(switches_on, params, dtype):
    x = np.random.RandomState(7).randn(2, 1, *PATCH).astype(np.float32)
    ref = _jax_logits(dtype, params, x)
    net = _port_unet(params, getattr(torch, dtype))
    with torch.no_grad():
        out = net(torch.from_numpy(x))
    assert len(out) == len(ref) == 2
    assert out[0].shape == (2, 3, *PATCH) and out[0].dtype == torch.float32
    atol, rtol = UNET_TOL[dtype]
    for o, r in zip(out, ref):
        np.testing.assert_allclose(o.numpy(), r, atol=atol, rtol=rtol)


def test_unet_switches_off_matches_flax_and_on(params, monkeypatch):
    """Switches off: the module path (``Conv``, ``InstanceNorm``,
    ``leaky_relu``) matches flax's off path, and the kernel path (plain
    versions here) matches it within float32 order."""
    monkeypatch.delenv("CSOF_FUSED_NORM", raising=False)
    monkeypatch.delenv("CSOF_CONV2D_IMPL", raising=False)
    x = np.random.RandomState(8).randn(1, 1, *PATCH).astype(np.float32)
    ref = _jax_logits("float32", params, x)
    net = unet_from_plans(_plans(tplans))
    assert not any(getattr(m, "fused_norm_act", False) or getattr(m, "conv_impl", "native")
                   != "native" for m in net.modules())
    net = GenericUNet(in_channels=1, **SMALL)
    load_flax_params(net, params)
    with torch.no_grad():
        off = net(torch.from_numpy(x))
        on = _port_unet(params)(torch.from_numpy(x))
    atol, rtol = UNET_TOL["float32"]
    for o, n_, r in zip(off, on, ref):
        np.testing.assert_allclose(o.numpy(), r, atol=atol, rtol=rtol)
        np.testing.assert_allclose(n_.numpy(), o.numpy(), atol=atol, rtol=rtol)


def test_unet_from_plans_reads_the_jax_switches(switches_on):
    plans = _plans(tplans)
    net = unet_from_plans(plans, deep_supervision=False)
    blocks = [m for m in net.modules() if hasattr(m, "uses_k6")]
    assert len(blocks) == 10 and all(b.fused_norm_act and b.conv_impl == "pallas" for b in blocks)
    assert net.kernel_launches((64, 64)) == {"K5": 10, "K6": 7, "K7": 0}
    assert net.kernel_launches((64, 48)) == {"K5": 10, "K6": 4, "K7": 0}  # level 1 is 24 wide
    with pytest.raises(ValueError):  # the whole spatial shape, so a plane is never guessed
        net.kernel_launches((48,))
    n_leaves = len(jax.tree_util.tree_leaves(_flax_params(jax_unet_from_plans(_plans(jplans)))))
    assert n_leaves == len(list(net.parameters()))


def test_task002_launch_counts_without_a_forward(switches_on, monkeypatch):
    """26 K5 and 7 K6 launches per forward at Task002 2d: the port's count
    from its modules, and the JAX package's Pallas calls while tracing one
    forward of its U-Net (eval_shape: nothing runs)."""
    import csof_tpu.ops.pallas.conv as jconv
    import csof_tpu.ops.pallas.norm_act as jna

    calls = {"K5": 0, "K6": 0}

    def counting(key, fn):
        def wrapped(*a, **k):
            calls[key] += 1
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(jna, "instance_norm_leaky_relu_pallas",
                        counting("K5", jna.instance_norm_leaky_relu_pallas))
    monkeypatch.setattr(jconv, "conv3x3_cols_vb", counting("K6", jconv.conv3x3_cols_vb))
    pools = ((2, 2),) * 6
    jnet = jax_unet_from_plans(_plans(jplans, (320, 256), pools=pools))
    jnet = dataclasses.replace(jnet, base_num_features=32)
    jax.eval_shape(jnet.init, jax.random.PRNGKey(0), jax.ShapeDtypeStruct((1, 320, 256, 1),
                                                                          jnp.float32))
    assert calls == {"K5": 26, "K6": 7}
    plans = _plans(tplans, (320, 256),
                   pools=pools)
    plans.base_num_features = 32
    net = unet_from_plans(plans)
    assert net.features_at(6) == 480 and net.kernel_launches((320, 256)) == {**calls, "K7": 0}


# -- the predictor and predict_case ----------------------------------------


def _predictors(params, tile_batch=3):
    jnet = JaxUNet(**SMALL)
    jpred = JaxPredictor(lambda p, x: jnet.apply(p, x)[0],
                         JaxPredictorConfig(patch_size=PATCH, num_classes=3,
                                            tile_batch=tile_batch))
    tpred = SlidingWindowPredictor(_port_unet(params),
                                   PredictorConfig(patch_size=PATCH, num_classes=3,
                                                   tile_batch=tile_batch), device="cpu")
    return jpred, tpred


def test_predict_2d_stack_and_predict_match_jax(switches_on, params):
    """A ragged volume (1, 3, 80, 72): the bucket (96, 96) gives 4 tiles a
    slice, D pads to 4: 16 jobs in 6 forwards of 3 tiles x 4 mirrors, the
    last one padded with 2 zero tiles."""
    vol = np.random.RandomState(9).randn(1, 3, 80, 72).astype(np.float32)
    jpred, tpred = _predictors(params)
    seg_j, probs_j = jpred.predict_2d_stack({"params": params}, vol)
    seg_t, probs_t = tpred.predict_2d_stack(vol)
    assert probs_t.shape == probs_j.shape == (3, 3, 80, 72)
    np.testing.assert_allclose(probs_t, probs_j, atol=PROB_TOL[0], rtol=PROB_TOL[1])
    margin = np.sort(probs_j, 0)[-1] - np.sort(probs_j, 0)[-2]
    np.testing.assert_array_equal(seg_t[margin > 1e-4], seg_j[margin > 1e-4])
    # predict on one slice: the same engine on a 2D image
    seg_j, probs_j = jpred.predict({"params": params}, vol[:, 1])
    seg_t, probs_t = tpred.predict(vol[:, 1])
    np.testing.assert_allclose(probs_t, probs_j, atol=PROB_TOL[0], rtol=PROB_TOL[1])


def test_predict_3d_patches_matches_jax():
    """``predict`` over 3D patches with a pointwise network (the same
    function in both frameworks): tiling, mirroring over three axes, the
    zero-tile padding of the last chunk and the ordered Gaussian sums."""
    w = np.random.RandomState(10).randn(2, 2).astype(np.float32)

    def jax_net(_, x):  # (n, *patch, 2)
        return jnp.tanh(x) @ w + x[..., :1] * jnp.arange(1, 4)[None, None, None, None, :2]

    class Net(torch.nn.Module):
        def forward(self, x):  # (n, 2, *patch)
            y = torch.einsum("nc...,ck->nk...", torch.tanh(x), torch.from_numpy(w))
            return y + x[:, :1] * torch.tensor([1.0, 2.0]).view(1, 2, 1, 1, 1)

    vol = np.random.RandomState(11).randn(2, 10, 20, 33).astype(np.float32)
    cfg = dict(patch_size=(8, 16, 16), num_classes=2, tile_batch=4)  # 147 tiles: 1 pad
    seg_j, probs_j = JaxPredictor(jax_net, JaxPredictorConfig(**cfg)).predict({}, vol)
    seg_t, probs_t = SlidingWindowPredictor(Net(), PredictorConfig(**cfg), "cpu").predict(vol)
    np.testing.assert_allclose(probs_t, probs_j, atol=1e-6, rtol=1e-6)
    np.testing.assert_array_equal(seg_t, seg_j)


def test_predict_case_matches_the_jax_per_case_body(switches_on, params, tmp_path):
    """The body of the JAX package's csof_predict loop (preprocess,
    predict_2d_stack, export) against ``predict_case``: the resampled
    softmax and the written segmentation."""
    path, _ = _write_case(tmp_path, "case", shape=(3, 100, 96))
    plans_j = _plans(jplans)
    plans_t = _plans(tplans)
    jpred, _ = _predictors(params, tile_batch=8)
    data, _, props = JaxPreprocessor(plans_j, stage=0).run_case_from_files([str(path)], None)
    _, softmax = jpred.predict_2d_stack({"params": params}, data)
    jexport.save_segmentation_from_softmax(softmax, tmp_path / "jax.nii.gz", props,
                                           save_npz=True)
    res = predict_case(plans_t, _port_unet(params), [path], tmp_path / "port.nii.gz",
                       save_npz=True, device="cpu")
    assert res["softmax"].shape == softmax.shape == (3, 3, 75, 73)  # 4 tiles a slice
    np.testing.assert_allclose(res["softmax"], softmax, atol=PROB_TOL[0], rtol=PROB_TOL[1])
    a = np.load(tmp_path / "port.npz")["softmax"]
    b = np.load(tmp_path / "jax.npz")["softmax"]
    np.testing.assert_allclose(a, b, atol=PROB_TOL[0], rtol=PROB_TOL[1])
    seg_t = nifti.load_nifti(tmp_path / "port.nii.gz")
    seg_j = jnifti.load_nifti(tmp_path / "jax.nii.gz")
    np.testing.assert_array_equal(seg_t.affine, seg_j.affine)
    margin = np.sort(b, 0)[-1] - np.sort(b, 0)[-2]
    bbox = props["crop_bbox"]
    inside = tuple(slice(lo, hi) for lo, hi in bbox)
    np.testing.assert_array_equal(seg_t.data_czyx[inside][margin > 1e-4],
                                  seg_j.data_czyx[inside][margin > 1e-4])
    assert seg_t.data_czyx.shape == (3, 100, 96)
