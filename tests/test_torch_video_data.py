"""The port's cine data and sliding flow inference against the JAX package's:
``data/video_dataset.py`` (``build_video_datasets`` with and without an
ED/ES CSV, ``put_ed_first``, ``restore_frame_order``, ``split_videos``) on a
converted synthetic task, exactly; ``ops/warp.py`` ``compose_flows``, and
``inference/flow_predictor.py`` ``predict_video_sliding`` and
``processor_from_seg_model`` on the same small float32 weights: flows
within 1e-4, segmentations and ROI masks equal."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads
from test_torch_segflow import SMALL, small_params
from test_torch_unet import _flax_params as unet_params

from csof_tpu.config.experiment import SegFlowModelConfig as JaxConfig
from csof_tpu.data import video_dataset as jvd
from csof_tpu.data.conversion.acdc import convert_acdc, make_synthetic_acdc
from csof_tpu.inference import flow_predictor as jfp
from csof_tpu.models.segflow import SegFlow as JaxSegFlow
from csof_tpu.models.unet import GenericUNet as JaxUNet
from csof_tpu.ops.warp import compose_flows as jax_compose
from csof_tpu_torch.compat.flax_import import load_flax_params
from csof_tpu_torch.config.experiment import SegFlowModelConfig
from csof_tpu_torch.data import video_dataset as vd
from csof_tpu_torch.inference import flow_predictor as fp
from csof_tpu_torch.models.segflow import SegFlow
from csof_tpu_torch.models.unet import GenericUNet
from csof_tpu_torch.ops.warp import compose_flows

torch_threads.pin()

FLOW_TOL = 1e-4


@pytest.fixture(scope="module")
def task(tmp_path_factory):
    root = tmp_path_factory.mktemp("video_task")
    make_synthetic_acdc(root / "raw", num_patients=3, num_frames=7, shape_zyx=(2, 40, 44))
    convert_acdc(root / "raw", root / "task")
    return root / "task"


def test_build_video_datasets_and_the_frame_order_match_jax(task, tmp_path):
    csv = tmp_path / "ed_es.csv"
    csv.write_text("Patient,ED,ES\npatient001,2,5\n")
    for kw in ({}, {"ed_es_csv": csv}):
        got, ref = vd.build_video_datasets(task, **kw), jvd.build_video_datasets(task, **kw)
        assert list(got) == list(ref) and len(got) == 3
        for pid in ref:
            assert (got[pid]["ed"], got[pid]["es"]) == (ref[pid]["ed"], ref[pid]["es"])
            for key in ("frames", "seg"):
                assert got[pid][key].dtype == ref[pid][key].dtype
                np.testing.assert_array_equal(got[pid][key], ref[pid][key])
            frames, seg = ref[pid]["frames"], ref[pid]["seg"]
            for ed in (0, 3, 9):
                g, r = vd.put_ed_first(frames, ed, seg), jvd.put_ed_first(frames, ed, seg)
                np.testing.assert_array_equal(g[0], r[0])
                np.testing.assert_array_equal(g[1], r[1])
                assert g[2] == r[2]
                np.testing.assert_array_equal(vd.restore_frame_order(g[0], g[2]), frames)
    assert vd.read_ed_es_csv(csv) == jvd.read_ed_es_csv(csv)
    videos = vd.build_video_datasets(task)
    for fold in range(3):
        got, ref = vd.split_videos(videos, fold), jvd.split_videos(videos, fold)
        assert [list(x) for x in got] == [list(x) for x in ref]


def test_compose_flows_matches_jax():
    rng = np.random.RandomState(0)
    a, b = (3 * rng.randn(2, 20, 24, 2)).astype(np.float32)
    ref = jax.vmap(jax_compose)(jnp.asarray(a[None]), jnp.asarray(b[None]))
    got = compose_flows(torch.from_numpy(a[None]), torch.from_numpy(b[None]))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5, rtol=0)


def _cine(seed=0, t=5, d=2, h=40, w=44):
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    out = np.empty((t, d, h, w), np.float32)
    for i in range(t):
        disk = (yy - 20) ** 2 + (xx - 22) ** 2 <= (9 + 2 * np.cos(i)) ** 2
        out[i] = 200 * disk + 30 * rng.rand(d, h, w)
    return out


@pytest.mark.parametrize("window,overlap", [(3, 1), (4, 2)])
def test_predict_video_sliding_matches_jax(window, overlap):
    kw = dict(corr_fuse="concat_cm", dtype="float32", **SMALL)
    params = small_params(JaxConfig(**kw))
    jmodel = JaxSegFlow(cfg=JaxConfig(**kw))
    jpred = jfp.FlowPredictor(lambda v: jmodel.apply({"params": params}, v), crop_size=32,
                              do_mirroring=False)
    model = SegFlow(SegFlowModelConfig(**kw), 4)
    load_flax_params(model, params)
    pred = fp.FlowPredictor(model.eval(), crop_size=32, do_mirroring=False, device="cpu")
    cine = _cine()
    got = fp.predict_video_sliding(pred, cine, window, overlap)
    ref = jfp.predict_video_sliding(jpred, cine, window, overlap)
    assert got["flow"].shape == ref["flow"].shape == (*cine.shape, 2)
    np.testing.assert_allclose(got["flow"], ref["flow"], atol=FLOW_TOL, rtol=0)
    np.testing.assert_allclose(got["registered"], ref["registered"], atol=FLOW_TOL, rtol=0)
    np.testing.assert_allclose(got["softmax"], ref["softmax"], atol=FLOW_TOL, rtol=0)
    np.testing.assert_array_equal(got["seg"], ref["seg"])
    with pytest.raises(ValueError):
        fp.predict_video_sliding(pred, cine, 2, 2)


def test_processor_from_seg_model_matches_jax():
    net_kw = dict(num_classes=3, base_num_features=8, pool_kernel_sizes=((2, 2),) * 2,
                  conv_kernel_sizes=((3, 3),) * 3, deep_supervision=False)
    jnet = JaxUNet(**net_kw)
    params = unet_params(jnet)
    net = GenericUNet(in_channels=1, **net_kw)
    load_flax_params(net, params)
    jproc = jfp.processor_from_seg_model(lambda p, x: jnet.apply({"params": p}, x), params,
                                         (32, 32), crop_size=24)
    proc = fp.processor_from_seg_model(net.eval(), (32, 32), crop_size=24, device="cpu")
    for plane in (_cine(1)[0, 0], _cine(2, h=28, w=36)[1, 1]):  # cut, and padded
        np.testing.assert_array_equal(proc.get_mask(plane), jproc.get_mask(plane))
