"""The legacy nnU-Net imports of the port against the JAX package's (CPU):

- a synthetic reference (nnU-Net v1) ``Generic_UNet`` state dict, 2D and
  3D (two pools, two convs a stage, the bottleneck and the decoder stages
  as two stacked layers, bias-free transposed convs and heads, random
  values from a seed), through the JAX package's
  ``import_generic_unet_weights`` into its U-Net and through the port's into
  its U-Net: the same logits (float32, within 1e-4: sums in another order);
  ``load_reference_checkpoint`` of the same dict saved as a reference
  checkpoint (``state_dict`` with DataParallel's ``module.`` prefixes);
- ``Plans.from_reference_pickle`` of a legacy plans pickle (numpy values,
  two stages): equal plans in both packages;
- ``save_segmentation_from_softmax`` with ``region_class_order``: the same
  NIfTI payload in both packages.
"""

import dataclasses
import gzip
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads

from csof_tpu.compat.torch_import import import_generic_unet_weights as jax_import
from csof_tpu.config.plans import Plans as JPlans
from csof_tpu.inference import export as jexport
from csof_tpu.models.unet import GenericUNet as JaxUNet
from csof_tpu_torch.compat.torch_import import (
    import_generic_unet_weights,
    load_reference_checkpoint,
)
from csof_tpu_torch.config.plans import Plans
from csof_tpu_torch.inference import export
from csof_tpu_torch.models.unet import GenericUNet

torch_threads.pin()

LOGIT_TOL = 1e-4
NETS = {
    "2d": dict(num_classes=3, base_num_features=4, pool_kernel_sizes=((2, 2), (2, 2)),
               conv_kernel_sizes=((3, 3),) * 3),
    "3d": dict(num_classes=3, base_num_features=4, pool_kernel_sizes=((1, 2, 2), (2, 2, 2)),
               conv_kernel_sizes=((1, 3, 3), (3, 3, 3), (3, 3, 3))),
}
SHAPES = {"2d": (2, 1, 32, 32), "3d": (2, 1, 8, 16, 16)}


def reference_state_dict(net: dict, seed: int = 0) -> dict[str, np.ndarray]:
    """A reference Generic_UNet state dict of the net's geometry (names and
    layouts of nnunet/network_architecture/generic_UNet.py)."""
    rng = np.random.RandomState(seed)
    pools, kernels = net["pool_kernel_sizes"], net["conv_kernel_sizes"]
    n = len(pools)
    feats = [net["base_num_features"] * 2 ** lv for lv in range(n + 1)]
    sd = {}

    def block(base, cin, cout, k):
        sd[f"{base}.conv.weight"] = rng.randn(cout, cin, *k) / np.sqrt(cin * np.prod(k))
        sd[f"{base}.conv.bias"] = 0.1 * rng.randn(cout)
        sd[f"{base}.instnorm.weight"] = 1 + 0.1 * rng.randn(cout)
        sd[f"{base}.instnorm.bias"] = 0.1 * rng.randn(cout)

    for d in range(n):
        block(f"conv_blocks_context.{d}.blocks.0", 1 if d == 0 else feats[d - 1], feats[d],
              kernels[d])
        block(f"conv_blocks_context.{d}.blocks.1", feats[d], feats[d], kernels[d])
    block(f"conv_blocks_context.{n}.0.blocks.0", feats[n - 1], feats[n], kernels[n])
    block(f"conv_blocks_context.{n}.1.blocks.0", feats[n], feats[n], kernels[n])
    for u in range(n):
        level = n - 1 - u
        sd[f"tu.{u}.weight"] = (rng.randn(feats[level + 1], feats[level], *pools[level])
                                / np.sqrt(feats[level + 1]))
        block(f"conv_blocks_localization.{u}.0.blocks.0", 2 * feats[level], feats[level],
              kernels[level + 1])
        block(f"conv_blocks_localization.{u}.1.blocks.0", feats[level], feats[level],
              kernels[level + 1])
        sd[f"seg_outputs.{u}.weight"] = (rng.randn(net["num_classes"], feats[level],
                                                   *(1,) * len(pools[0])) / np.sqrt(feats[level]))
    return {k: v.astype(np.float32) for k, v in sd.items()}


@pytest.mark.parametrize("nd", ["2d", "3d"])
def test_generic_unet_import_gives_the_jax_logits(nd, tmp_path):
    net = NETS[nd]
    sd = reference_state_dict(net)
    x = np.random.RandomState(1).randn(*SHAPES[nd]).astype(np.float32)
    jnet = JaxUNet(**net)
    template = jax.eval_shape(jnet.init, jax.random.PRNGKey(0),
                              jax.ShapeDtypeStruct((1, *SHAPES[nd][2:], 1), jnp.float32))
    template = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32), template)
    jparams = jax_import(sd, template)
    ref = jax.jit(jnet.apply)(jparams, jnp.asarray(np.moveaxis(x, 1, -1)))
    ref = [np.moveaxis(np.asarray(o), -1, 1) for o in ref]

    port = GenericUNet(in_channels=1, **net)
    with torch.no_grad():
        for p in port.parameters():
            p.zero_()  # as the JAX template: the transposed convs' biases stay as they were
    state = import_generic_unet_weights({k: torch.from_numpy(v) for k, v in sd.items()}, port)
    port.load_state_dict(state)
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), r, atol=LOGIT_TOL, rtol=LOGIT_TOL)

    path = tmp_path / "model_final_checkpoint.model"
    torch.save({"state_dict": {f"module.{k}": torch.from_numpy(v) for k, v in sd.items()},
                "epoch": 3}, path)
    again = load_reference_checkpoint(path, port)
    assert set(again) == set(state) and all(torch.equal(again[k], state[k]) for k in state)
    bad = dict(sd, **{"tu.0.weight": sd["tu.0.weight"][:, :1]})
    with pytest.raises(ValueError, match="does not fit"):
        import_generic_unet_weights(bad, port)


def test_from_reference_pickle_gives_the_jax_plans(tmp_path):
    stage = lambda patch, spacing, pools: {  # noqa: E731
        "batch_size": np.int64(2), "patch_size": np.array(patch),
        "current_spacing": np.array(spacing), "original_spacing": np.array([1.37, 1.25, 1.25]),
        "pool_op_kernel_sizes": [np.array(p) for p in pools],
        "conv_kernel_sizes": [[3, 3, 3]] * (len(pools) + 1),
        "do_dummy_2D_data_aug": False, "median_patient_size_in_voxels": np.array([115, 320, 232])}
    legacy = {
        "plans_per_stage": {0: stage([64, 128, 112], [2.7, 2.5, 2.5], [[2, 2, 2]] * 4),
                            1: stage([80, 192, 160], [1.37, 1.25, 1.25], [[1, 2, 2]] + [[2, 2, 2]] * 4)},
        "num_modalities": 1, "num_classes": np.int64(1), "all_classes": [np.int64(1)],
        "normalization_schemes": {0: "nonCT"}, "use_mask_for_norm": {0: np.bool_(False)},
        "transpose_forward": [0, 1, 2], "transpose_backward": [0, 1, 2],
        "base_num_features": 30, "conv_per_stage": 2,
        "dataset_properties": {"intensityproperties": {0: {"mean": 1.5, "sd": 2.0}}},
        "modalities": {0: "MRI"},
    }
    path = tmp_path / "nnUNetPlansv2.1_plans_3D.pkl"
    path.write_bytes(pickle.dumps(legacy))
    got = Plans.from_reference_pickle(path, task="Task002_Heart")
    ref = JPlans.from_reference_pickle(path, task="Task002_Heart")
    assert dataclasses.asdict(got) == dataclasses.asdict(ref)
    assert got.fullres_stage().patch_size == (80, 192, 160) and got.num_classes_with_background == 2
    assert Plans.from_reference_pickle(path).task == JPlans.from_reference_pickle(path).task


def test_region_class_order_export_writes_the_jax_file(tmp_path):
    rng = np.random.RandomState(2)
    softmax = rng.rand(2, 6, 20, 18).astype(np.float32)  # two region sigmoids
    props = {"original_size_of_raw_data": (8, 24, 20), "size_after_cropping": (6, 20, 18),
             "crop_bbox": [[1, 7], [2, 22], [1, 19]], "original_spacing": (2.0, 1.5, 1.5),
             "spacing_after_resampling": (2.0, 1.5, 1.5), "nifti_affine": None}
    export.save_segmentation_from_softmax(softmax, tmp_path / "t.nii.gz", props,
                                          region_class_order=(1, 2))
    jexport.save_segmentation_from_softmax(softmax, tmp_path / "j.nii.gz", props,
                                           region_class_order=(1, 2))
    t = gzip.decompress((tmp_path / "t.nii.gz").read_bytes())
    assert t == gzip.decompress((tmp_path / "j.nii.gz").read_bytes())
    export.save_segmentation_from_softmax(softmax, tmp_path / "a.nii.gz", props)
    assert gzip.decompress((tmp_path / "a.nii.gz").read_bytes()) != t
