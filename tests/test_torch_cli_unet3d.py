"""The port's command line on the 3D U-Net against the JAX package's, on a
tiny synthetic task (CPU): the port plans it
(``csof_torch_plan_and_preprocess``: one 3D stage, ``preprocessed_3d/``;
the plans cut to base 4, batch 2 and two pools);
a JAX ``unet3d`` results folder (``fold_0/`` with ``config.yaml``,
``plans.json``, ``meta.json`` and the msgpack checkpoint of a JAX
``Trainer`` whose weights are drawn from a seed) restores in the port,
whose ``csof_torch_predict --disable-tta`` gives the softmax of the JAX
package's ``csof_predict`` within 1e-5 and the same segmentation (where
they differ, the JAX softmax's top two are within 1e-3); then
``csof_torch_train`` with ``model: unet3d`` on ``--device cpu`` takes a
step and a validation batch and writes its checkpoint, validates the fold
from it (``--validation-only``), and ``csof_torch_evaluate`` scores the
validation's files."""

import json

import numpy as np
import pytest
import torch_threads
from test_torch_cli import _assert_segs_agree, _nii
from test_torch_restore import _filled_params

from csof_tpu.cli import main as jcli
from csof_tpu.config import experiment as jexp
from csof_tpu.config import plans as jplans
from csof_tpu.models.unet import GenericUNet as JaxUNet
from csof_tpu.training import restore as jrestore
from csof_tpu.training import trainer as jtrainer
from csof_tpu_torch.cli import main as cli
from csof_tpu_torch.data.conversion.acdc import _phantom_frame
from csof_tpu_torch.utils.nifti import save_nifti
from csof_tpu_torch.utils.logging import read_training_logs

torch_threads.pin()

SOFTMAX_TOL = 1e-5  # float32 logits summed in another order, through a softmax


@pytest.fixture(scope="module")
def task_and_fold(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli_unet3d")
    task = root / "task"
    (task / "imagesTr").mkdir(parents=True)
    (task / "labelsTr").mkdir()
    rng = np.random.RandomState(7)
    for i in range(2):
        img, seg = _phantom_frame((12, 40, 40), 0.4 * i, rng)
        img = img + 0.1 * rng.randn(*img.shape).astype(np.float32)
        save_nifti(img, task / "imagesTr" / f"c{i}_0000.nii.gz", spacing_xyz=(1.5, 1.5, 2.0))
        save_nifti(seg.astype(np.uint8), task / "labelsTr" / f"c{i}.nii.gz",
                   spacing_xyz=(1.5, 1.5, 2.0))
    (task / "dataset.json").write_text(json.dumps({"modality": {"0": "MRI"}, "training": [
        {"image": f"./imagesTr/c{i}.nii.gz", "label": f"./labelsTr/c{i}.nii.gz"} for i in (0, 1)]}))
    cli.plan_and_preprocess_entry(["-t", str(task), "-o", str(root / "pre"), "--num-workers", "1"])
    # the planned net, cut to a CPU test's size: base 4, batch 2 (the
    # planner grows a small patch's batch to 64), two of its three pools
    plans = jplans.Plans.from_json(root / "pre" / "plans_3D.json")
    sp = plans.fullres_stage()
    plans.base_num_features, sp.batch_size = 4, 2
    sp.pool_op_kernel_sizes, sp.conv_kernel_sizes = sp.pool_op_kernel_sizes[:2], sp.conv_kernel_sizes[:3]
    plans.to_json(root / "pre" / "plans_3D.json")
    assert len(plans.plans_per_stage) == 1 and len(plans.fullres_stage().patch_size) == 3
    config = jexp.ExperimentConfig(model="unet3d", data=jexp.DataConfig(do_data_aug=False))
    fold = root / "jax" / "fold_0"
    patch = plans.fullres_stage().patch_size
    with pytest.MonkeyPatch.context() as mp:
        for var in ("CSOF_CONV2D_IMPL", "CSOF_CONV3D_IMPL", "CSOF_FUSED_NORM"):
            mp.delenv(var, raising=False)
        model = jtrainer.build_model(config, plans)
        params = _filled_params(model, (np.zeros((1, *patch, 1), np.float32),))
        mp.setattr(JaxUNet, "init", lambda self, rng, *x: params)
        example = {"data": np.zeros((1, *patch, 1), np.float32),
                   "seg": np.zeros((1, *patch), np.int32)}
        tr = jtrainer.Trainer(config, fold, plans=plans, num_classes=4, example_batch=example)
    tr.save_checkpoint(jtrainer.ckpt.FINAL)
    jrestore.save_trainer_sidecar(fold, config, plans, plans.num_classes_with_background)
    return root, fold, params


def test_predict_restores_a_jax_unet3d_folder(task_and_fold, monkeypatch):
    root, fold, params = task_and_fold
    # the JAX restore's eager flax init takes most of a minute on the CPU:
    # it gets the tree's shapes instead (the checkpoint's weights replace them)
    monkeypatch.setattr(JaxUNet, "init", lambda self, rng, *x: params)
    jcli.predict_entry(["-m", str(fold), "-i", str(root / "task" / "imagesTr"), "-o",
                        str(root / "jax_pred"), "--disable-tta", "--save-npz"])
    cli.predict_entry(["-m", str(fold), "-i", str(root / "task" / "imagesTr"), "-o",
                       str(root / "port_pred"), "--disable-tta", "--save-npz", "--device", "cpu"])
    for case in ("c0", "c1"):
        ref = np.load(root / "jax_pred" / f"{case}.npz")["softmax"]
        got = np.load(root / "port_pred" / f"{case}.npz")["softmax"]
        np.testing.assert_allclose(got, ref, atol=SOFTMAX_TOL, rtol=SOFTMAX_TOL)
        seg = _nii(root / "port_pred" / f"{case}.nii.gz")
        assert seg.shape == (12, 40, 40)
        _assert_segs_agree(seg, _nii(root / "jax_pred" / f"{case}.nii.gz"),
                           lambda ref=ref: ref)


def test_train_takes_a_unet3d_step_on_the_cpu(task_and_fold, capsys):
    root = task_and_fold[0]
    (root / "u3.yaml").write_text("model: unet3d\nmax_num_epochs: 1\nnum_batches_per_epoch: 1\n"
                                  "num_val_batches_per_epoch: 1\n")
    cli.train_entry(["-c", str(root / "u3.yaml"), "-p", str(root / "pre"), "-o",
                     str(root / "port_train"), "--device", "cpu"])
    out = root / "port_train" / "fold_0"
    assert (out / "model_final_checkpoint.pt").is_file()
    log = "\n".join(read_training_logs(out)[-1])
    assert "epoch 1" in log and "fg-dice" in log, log
    assert json.loads((out / "meta.json").read_text()) == {"num_classes": 4}
    # the fold's validation from its checkpoint, then csof_torch_evaluate on its files
    cli.train_entry(["-c", str(root / "u3.yaml"), "-p", str(root / "pre"), "-o",
                     str(root / "port_train"), "--validation-only", "--device", "cpu"])
    summary = json.loads((out / "validation_raw" / "summary.json").read_text())
    assert summary["all"] and set(summary["mean"]) == {"1", "2", "3"}
    cli.evaluate_entry(["-p", str(out / "validation_raw"), "-r", str(root / "task" / "labelsTr"),
                        "-l", "1", "2", "3", "-o", str(root / "eval.json")])
    scores = json.loads((root / "eval.json").read_text())
    assert len(scores["all"]) == len(summary["all"])
