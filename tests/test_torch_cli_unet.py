"""The port's U-Net command line against the JAX package's, on 2 synthetic
ACDC patients (as ``tests/test_validation.py`` drives the JAX one): the
checks of ``tests/test_torch_cli.py`` for ``csof_predict``,
``--validation-only``, ``csof_evaluate`` and ``csof_ensemble``. One module
fixture runs the JAX CLI once: it converts and plans the task, trains a
tiny U-Net (augmentation on), validates the fold, predicts every case with
the softmax saved, and evaluates. The port's entries restore that msgpack
folder with ``--device cpu``: segmentations agree on at least 99.9 % of
voxels (where they differ, the JAX softmax's top two are within 1e-3), and
the summaries are within 1e-6 of JAX's. A file of its own, so that the
SegFlow and U-Net halves run on two test workers.
"""

import json
import shutil

import numpy as np
import pytest
import torch_threads
import yaml
from test_torch_cli import _assert_segs_agree, _nii

from csof_tpu.cli import main as jcli
from csof_tpu_torch.cli import main as cli

torch_threads.pin()

SUMMARY_TOL = 1e-6
SEG_CFG = {"model": "unet2d", "max_num_epochs": 1, "num_batches_per_epoch": 2,
           "num_val_batches_per_epoch": 1, "data": {"do_data_aug": True}}


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli_unet")
    task, pre = root / "task", root / "pre"
    jcli.convert_acdc_entry(["-o", str(task), "--synthetic", "2"])
    jcli.plan_and_preprocess_entry(["-t", str(task), "-o", str(pre), "--num-workers", "1"])
    (root / "seg.yaml").write_text(yaml.safe_dump(SEG_CFG))
    jcli.train_entry(["-c", str(root / "seg.yaml"), "-p", str(pre), "-o", str(root / "jax_seg"),
                      "-f", "0", "--max-epochs", "1"])
    # the same trained folder for the port's --validation-only, which
    # writes its validation_raw/ inside the folder
    shutil.copytree(root / "jax_seg", root / "port_seg")
    jcli.train_entry(["-c", str(root / "seg.yaml"), "-p", str(pre), "-o", str(root / "jax_seg"),
                      "-f", "0", "--validation-only"])
    jcli.predict_entry(["-m", str(root / "jax_seg" / "fold_0"), "-i", str(task / "imagesTr"),
                        "-o", str(root / "jax_pred"), "--save-npz"])
    jcli.evaluate_entry(["-p", str(root / "jax_pred"), "-r", str(task / "labelsTr"),
                         "-l", "1", "2", "3", "-o", str(root / "jax_eval.json")])
    return root


def test_predict_restores_the_jax_unet_folder(jax_run):
    out = jax_run / "port_pred"
    cli.predict_entry(["-m", str(jax_run / "jax_seg" / "fold_0"), "-i",
                       str(jax_run / "task" / "imagesTr"), "-o", str(out), "--save-npz",
                       "--device", "cpu"])
    ref_root = jax_run / "jax_pred"
    cases = sorted(f.name for f in ref_root.glob("*.nii.gz"))
    assert cases and cases == sorted(f.name for f in out.glob("*.nii.gz"))
    for case in cases:
        stem = case.replace(".nii.gz", "")
        soft = np.load(ref_root / f"{stem}.npz")["softmax"]
        got_soft = np.load(out / f"{stem}.npz")["softmax"]
        _assert_segs_agree(got_soft.argmax(0), soft.argmax(0), lambda soft=soft: soft)
        _assert_segs_agree(_nii(out / case), _nii(ref_root / case), lambda: None)


def _assert_summary_close(got: dict, ref: dict) -> None:
    assert set(got) == set(ref)
    for label, metrics in ref.items():
        assert set(got[label]) == set(metrics)
        for name, value in metrics.items():
            a, b = got[label][name], value
            assert (np.isnan(a) and np.isnan(b)) or abs(a - b) <= SUMMARY_TOL, (label, name, a, b)


def test_validation_only_and_evaluate_match_jax(jax_run):
    cli.train_entry(["-c", str(jax_run / "seg.yaml"), "-p", str(jax_run / "pre"), "-o",
                     str(jax_run / "port_seg"), "-f", "0", "--validation-only", "--device", "cpu"])
    got = json.loads((jax_run / "port_seg" / "fold_0" / "validation_raw" / "summary.json")
                     .read_text())
    ref = json.loads((jax_run / "jax_seg" / "fold_0" / "validation_raw" / "summary.json")
                     .read_text())
    assert [c["case"] for c in got["all"]] == [c["case"] for c in ref["all"]]
    _assert_summary_close(got["mean"], ref["mean"])

    cli.evaluate_entry(["-p", str(jax_run / "jax_pred"), "-r", str(jax_run / "task" / "labelsTr"),
                        "-l", "1", "2", "3", "-o", str(jax_run / "port_eval.json")])
    got = json.loads((jax_run / "port_eval.json").read_text())
    ref = json.loads((jax_run / "jax_eval.json").read_text())
    _assert_summary_close(got["mean"], ref["mean"])
    for a, b in zip(got["all"], ref["all"]):
        _assert_summary_close({k: v for k, v in a.items() if k not in ("test", "reference")},
                              {k: v for k, v in b.items() if k not in ("test", "reference")})


def test_ensemble_averages_the_jax_and_the_port_predictions(jax_run, tmp_path):
    if not (jax_run / "port_pred").exists():
        test_predict_restores_the_jax_unet_folder(jax_run)
    cli.ensemble_entry(["-f", str(jax_run / "jax_pred"), str(jax_run / "port_pred"), "-o",
                        str(tmp_path / "ens")])
    npzs = sorted((jax_run / "jax_pred").glob("*.npz"))
    assert npzs
    for npz in npzs:
        mean = (np.load(npz)["softmax"] + np.load(jax_run / "port_pred" / npz.name)["softmax"]) / 2
        np.testing.assert_allclose(np.load(tmp_path / "ens" / npz.name)["softmax"], mean)
        seg = np.load(tmp_path / "ens" / npz.name.replace(".npz", "_seg.npy"))
        np.testing.assert_array_equal(seg, mean.argmax(0))
