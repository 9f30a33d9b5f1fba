"""The port's nnU-Net tail against the JAX package's, on the CPU: model
selection, postprocessing and region-based evaluation on seeded arrays, and
the seven commands (find_best_configuration, determine_postprocessing,
export / install / print / change model, plot_task_pngs) on a fold the JAX
CLI trained and on one the port's CLI trained.

One module fixture converts 2 synthetic ACDC patients (4 cases), plans
them with the 2D U-Net cut to base 8 and batch 4, trains one step with each
CLI and predicts every case with the softmax saved (no TTA).

Tolerances: the JSON of selection and postprocessing equal to JAX's, the
scores within 1e-12 (the same numpy arithmetic); zip member lists, listings
and ``config.yaml`` bytes equal; the overlay PNGs' pixels equal to the
decode of the JAX command's ``plt.imsave`` files (PIL reads them here, and
only here); a fold installed from its zip predicts the same bits.
"""

import contextlib
import io
import json
import shutil
import zipfile

import numpy as np
import pytest
import torch_threads
import yaml
from PIL import Image

import csof_tpu.evaluation.model_selection as jsel
import csof_tpu.evaluation.postprocessing as jpp
import csof_tpu.evaluation.region_based as jreg
from csof_tpu.cli import main as jcli
from csof_tpu_torch.cli import main as cli
from csof_tpu_torch.evaluation import model_selection as sel
from csof_tpu_torch.evaluation import postprocessing as pp
from csof_tpu_torch.evaluation import region_based as reg
from csof_tpu_torch.utils.logging import read_training_logs
from csof_tpu_torch.utils.nifti import load_nifti
from csof_tpu_torch.utils.png import read_png

torch_threads.pin()

SCORE_TOL = 1e-12
SEG_CFG = {"model": "unet2d", "max_num_epochs": 1, "num_batches_per_epoch": 1,
           "num_val_batches_per_epoch": 1, "data": {"do_data_aug": False}}


@pytest.fixture(scope="module")
def folds(tmp_path_factory):
    root = tmp_path_factory.mktemp("selection")
    task, pre = root / "task", root / "pre"
    jcli.convert_acdc_entry(["-o", str(task), "--synthetic", "2"])
    jcli.plan_and_preprocess_entry(["-t", str(task), "-o", str(pre), "--num-workers", "1"])
    plans = json.loads((pre / "plans_2D.json").read_text())
    plans["base_num_features"] = 8
    plans["plans_per_stage"]["0"]["batch_size"] = 4
    (pre / "plans_2D.json").write_text(json.dumps(plans, indent=1))
    (root / "seg.yaml").write_text(yaml.safe_dump(SEG_CFG))
    for name, mod, extra in (("jax", jcli, []), ("port", cli, ["--device", "cpu"])):
        mod.train_entry(["-c", str(root / "seg.yaml"), "-p", str(pre), "-o",
                         str(root / f"{name}_seg"), "-f", "0"] + extra)
        mod.predict_entry(["-m", str(root / f"{name}_seg" / "fold_0"), "-i",
                           str(task / "imagesTr"), "-o", str(root / f"{name}_pred"),
                           "--save-npz", "--disable-tta"] + extra)
    return root


def _stdout(fn, argv) -> str:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        fn(argv)
    return buf.getvalue()


def _assert_json_close(got, ref, path="") -> None:
    """Equal structure and values, floats within SCORE_TOL."""
    if isinstance(ref, dict):
        assert list(got) == list(ref), path
        for k in ref:
            _assert_json_close(got[k], ref[k], f"{path}/{k}")
    elif isinstance(ref, list):
        assert len(got) == len(ref), path
        for i, (a, b) in enumerate(zip(got, ref)):
            _assert_json_close(a, b, f"{path}/{i}")
    elif isinstance(ref, float):
        assert abs(got - ref) <= SCORE_TOL, (path, got, ref)
    else:
        assert got == ref, (path, got, ref)


def test_find_best_configuration_entry_matches_jax(folds, tmp_path):
    """Both folds' softmax folders (named so that sorted() reverses them:
    the ensemble is named ensemble_a_port+b_jax in both packages)."""
    argv = ["-f", f"b_jax={folds / 'jax_pred'}", f"a_port={folds / 'port_pred'}", "-r",
            str(folds / "task" / "labelsTr"), "-l", "1", "2", "3", "-o"]
    jcli.find_best_configuration_entry(argv + [str(tmp_path / "j.json")])
    cli.find_best_configuration_entry(argv + [str(tmp_path / "t.json")])
    ref = json.loads((tmp_path / "j.json").read_text())
    got = json.loads((tmp_path / "t.json").read_text())
    assert list(ref["scores"]) == ["b_jax", "a_port", "ensemble_a_port+b_jax"]
    _assert_json_close(got, ref)


@pytest.mark.parametrize("pred", ["jax_pred", "port_pred"])
def test_determine_postprocessing_entry_matches_jax(folds, tmp_path, pred):
    argv = ["-p", str(folds / pred), "-r", str(folds / "task" / "labelsTr"), "-l", "1", "2",
            "3", "-o"]
    jcli.determine_postprocessing_entry(argv + [str(tmp_path / "j.json")])
    cli.determine_postprocessing_entry(argv + [str(tmp_path / "t.json")])
    _assert_json_close(json.loads((tmp_path / "t.json").read_text()),
                       json.loads((tmp_path / "j.json").read_text()))


def _heart(shape=(2, 24, 24)):
    """Three touching squares, classes 1, 2 and 3: one component as a union."""
    gt = np.zeros(shape, np.uint8)
    gt[:, 4:11, 4:11] = 1
    gt[:, 4:11, 10:17] = 2
    gt[:, 10:17, 6:15] = 3
    return gt


def test_postprocessing_where_the_foreground_union_wins_and_where_one_class_wins():
    """Islands of classes 1 and 3 away from the heart: the foreground-union
    step wins, and no class step after it. A class-2 island touching class
    1's square (one component with the heart as a union, a second one of
    class 2): the union step changes nothing, the class-2 step wins."""
    rng = np.random.RandomState(0)
    gts, union_preds, class_preds = [], [], []
    for _ in range(3):
        gt = _heart()
        gt[:, 20 + rng.randint(3), 20 + rng.randint(3)] = 3  # a speck the truth holds too
        gts.append(gt)
        p = gt.copy()
        p[:, 21:23, 0:2] = 1
        p[:, 0:2, 21:23] = 3
        union_preds.append(p)
        q = gt.copy()
        q[:, 5:7, 2:4] = 2
        class_preds.append(q)
    results = {}
    for name, preds in (("union", union_preds), ("class", class_preds)):
        pairs = list(zip(preds, gts))
        ref = jpp.determine_postprocessing(pairs, [0, 1, 2, 3])
        got = pp.determine_postprocessing(pairs, [0, 1, 2, 3])
        _assert_json_close(got, ref)
        results[name] = got["for_which_classes"]
        for p, _ in pairs:
            np.testing.assert_array_equal(pp.apply_postprocessing(p, got),
                                          jpp.apply_postprocessing(p, ref))
    assert results == {"union": [[1, 2, 3]], "class": [2]}


def test_remove_all_but_largest_component_with_minimum_sizes_matches_jax():
    rng = np.random.RandomState(1)
    seg = (rng.rand(3, 20, 20) > 0.6).astype(np.uint8) * rng.randint(1, 4, (3, 20, 20))
    for classes, minimum in (([1, 2, 3], None), ([(1, 2), 3], {"3": 4, "(1, 2)": 2}),
                             ([[1, 3]], {"[1, 3]": 3})):
        ref = jpp.remove_all_but_largest_component(seg, classes, 0.5, minimum)
        got = pp.remove_all_but_largest_component(seg, classes, 0.5, minimum)
        np.testing.assert_array_equal(got[0], ref[0])
        assert got[1:] == ref[1:]


def test_find_best_configuration_with_ties_matches_jax(tmp_path):
    """float32 softmaxes of three configurations, one a copy of another so
    that their ensemble meets exact ties in argmax; every score, the winner
    and its postprocessing equal JAX's (written and returned)."""
    rng = np.random.RandomState(2)
    gts = [rng.randint(0, 3, (2, 12, 12)) for _ in range(3)]

    def softmax(seed):
        logits = np.random.RandomState(seed).randn(3, 3, 2, 12, 12).astype(np.float32)
        e = np.exp(logits)
        return list(e / e.sum(1, keepdims=True))

    a = softmax(3)
    configs = {"c2": softmax(4), "a": a, "b": [s[::-1].copy() for s in a]}
    ref = jsel.find_best_configuration(configs, gts, [0, 1, 2], tmp_path / "j.json")
    got = sel.find_best_configuration(configs, gts, [0, 1, 2], tmp_path / "t.json")
    _assert_json_close(got, ref)
    assert (tmp_path / "t.json").read_text() == (tmp_path / "j.json").read_text()
    for s1, s2 in zip(sel.ensemble_softmax([configs["a"], configs["b"]]),
                      jsel.ensemble_softmax([configs["a"], configs["b"]])):
        assert s1.dtype == s2.dtype == np.float32
        np.testing.assert_array_equal(s1, s2)
    assert sel.mean_fg_dice(zip(gts, gts), [1, 2]) == 1.0
    assert not sel.find_best_configuration(configs, gts, [1, 2],
                                           allow_ensembling=False)["best"].startswith("ens")


def test_region_based_evaluation_matches_jax(folds, tmp_path):
    pairs = [(str(f), str(folds / "task" / "labelsTr" / f.name))
             for f in sorted((folds / "jax_pred").glob("*.nii.gz"))]
    ref = jreg.evaluate_regions_folder(pairs, json_output_file=tmp_path / "j.json")
    got = reg.evaluate_regions_folder(pairs, json_output_file=tmp_path / "t.json")
    assert reg.CARDIAC_REGIONS == jreg.CARDIAC_REGIONS
    _assert_json_close(json.loads((tmp_path / "t.json").read_text()),
                       json.loads((tmp_path / "j.json").read_text()))
    assert set(got["mean"]) == set(ref["mean"])
    empty = reg.evaluate_regions(np.zeros((2, 8, 8), int), np.ones((2, 8, 8), int))
    assert empty["RV"]["Dice"] == 0.0 and np.isnan(empty["RV"]["HD95"])


def test_export_install_print_and_change_on_a_jax_fold_match_jax(folds, tmp_path):
    fold = folds / "jax_seg" / "fold_0"
    for mod, name in ((jcli, "j"), (cli, "t")):
        mod.export_model_entry(["-m", str(fold), "-o", str(tmp_path / f"{name}.zip")])
    members = [zipfile.ZipFile(tmp_path / f"{n}.zip").namelist() for n in ("j", "t")]
    assert members[0] == members[1] and "model_final_checkpoint.msgpack" in members[0]
    for mod, name in ((jcli, "j"), (cli, "t")):
        mod.install_model_entry([str(tmp_path / "t.zip"), "-o",
                                 str(tmp_path / "root" / name / "fold_0")])
    root = tmp_path / "root"
    for f in fold.iterdir():
        if f.name in members[0]:
            assert (root / "t" / "fold_0" / f.name).read_bytes() == f.read_bytes(), f.name
    listing = [_stdout(m.print_models_entry, ["-r", str(root)]) for m in (jcli, cli)]
    assert listing[0] == listing[1] and listing[1].count("model=unet2d") == 2
    for mod, name in ((jcli, "j"), (cli, "t")):
        mod.change_model_entry(["-m", str(root / name / "fold_0"), "-k", "unet3d"])
    got = (root / "t" / "fold_0" / "config.yaml").read_bytes()
    assert got == (root / "j" / "fold_0" / "config.yaml").read_bytes()
    assert yaml.safe_load(got)["model"] == "unet3d"
    assert _stdout(cli.print_models_entry, ["-r", str(tmp_path / "nothing")]).startswith(
        "no trained models")


def test_install_refuses_a_member_outside_the_folder_as_jax_does(tmp_path):
    bad = tmp_path / "bad.zip"
    with zipfile.ZipFile(bad, "w") as z:
        z.writestr("../model2/evil.json", "{}")
    for mod in (jcli, cli):
        with pytest.raises(SystemExit):
            mod.install_model_entry([str(bad), "-o", str(tmp_path / "model")])
    assert not (tmp_path / "model2").exists()


def test_a_port_fold_exports_installs_and_predicts_the_same_bits(folds, tmp_path):
    """The port's fold keeps its .pt checkpoints through the zip (the JAX
    command would drop them); the installed fold predicts what the original
    predicted, is listed with the JAX fold, and changes kind."""
    fold = folds / "port_seg" / "fold_0"
    cli.export_model_entry(["-m", str(fold), "-o", str(tmp_path / "port.zip")])
    members = zipfile.ZipFile(tmp_path / "port.zip").namelist()
    assert "model_final_checkpoint.pt" in members and "config.yaml" in members
    assert "debug.json" in members and "progress.png" not in members
    inst = tmp_path / "results" / "port" / "fold_0"
    cli.install_model_entry([str(tmp_path / "port.zip"), "-o", str(inst)])
    shutil.copytree(folds / "jax_seg" / "fold_0", tmp_path / "results" / "jax" / "fold_0")
    listing = _stdout(cli.print_models_entry, ["-r", str(tmp_path / "results")]).splitlines()
    assert [line.split()[0].split("/")[-2] for line in listing] == ["jax", "port"]
    cli.predict_entry(["-m", str(inst), "-i", str(folds / "task" / "imagesTr"), "-o",
                       str(tmp_path / "pred"), "--disable-tta", "--device", "cpu"])
    for f in sorted((folds / "port_pred").glob("*.nii.gz")):
        np.testing.assert_array_equal(load_nifti(tmp_path / "pred" / f.name).data_czyx,
                                      load_nifti(f).data_czyx)
    shutil.copytree(inst, tmp_path / "jax_changed")
    cli.change_model_entry(["-m", str(inst), "-k", "segflow"])
    jcli.change_model_entry(["-m", str(tmp_path / "jax_changed"), "-k", "segflow"])
    assert ((inst / "config.yaml").read_bytes()
            == (tmp_path / "jax_changed" / "config.yaml").read_bytes())


def test_plot_task_pngs_writes_the_pixels_of_plt_imsave(folds, tmp_path):
    task = folds / "task"
    jcli.plot_task_pngs_entry(["-t", str(task), "-o", str(tmp_path / "j")])
    cli.plot_task_pngs_entry(["-t", str(task), "-o", str(tmp_path / "t")])
    ref = sorted(f.name for f in (tmp_path / "j").glob("*.png"))
    assert ref and ref == sorted(f.name for f in (tmp_path / "t").glob("*.png"))
    for name in ref:
        want = np.asarray(Image.open(tmp_path / "j" / name))
        got = np.asarray(Image.open(tmp_path / "t" / name))
        assert want.shape[-1] == 4 and got.dtype == np.uint8
        np.testing.assert_array_equal(got, want)


def test_a_port_fold_carries_the_jax_folds_observability_files(folds):
    """debug.json (the same config, trainer constants and parameter count
    as the JAX fold's), network_architecture.txt, a 1000 x 600
    progress.png and the timestamped training log."""
    port, jax_fold = folds / "port_seg" / "fold_0", folds / "jax_seg" / "fold_0"
    got = json.loads((port / "debug.json").read_text())
    ref = json.loads((jax_fold / "debug.json").read_text())
    for key in ("config", "epoch", "model_class", "trainer_constants", "num_parameters"):
        assert got[key] == ref[key], key
    assert got["device"] == "cpu"
    assert (port / "network_architecture.txt").read_text().endswith(
        f"total params: {ref['num_parameters']:,}")
    assert read_png(port / "progress.png").shape == (600, 1000, 3)
    assert Image.open(jax_fold / "progress.png").size == (1000, 600)
    (log,) = read_training_logs(port)
    assert log[0].startswith("epoch 1: train ") and " fg-dice " in log[0]
