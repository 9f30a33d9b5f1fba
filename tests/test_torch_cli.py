"""The port's command line (``csof_tpu_torch/cli/main.py``) against the JAX
package's, on 2 synthetic ACDC patients (as ``tests/test_e2e_video_cli.py``
drives the JAX one). One module fixture runs the JAX CLI once: it trains a
tiny SegFlow (float32) and serves it. The port's ``predict_flow_entry``
then restores that msgpack folder with ``--device cpu``:

- Flow and Registered files within 1e-4 of the JAX CLI's;
- segmentations agree on at least 99.9 % of voxels, and where they differ
  the JAX softmax's top two classes are within 1e-3;
- a port-trained folder serves through the port's ``predict_flow_entry``,
  and the JAX package reads its ``config.yaml``.

Without a CUDA device an entry refuses to run unless given ``--device cpu``,
and the port imports none of jax, flax, optax, msgpack, yaml or csof_tpu.
The U-Net entries (``csof_predict``, ``--validation-only``,
``csof_evaluate``, ``csof_ensemble``) are in ``test_torch_cli_unet.py``, so
that the two halves run on two test workers.
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch_threads
import yaml

from csof_tpu.cli import main as jcli
from csof_tpu.config.experiment import load_experiment_config as jax_load_config
from csof_tpu_torch.cli import main as cli
from csof_tpu_torch.config.experiment import load_experiment_config
from csof_tpu_torch.utils.nifti import load_nifti

torch_threads.pin()

FLOW_TOL = 1e-4  # Flow and Registered, float32: the same math in another order
AGREE = 0.999  # segmentation voxels that must agree
GAP = 1e-3  # where they do not, the JAX softmax's top-two gap is below this

VIDEO_CFG = {
    "model": "segflow", "max_num_epochs": 1, "num_batches_per_epoch": 2,
    "num_val_batches_per_epoch": 1,
    "segflow": {"out_encoder_dims": [8, 16], "d_model": 16, "bottleneck_heads": 2,
                "dim_feedforward": 32, "corr_radius": [2, 2], "corr_stride": [1, 1],
                "dtype": "float32"},
    "data": {"video_length": 3, "batch_size": 2, "crop_size": 32, "do_data_aug": False},
    "loss_weights": {"segmentation": 1.0},
}


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli")
    task = root / "task"
    jcli.convert_acdc_entry(["-o", str(task), "--synthetic", "2"])
    (root / "video.yaml").write_text(yaml.safe_dump(VIDEO_CFG))
    jcli.train_entry(["-c", str(root / "video.yaml"), "-p", str(root / "unused"), "-t", str(task),
                      "-o", str(root / "jax_flow"), "-f", "0", "--max-epochs", "1"])
    jcli.predict_flow_entry(["-m", str(root / "jax_flow" / "fold_0"), "-t", str(task),
                             "-o", str(root / "jax_flow_out")])
    return root


def _nii(path: Path) -> np.ndarray:
    return load_nifti(path).data_czyx


def _assert_segs_agree(got: np.ndarray, ref: np.ndarray, softmax_fn) -> None:
    """At least AGREE of the voxels equal; where they differ the JAX softmax
    (C, *shape), asked for only then, has its top two within GAP."""
    assert got.shape == ref.shape
    differ = got != ref
    assert 1.0 - differ.mean() >= AGREE, f"{differ.sum()} of {differ.size} voxels differ"
    if differ.any():
        top2 = np.sort(softmax_fn(), axis=0)[-2:]
        gap = (top2[1] - top2[0])[differ]
        assert gap.max() < GAP, f"differing voxels with a JAX softmax gap up to {gap.max()}"


def _jax_flow_softmax(root: Path, pid: str) -> np.ndarray:
    """The JAX CLI's softmax of one cine, (C, T, D, H, W): its predict_flow
    body with the predictor's result kept."""
    import numpy as _np

    from csof_tpu.data.video_dataset import build_video_datasets, put_ed_first
    from csof_tpu.inference.flow_predictor import FlowPredictor
    from csof_tpu.inference.serving import apply_serving_config
    from csof_tpu.models.segflow import SegFlow
    from csof_tpu.training.restore import restore_trainer

    folder = root / "jax_flow" / "fold_0"
    cfg = jax_load_config(folder / "config.yaml")
    t, cs = cfg.data.video_length, cfg.data.crop_size
    example = {"video": _np.zeros((1, t, cs, cs, 1), _np.float32),
               "seg": _np.zeros((1, t, cs, cs), _np.int32),
               "labeled_mask": _np.zeros((1, t), _np.float32)}
    tr = restore_trainer(folder, example)
    net = SegFlow(cfg=apply_serving_config(tr.model.cfg), num_classes=tr.model.num_classes)
    params = tr.state.params
    video = build_video_datasets(root / "task")[pid]
    frames, _, _ = put_ed_first(video["frames"], video["ed"])
    return FlowPredictor(lambda v: net.apply(params, v), crop_size=cs).predict_video(
        frames)["softmax"]


def test_predict_flow_restores_the_jax_folder(jax_run):
    out = jax_run / "port_flow_out"
    cli.predict_flow_entry(["-m", str(jax_run / "jax_flow" / "fold_0"), "-t",
                            str(jax_run / "task"), "-o", str(out), "--device", "cpu"])
    ref_root = jax_run / "jax_flow_out"
    pids = sorted(f.stem for f in (ref_root / "Flow").glob("*.npz"))
    assert pids and pids == sorted(f.stem for f in (out / "Flow").glob("*.npz"))
    for pid in pids:
        got, ref = (np.load(r / "Flow" / f"{pid}.npz")["flow"] for r in (out, ref_root))
        np.testing.assert_allclose(got, ref, atol=FLOW_TOL, rtol=0, err_msg=pid)
        got, ref = (_nii(r / "Registered" / f"{pid}.nii.gz") for r in (out, ref_root))
        np.testing.assert_allclose(got, ref, atol=FLOW_TOL, rtol=0, err_msg=pid)
        got, ref = (_nii(r / "Segmentation" / f"{pid}.nii.gz") for r in (out, ref_root))
        _assert_segs_agree(got, ref, lambda pid=pid: _jax_flow_softmax(jax_run, pid))


def test_a_port_trained_folder_round_trips(jax_run, tmp_path):
    cli.train_entry(["-c", str(jax_run / "video.yaml"), "-p", str(tmp_path / "unused"), "-t",
                     str(jax_run / "task"), "-o", str(tmp_path / "port_flow"), "-f", "0",
                     "--max-epochs", "1", "--device", "cpu"])
    fold = tmp_path / "port_flow" / "fold_0"
    for name in ("model_final_checkpoint.pt", "model_best.pt", "config.yaml", "meta.json"):
        assert (fold / name).is_file(), name
    # the JAX package reads the port's config.yaml, and both read the same config
    assert jax_load_config(fold / "config.yaml") == jax_load_config(jax_run / "video.yaml")
    assert load_experiment_config(fold / "config.yaml") == load_experiment_config(
        jax_run / "video.yaml")
    cli.predict_flow_entry(["-m", str(fold), "-t", str(jax_run / "task"), "-o",
                            str(tmp_path / "out"), "--disable-tta", "--device", "cpu"])
    for sub, pattern in (("Flow", "*.npz"), ("Registered", "*.nii.gz"),
                         ("Segmentation", "*.nii.gz")):
        files = sorted((tmp_path / "out" / sub).glob(pattern))
        assert len(files) == 2, sub
    flow = np.load(files[0].parent.parent / "Flow" / (files[0].name.split(".")[0] + ".npz"))
    assert np.isfinite(flow["flow"]).all()


def test_an_entry_refuses_to_run_without_a_card_unless_told(monkeypatch, tmp_path, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for entry, args in ((cli.predict_flow_entry, ["-m", "m", "-t", "t", "-o", "o"]),
                        (cli.predict_entry, ["-m", "m", "-i", "i", "-o", "o"]),
                        (cli.train_entry, ["-p", "p", "-o", str(tmp_path)])):
        with pytest.raises(SystemExit):
            entry(args)
        assert "--device cpu" in capsys.readouterr().err
    with pytest.raises(SystemExit, match="usage"):
        cli.main(["nonsense"])


def test_the_port_imports_no_jax_flax_optax_msgpack_yaml_or_the_jax_package():
    """A fresh interpreter with those modules (and matplotlib, tensorboardX
    and sklearn) blocked imports every module of the port and chip_smoke.py."""
    repo = Path(__file__).resolve().parents[1]
    code = f"""
import importlib, pkgutil, sys
for name in ("jax", "jaxlib", "flax", "optax", "msgpack", "yaml", "csof_tpu", "matplotlib",
             "tensorboardX", "sklearn"):
    sys.modules[name] = None
sys.path.insert(0, {str(repo)!r})
import csof_tpu_torch
names = [m.name for m in pkgutil.walk_packages(csof_tpu_torch.__path__, "csof_tpu_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
import csof_tpu_torch.cli.main
print(len(names))
"""
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=repo, timeout=120)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.split()[-1]) > 40
