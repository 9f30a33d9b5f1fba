"""The port alone, on the CPU, from a raw synthetic task to strain: the
command line's cycle convert -> plan and preprocess -> train the planned 2D
U-Net (1 epoch, 2 steps) -> predict -> evaluate, then a tiny SegFlow trained
on the same task's cines -> predict_flow -> strain, on the 48^2 ACDC
phantoms. No JAX on this path."""

import csv
import json

import numpy as np
import torch_threads

from csof_tpu_torch.cli import main as cli
from csof_tpu_torch.config.plans import Plans
from csof_tpu_torch.utils import yaml_subset
from csof_tpu_torch.utils.nifti import load_nifti

torch_threads.pin()

SEG_CFG = {"model": "unet2d", "max_num_epochs": 1, "num_batches_per_epoch": 2,
           "num_val_batches_per_epoch": 1,
           "optim": {"optimizer": "sgd", "scheduler": "poly", "initial_lr": 0.01},
           "data": {"do_data_aug": False}}
VIDEO_CFG = {
    "model": "segflow", "max_num_epochs": 1, "num_batches_per_epoch": 2,
    "num_val_batches_per_epoch": 1,
    "segflow": {"out_encoder_dims": [8, 16], "d_model": 16, "bottleneck_heads": 2,
                "dim_feedforward": 32, "corr_radius": [2, 2], "corr_stride": [1, 1],
                "dtype": "float32"},
    "data": {"video_length": 3, "batch_size": 2, "crop_size": 32, "do_data_aug": False},
}


def test_the_port_runs_the_cycle_from_a_raw_synthetic_task(tmp_path):
    task, pre = tmp_path / "task", tmp_path / "pre"
    cli.convert_acdc_entry(["-o", str(task), "--synthetic", "2"])
    cli.plan_and_preprocess_entry(["-t", str(task), "-o", str(pre), "--num-workers", "2"])
    plans = Plans.from_json(pre / "plans_2D.json")
    assert plans.num_classes == 3 and plans.fullres_stage().patch_size == (48, 48)
    assert len(list((pre / "preprocessed_2d").glob("*.npz"))) == 4
    assert len(list((pre / "preprocessed_3d").glob("*.npz"))) == 4

    (tmp_path / "seg.yaml").write_text(yaml_subset.safe_dump(SEG_CFG))
    cli.train_entry(["-c", str(tmp_path / "seg.yaml"), "-p", str(pre), "-o", str(tmp_path / "res"),
                     "--device", "cpu"])
    fold = tmp_path / "res" / "fold_0"
    assert (fold / "model_final_checkpoint.pt").is_file()
    assert Plans.from_json(fold / "plans.json") == plans
    cli.predict_entry(["-m", str(fold), "-i", str(task / "imagesTr"), "-o", str(tmp_path / "pred"),
                       "--disable-tta", "--device", "cpu"])
    preds = sorted((tmp_path / "pred").glob("*.nii.gz"))
    assert len(preds) == 4
    ref = load_nifti(task / "labelsTr" / preds[0].name).data_czyx
    assert load_nifti(preds[0]).data_czyx.shape == ref.shape
    cli.evaluate_entry(["-p", str(tmp_path / "pred"), "-r", str(task / "labelsTr"), "-l", "1", "2",
                        "3", "-o", str(tmp_path / "summary.json")])
    summary = json.loads((tmp_path / "summary.json").read_text())
    assert len(summary["all"]) == 4 and set(summary["mean"]) == {"1", "2", "3"}

    (tmp_path / "video.yaml").write_text(yaml_subset.safe_dump(VIDEO_CFG))
    cli.train_entry(["-c", str(tmp_path / "video.yaml"), "-p", str(pre), "-t", str(task),
                     "-o", str(tmp_path / "flow"), "--device", "cpu"])
    cli.predict_flow_entry(["-m", str(tmp_path / "flow" / "fold_0"), "-t", str(task),
                            "-o", str(tmp_path / "tree"), "--disable-tta", "--device", "cpu"])
    cli.strain_entry(["-i", str(tmp_path / "tree"), "--device", "cpu"])
    report = json.loads((tmp_path / "tree" / "analysis.json").read_text())
    assert sorted(report) == ["patient001", "patient002"]
    for entry in report.values():
        assert np.isfinite(entry["jacobian"]["global"]["abs_mean_j_minus_1"])
        assert len(entry["strain"]["lv_strain_mean"]) == 8  # the phantoms' 8 frames
    with open(tmp_path / "tree" / "analysis.csv") as f:
        assert next(csv.reader(f)) == ["case", "structure", "frame", "strain_pct"]
    assert len(list((tmp_path / "tree" / "strain_curves").glob("*.npz"))) == 2
