"""Command-line entries of the port (port of ``csof_tpu/cli/main.py``).

The JAX package's arguments, plus ``--device`` on the entries that run a
model (default ``cuda``; without a CUDA device the entry refuses to run
unless given ``--device cpu``). A results folder ``fold_N/`` of either
package (``config.yaml``, ``plans.json``, ``meta.json``, the checkpoint
triad as ``.pt`` or flax ``.msgpack``) restores in both.

Console scripts (``pyproject.toml``), or ``python -m csof_tpu_torch.cli.main
<command> [arguments]``:

  csof_torch_train         train the 2D U-Net or SegFlow from an experiment YAML
                           (``--validation-only``: score the fold from its checkpoint)
  csof_torch_predict       sliding-window U-Net segmentation of a folder of NIfTIs
  csof_torch_predict_flow  SegFlow over every cine of a task: Flow/Registered/Segmentation
  csof_torch_evaluate      Dice / Hausdorff / surface metrics of a folder: summary.json
  csof_torch_ensemble      average the softmax npz of several prediction folders
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np
import torch


def _device(p: argparse.ArgumentParser, name: str) -> torch.device:
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        p.error(f"--device {name}: there is no CUDA device; pass --device cpu to run on the CPU")
    return device


def _add_device(p: argparse.ArgumentParser) -> None:
    p.add_argument("--device", default="cuda", help="torch device to run on (default: cuda)")


def train_entry(argv=None):
    from csof_tpu_torch.config.experiment import ExperimentConfig, load_experiment_config
    from csof_tpu_torch.config.plans import Plans
    from csof_tpu_torch.data.dataset import do_split, load_dataset, unpack_dataset
    from csof_tpu_torch.data.loaders import Prefetcher, SegPatchLoader
    from csof_tpu_torch.training.restore import save_trainer_sidecar
    from csof_tpu_torch.training.trainer import Trainer

    p = argparse.ArgumentParser("csof_torch_train")
    p.add_argument("-c", "--config", help="experiment YAML (defaults used if absent)")
    p.add_argument("-p", "--preprocessed", required=True,
                   help="preprocessed root (plans_2D.json, preprocessed_2d/)")
    p.add_argument("-t", "--task-dir", help="converted task dir (required for video models)")
    p.add_argument("-o", "--output", required=True)
    p.add_argument("-f", "--fold", type=int, default=0)
    p.add_argument("--max-epochs", type=int)
    p.add_argument("--continue-training", action="store_true")
    p.add_argument("--validation-only", action="store_true",
                   help="skip training; run fold validation from the checkpoint")
    _add_device(p)
    a = p.parse_args(argv)
    device = _device(p, a.device)

    config = load_experiment_config(a.config) if a.config else ExperimentConfig(model="unet2d")
    if a.fold is not None:
        config.fold = a.fold
    if config.model in ("segflow", "voxelmorph", "raft"):
        if not a.task_dir:
            p.error(f"model '{config.model}' trains on cine videos: pass -t/--task-dir")
        return _train_video(a, config, device)
    pre_root = Path(a.preprocessed)
    key = "2d" if config.model == "unet2d" else "3d"
    plans = Plans.from_json(pre_root / f"plans_{key.upper()}.json")
    pre_dir = pre_root / f"preprocessed_{key}"
    unpack_dataset(pre_dir)
    ds = load_dataset(pre_dir)
    tr_keys, va_keys = do_split(list(ds), config.fold, splits_file=pre_root / "splits.pkl")
    sp = plans.fullres_stage()
    out = Path(a.output) / f"fold_{config.fold}"
    trainer = Trainer(config, out, plans=plans, device=device,
                      for_training=not a.validation_only).initialize()
    save_trainer_sidecar(out, config, plans, plans.num_classes_with_background)
    if a.validation_only:
        from csof_tpu_torch.training.validation import validate_fold

        trainer.load_checkpoint()
        summary = validate_fold(trainer, plans, pre_dir, config.fold, out / "validation_raw",
                                splits_file=pre_root / "splits.pkl")
        print(json.dumps(summary["mean"], indent=2))
        return
    if a.continue_training:
        trainer.load_checkpoint()
    tr_loader = SegPatchLoader({k: ds[k] for k in tr_keys}, sp.patch_size, sp.batch_size,
                               num_modalities=plans.num_modalities, seed=config.seed)
    va_loader = SegPatchLoader({k: ds[k] for k in va_keys}, sp.patch_size, sp.batch_size,
                               num_modalities=plans.num_modalities, seed=config.seed + 1)
    # the JAX entry spends the loader's first batch on initialising its model;
    # drawing it here keeps one seed's training batches the same in both
    next(tr_loader)
    train_it = Prefetcher(tr_loader)  # the same batches, assembled while the device runs
    try:
        trainer.run_training(train_it, iter(va_loader), max_epochs=a.max_epochs)
    finally:
        train_it.close()
    print(f"training done -> {out}")


def _train_video(a, config, device):
    """The video branch of csof_torch_train (SegFlow)."""
    from csof_tpu_torch.data.loaders import VideoChunkLoader
    from csof_tpu_torch.data.video_dataset import build_video_datasets, split_videos
    from csof_tpu_torch.training.restore import save_trainer_sidecar
    from csof_tpu_torch.training.trainer import Trainer

    videos = build_video_datasets(a.task_dir)
    if not videos:
        raise SystemExit(f"no cine videos found under {a.task_dir}/cine")
    tr_videos, va_videos = split_videos(videos, config.fold)

    def make_loader(vids, seed):
        return VideoChunkLoader(vids, video_length=config.data.video_length,
                                batch_size=config.data.batch_size,
                                crop_size=config.data.crop_size, seed=seed)

    out = Path(a.output) / f"fold_{config.fold}"
    trainer = Trainer(config, out, num_classes=4, device=device).initialize()
    save_trainer_sidecar(out, config, None, 4)
    if a.continue_training:
        trainer.load_checkpoint()
    trainer.run_training(make_loader(tr_videos, config.seed),
                         make_loader(va_videos or tr_videos, config.seed + 1),
                         max_epochs=a.max_epochs)
    print(f"training done -> {out}")


def predict_entry(argv=None):
    from csof_tpu_torch.config.plans import Plans
    from csof_tpu_torch.inference.predictor import predict_case
    from csof_tpu_torch.training.restore import restore_trainer

    p = argparse.ArgumentParser("csof_torch_predict")
    p.add_argument("-m", "--model-dir", required=True, help="fold_N training output dir")
    p.add_argument("-i", "--input", required=True, help="folder of *_0000.nii.gz")
    p.add_argument("-o", "--output", required=True)
    p.add_argument("--step-size", type=float, default=0.5)
    p.add_argument("--disable-tta", action="store_true")
    p.add_argument("--checkpoint", default=None)
    p.add_argument("--save-npz", action="store_true",
                   help="also dump the softmax npz for csof_torch_ensemble")
    p.add_argument("--num-parts", type=int, default=1,
                   help="shard the case list across N workers")
    p.add_argument("--part-id", type=int, default=0)
    _add_device(p)
    a = p.parse_args(argv)
    device = _device(p, a.device)

    model_dir = Path(a.model_dir)
    plans = Plans.from_json(model_dir / "plans.json")
    in_dir, out_dir = Path(a.input), Path(a.output)
    out_dir.mkdir(parents=True, exist_ok=True)
    case_files: dict[str, list[Path]] = {}
    for f in sorted(in_dir.glob("*_*.nii.gz")):
        case_files.setdefault(f.name.rsplit("_", 1)[0], []).append(f)
    names = sorted(case_files)[a.part_id::a.num_parts]
    if not names:
        p.error(f"no cases for part {a.part_id}/{a.num_parts} in {in_dir}")
    net = restore_trainer(model_dir, checkpoint_name=a.checkpoint, device=device).model.eval()
    for case in names:
        predict_case(plans, net, case_files[case], out_dir / f"{case}.nii.gz",
                     step_size=a.step_size, do_mirroring=not a.disable_tta,
                     save_npz=a.save_npz, device=device)
        print(f"predicted {case}")


def predict_flow_entry(argv=None):
    """Full-cine segmentation and flow of every cine of a task, written as
    the Flow/Registered/Segmentation trees; a concat or concat_cm checkpoint
    serves under the fused_cm remap (kernel K3), as the JAX entry serves it."""
    from csof_tpu_torch.data.video_dataset import build_video_datasets, put_ed_first
    from csof_tpu_torch.inference.flow_predictor import FlowPredictor, predict_and_export_case
    from csof_tpu_torch.inference.serving import apply_serving_config
    from csof_tpu_torch.models.segflow import SegFlow
    from csof_tpu_torch.training.restore import restore_trainer

    p = argparse.ArgumentParser("csof_torch_predict_flow")
    p.add_argument("-m", "--model-dir", required=True, help="fold_N segflow training dir")
    p.add_argument("-t", "--task-dir", required=True, help="converted task dir with cine/")
    p.add_argument("-o", "--output", required=True)
    p.add_argument("--crop-size", type=int, default=None)
    p.add_argument("--disable-tta", action="store_true")
    _add_device(p)
    a = p.parse_args(argv)
    device = _device(p, a.device)

    videos = build_video_datasets(a.task_dir)
    if not videos:
        p.error(f"no cine videos under {a.task_dir}/cine")
    trainer = restore_trainer(a.model_dir, device=device)
    net = trainer.model
    if isinstance(net, SegFlow):
        # the serving remap is parameter-compatible: the same state dict loads
        served = SegFlow(apply_serving_config(net.cfg), net.num_classes).to(device)
        served.load_state_dict(net.state_dict())
        net = served
    cs = a.crop_size or trainer.config.data.crop_size
    predictor = FlowPredictor(net.eval(), crop_size=cs, do_mirroring=not a.disable_tta,
                              device=device)
    for pid, v in videos.items():
        frames, _, _ = put_ed_first(v["frames"], v["ed"])  # the flow anchors at ED
        predict_and_export_case(predictor, frames, {}, a.output, pid)
        print(f"predicted {pid}")


def evaluate_entry(argv=None):
    from csof_tpu_torch.evaluation.evaluator import aggregate_scores

    p = argparse.ArgumentParser("csof_torch_evaluate")
    p.add_argument("-p", "--pred", required=True)
    p.add_argument("-r", "--ref", required=True)
    p.add_argument("-l", "--labels", type=int, nargs="+", required=True)
    p.add_argument("-o", "--output", default=None)
    p.add_argument("--nsd-threshold", type=float, nargs="*", default=[],
                   help="also report the normalised surface Dice at these tolerances in mm")
    a = p.parse_args(argv)
    pred_dir, ref_dir = Path(a.pred), Path(a.ref)
    pairs = [(str(f), str(ref_dir / f.name)) for f in sorted(pred_dir.glob("*.nii.gz"))
             if (ref_dir / f.name).exists()]
    if not pairs:
        p.error(f"no matching prediction/reference pairs between {pred_dir} and {ref_dir}")
    out = a.output or (pred_dir / "summary.json")
    res = aggregate_scores(pairs, a.labels, json_output_file=out,
                           nsd_thresholds=tuple(a.nsd_threshold))
    print(json.dumps(res["mean"], indent=2))


def ensemble_entry(argv=None):
    p = argparse.ArgumentParser("csof_torch_ensemble")
    p.add_argument("-f", "--folders", nargs="+", required=True,
                   help="folders with <case>.npz softmax dumps")
    p.add_argument("-o", "--output", required=True)
    a = p.parse_args(argv)
    out = Path(a.output)
    out.mkdir(parents=True, exist_ok=True)
    folders = [Path(f) for f in a.folders]
    cases = sorted({f.stem for f in folders[0].glob("*.npz")})
    for case in cases:
        acc = None
        for folder in folders:
            sm = np.load(folder / f"{case}.npz")["softmax"]
            acc = sm if acc is None else acc + sm
        acc = acc / len(folders)
        np.savez_compressed(out / f"{case}.npz", softmax=acc)
        np.save(out / f"{case}_seg.npy", acc.argmax(0).astype(np.uint8))
    print(f"ensembled {len(cases)} cases from {len(folders)} models")


COMMANDS = {"train": train_entry, "predict": predict_entry, "predict_flow": predict_flow_entry,
            "evaluate": evaluate_entry, "ensemble": ensemble_entry}


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else list(argv)
    if not argv or argv[0] not in COMMANDS:
        raise SystemExit(f"usage: python -m csof_tpu_torch.cli.main {{{','.join(COMMANDS)}}} "
                         "[arguments]")
    COMMANDS[argv[0]](argv[1:])


if __name__ == "__main__":
    main()
