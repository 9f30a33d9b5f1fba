"""Command-line entries of the port (port of ``csof_tpu/cli/main.py``).

The JAX package's arguments, plus ``--device`` on the entries that run a
model or the flow analysis (default ``cuda``; without a CUDA device the
entry refuses to run unless given ``--device cpu``); the data plane's
entries do no device work and take none. A results folder ``fold_N/`` of either
package (``config.yaml``, ``plans.json``, ``meta.json``, the checkpoint
triad as ``.pt`` or flax ``.msgpack``) restores in both.

Console scripts (``pyproject.toml``), or ``python -m csof_tpu_torch.cli.main
<command> [arguments]``:

  csof_torch_convert_acdc           raw ACDC (or N synthetic phantoms) -> task layout
  csof_torch_convert_mnms           raw M&Ms (or N synthetic phantoms) -> task layout
  csof_torch_convert_decathlon_task a Decathlon task (4D multi-modality) -> task layout
  csof_torch_plan_and_preprocess    crop, analyze, plan (2D and 3D), preprocess
  csof_torch_train         train the 2D or 3D U-Net, SegFlow, RAFT or VoxelMorph from an
                           experiment YAML
                           (``--validation-only``: score the fold from its checkpoint)
  csof_torch_predict       sliding-window U-Net segmentation of a folder of NIfTIs
  csof_torch_predict_flow  SegFlow over every cine of a task: Flow/Registered/Segmentation
  csof_torch_evaluate      Dice / Hausdorff / surface metrics of a folder: summary.json
  csof_torch_ensemble      average the softmax npz of several prediction folders
  csof_torch_strain        jacobian, strain and contour tracking of a Flow tree
  csof_torch_jacobian      the same analysis (the JAX package's alias)
  (strain_curve_metric)    AI-vs-GT strain curve metrics, through the dispatch only
  csof_torch_find_best_configuration  the best configuration or pairwise ensemble by
                           validation Dice, from softmax npz folders (name=path)
  csof_torch_determine_postprocessing keep-largest-component decision from validation
                           predictions: postprocessing.json
  csof_torch_export_model_to_zip      a trained folder's checkpoints and sidecars as a zip
  csof_torch_install_model_from_zip   unpack such a zip into a model folder
  csof_torch_print_available_models   the trained folders under a results root
  csof_torch_change_model  rewrite the model kind in a folder's config.yaml
  csof_torch_plot_task_pngs           an image + label overlay PNG per case of a raw task

The last seven do no device work and take no ``--device``.
``csof_torch_train`` under ``torchrun`` (its variables ``WORLD_SIZE``,
``RANK``, ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT`` set) trains data
parallel: it joins the process group (NCCL with ``cuda:LOCAL_RANK`` a rank,
gloo under ``--device cpu``), trains on the mesh of the config's
``mesh_data`` / ``mesh_model``, writes its files from rank 0 and leaves the
group at the end; without those variables it trains in one process. A folder the
port trained holds ``model_*.pt`` where the JAX package's holds
``model_*.msgpack``: export keeps both, the listing finds both, and a JAX
folder exports and lists exactly as in the JAX package.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
from pathlib import Path

import numpy as np


def _device(p: argparse.ArgumentParser, name: str):
    # torch is imported here, not with the module, so that the data plane's
    # worker processes, which re-import the main module, start without it
    from csof_tpu_torch.utils.device import resolve_device

    try:
        return resolve_device(name)
    except ValueError:
        p.error(f"--device {name}: there is no CUDA device; pass --device cpu to run on the CPU")


def _add_device(p: argparse.ArgumentParser) -> None:
    p.add_argument("--device", default="cuda", help="torch device to run on (default: cuda)")


@contextlib.contextmanager
def _process_group(device):
    """Under torchrun's variables, join the process group (NCCL on
    ``cuda:LOCAL_RANK``, gloo on the CPU) for the body and leave it after;
    yields the rank's device. A group the caller started is used and left
    to it; without the variables, nothing changes."""
    import torch
    import torch.distributed as dist

    if dist.is_initialized() or "WORLD_SIZE" not in os.environ:
        yield device
        return
    if device.type == "cuda":
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
        torch.cuda.set_device(device)
    dist.init_process_group("nccl" if device.type == "cuda" else "gloo")
    try:
        yield device
    finally:
        dist.destroy_process_group()


def convert_acdc_entry(argv=None):
    from csof_tpu_torch.data.conversion.acdc import convert_acdc, make_synthetic_acdc

    p = argparse.ArgumentParser("csof_torch_convert_acdc")
    p.add_argument("-i", "--input", help="ACDC root (patient*/ dirs)")
    p.add_argument("-o", "--output", required=True, help="task output dir")
    p.add_argument("--synthetic", type=int, default=0, help="generate N phantom patients instead")
    p.add_argument("--no-norm", action="store_true",
                   help="NoNorm task variant: modality 'noNorm'")
    p.add_argument("--export-unlabeled", action="store_true",
                   help="also export unannotated cine frames as <pid>_frame<NN>_u")
    a = p.parse_args(argv)
    if not a.input and not a.synthetic:
        p.error("provide -i/--input (ACDC root) or --synthetic N")
    src = a.input
    if a.synthetic:
        src = Path(a.output).parent / "synthetic_raw"
        make_synthetic_acdc(src, num_patients=a.synthetic)
    dj = convert_acdc(src, a.output, no_norm=a.no_norm, export_unlabeled=a.export_unlabeled)
    print(f"converted {dj['numTraining']} cases -> {a.output}")


def convert_mnms_entry(argv=None):
    from csof_tpu_torch.data.conversion.mnms import convert_mnms, make_synthetic_mnms

    p = argparse.ArgumentParser("csof_torch_convert_mnms")
    p.add_argument("-i", "--input", help="M&Ms root (walked for *_sa[_gt].nii.gz)")
    p.add_argument("--info", help="M&Ms Dataset Information (.csv or .xlsx)")
    p.add_argument("-o", "--output", required=True, help="task output dir")
    p.add_argument("--synthetic", type=int, default=0, help="generate N phantom patients instead")
    a = p.parse_args(argv)
    if a.synthetic:
        src = Path(a.output).parent / "synthetic_mnms_raw"
        info = make_synthetic_mnms(src, num_patients=a.synthetic)
    elif a.input and a.info:
        src, info = a.input, a.info
    else:
        p.error("provide -i/--input + --info, or --synthetic N")
    dj = convert_mnms(src, info, a.output)
    print(f"converted {dj['numTraining']} cases -> {a.output}")


def plan_and_preprocess_entry(argv=None):
    """Crop the task's training cases, analyze them, plan the 2D and 3D
    U-Nets and preprocess each plan's fullres stage: ``<out>/cropped``,
    ``plans_2D.json``, ``plans_3D.json``, ``preprocessed_{2d,3d}/``; 3D plans
    with a cascade stage ({0: lowres, 1: fullres}) also preprocess stage 0
    into ``preprocessed_3d_lowres/``. (The JAX entry preprocesses stage 0
    into ``preprocessed_3d/``, the lowres data that training then cuts the
    fullres patch from, F10; one-stage plans write the same files in
    both.)"""
    from csof_tpu_torch.data.analysis import analyze_dataset
    from csof_tpu_torch.data.cropping import run_cropping
    from csof_tpu_torch.data.planning import plan_and_write
    from csof_tpu_torch.data.preprocessing import Preprocessor

    p = argparse.ArgumentParser("csof_torch_plan_and_preprocess")
    p.add_argument("-t", "--task-dir", required=True)
    p.add_argument("-o", "--output", required=True, help="preprocessed output root")
    p.add_argument("--num-workers", type=int, default=4)
    a = p.parse_args(argv)
    task_dir, out = Path(a.task_dir), Path(a.output)
    dj = json.loads((task_dir / "dataset.json").read_text())
    num_mod = len(dj["modality"])
    cases = []
    for item in dj["training"]:
        case = Path(item["image"]).name.replace(".nii.gz", "")
        imgs = sorted((task_dir / "imagesTr").glob(f"{case}_*.nii.gz"))
        label = task_dir / "labelsTr" / f"{case}.nii.gz"
        cases.append((case, [str(i) for i in imgs], str(label) if label.exists() else None))
    cropped = out / "cropped"
    run_cropping(cases, cropped, num_workers=a.num_workers)
    props = analyze_dataset(cropped, num_modalities=num_mod, num_workers=a.num_workers)
    plans = plan_and_write(props, task_dir.name, out, num_mod,
                           {int(k): v for k, v in dj["modality"].items()})
    for key, pl in plans.items():
        folders = {f"preprocessed_{key}": pl.fullres_stage_id}
        if len(pl.plans_per_stage) > 1:
            folders[f"preprocessed_{key}_lowres"] = 0
        for name, stage in folders.items():
            (out / name).mkdir(parents=True, exist_ok=True)
            Preprocessor(pl, stage=stage).run(cropped, out / name, num_workers=a.num_workers)
    print(f"planned + preprocessed {len(cases)} cases -> {out}")


def convert_decathlon_entry(argv=None):
    """A Medical Segmentation Decathlon task (4D multi-modality images) to
    the raw layout: one 3D file per modality (``_0000``, ``_0001``, ...),
    labels as uint8, dataset.json with the training list."""
    from csof_tpu_torch.utils.nifti import load_nifti, save_nifti

    p = argparse.ArgumentParser("csof_torch_convert_decathlon_task")
    p.add_argument("-i", "--input", required=True, help="decathlon task folder")
    p.add_argument("-o", "--output", required=True)
    a = p.parse_args(argv)
    src, out = Path(a.input), Path(a.output)
    images_tr, labels_tr = out / "imagesTr", out / "labelsTr"
    images_tr.mkdir(parents=True, exist_ok=True)
    labels_tr.mkdir(parents=True, exist_ok=True)
    cases = []
    for f in sorted((src / "imagesTr").glob("*.nii.gz")):
        if f.name.startswith("."):
            continue  # the Decathlon archives hold ._ AppleDouble files
        case = f.name.replace(".nii.gz", "")
        img = load_nifti(f)
        vol = img.data_czyx  # (z, y, x), or (m, z, y, x) with m modalities
        mods = vol[None] if vol.ndim == 3 else vol
        for m in range(mods.shape[0]):
            save_nifti(mods[m], images_tr / f"{case}_{m:04d}.nii.gz", affine=img.affine)
        lab = src / "labelsTr" / f.name
        if lab.exists():
            li = load_nifti(lab)
            save_nifti(li.data_czyx, labels_tr / f.name, affine=li.affine, dtype=np.uint8)
        cases.append(case)
    dataset = (json.loads((src / "dataset.json").read_text())
               if (src / "dataset.json").exists() else {})
    dataset["training"] = [{"image": f"./imagesTr/{c}.nii.gz", "label": f"./labelsTr/{c}.nii.gz"}
                           for c in cases]
    (out / "dataset.json").write_text(json.dumps(dataset, indent=2))
    print(f"converted {len(cases)} cases -> {out}")


def train_entry(argv=None):
    from csof_tpu_torch.config.experiment import ExperimentConfig, load_experiment_config

    p = argparse.ArgumentParser("csof_torch_train")
    p.add_argument("-c", "--config", help="experiment YAML (defaults used if absent)")
    p.add_argument("-p", "--preprocessed", required=True,
                   help="preprocessed root (plans_{2D,3D}.json, preprocessed_{2d,3d}/)")
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
    video = config.model in ("segflow", "voxelmorph", "raft")
    if video and not a.task_dir:
        p.error(f"model '{config.model}' trains on cine videos: pass -t/--task-dir")
    with _process_group(device) as device:
        return (_train_video if video else _train_unet)(a, config, device)


def _train_unet(a, config, device):
    """The U-Net branch of csof_torch_train: SegPatchLoader batches of the
    preprocessed folds."""
    from csof_tpu_torch.config.plans import Plans
    from csof_tpu_torch.data.dataset import do_split, load_dataset, unpack_dataset
    from csof_tpu_torch.data.loaders import Prefetcher, SegPatchLoader
    from csof_tpu_torch.training.restore import save_trainer_sidecar
    from csof_tpu_torch.training.trainer import Trainer

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
    if trainer.is_main_process:
        save_trainer_sidecar(out, config, plans, plans.num_classes_with_background)
    if a.validation_only:
        if not trainer.is_main_process:
            return  # rank 0 scores the fold
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
    """The video branch of csof_torch_train: SegFlow on the chunks, RAFT on
    (frame 0, last frame) pairs, VoxelMorph on (moving = last frame, fixed =
    frame 0), as the JAX entry's ``to_model_batch`` maps them."""
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

    def model_batches(loader):
        for batch in loader:
            v = batch["video"]
            if config.model == "raft":
                batch = {"image1": v[:, 0], "image2": v[:, -1]}
            elif config.model == "voxelmorph":
                batch = {"moving": v[:, -1], "fixed": v[:, 0]}
            yield batch

    out = Path(a.output) / f"fold_{config.fold}"
    trainer = Trainer(config, out, num_classes=4, device=device).initialize()
    if trainer.is_main_process:
        save_trainer_sidecar(out, config, None, 4)
    if a.continue_training:
        trainer.load_checkpoint()
    trainer.run_training(model_batches(make_loader(tr_videos, config.seed)),
                         model_batches(make_loader(va_videos or tr_videos, config.seed + 1)),
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


def _strain(argv, prog: str):
    from csof_tpu_torch.analysis.flow_analysis import (
        analyze_prediction_tree,
        export_strain_curves,
        write_strain_csv,
    )

    p = argparse.ArgumentParser(prog)
    p.add_argument("-i", "--input", required=True,
                   help="prediction tree root (Flow/ Registered/ Segmentation/)")
    p.add_argument("-o", "--output", default=None)
    p.add_argument("--gt-seg", default=None,
                   help="folder of per-case GT 4D label NIfTIs for contour tracking error")
    _add_device(p)
    a = p.parse_args(argv)
    device = _device(p, a.device)
    out = a.output or (Path(a.input) / "analysis.json")
    report = analyze_prediction_tree(a.input, out, gt_seg_dir=a.gt_seg, device=device)
    write_strain_csv(report, Path(out).with_suffix(".csv"))
    # one curve file per case for strain_curve_metric
    n = export_strain_curves(report, Path(a.input) / "strain_curves")
    print(f"analysis -> {out} ({n} strain-curve files)")


def strain_entry(argv=None):
    """Jacobian, strain curves and (with --gt-seg) contour tracking of a
    Flow/Registered/Segmentation tree: analysis.json, analysis.csv and
    strain_curves/<case>.npz."""
    _strain(argv, "csof_torch_strain")


def jacobian_entry(argv=None):
    """The same tree analysis as strain_entry, which covers the jacobian."""
    _strain(argv, "csof_torch_jacobian")


def strain_curve_metric_entry(argv=None):
    """AI vs GT strain curves: folders of per-case curve files (.mat Medis
    export, .npz or .npy) paired in sorted order, or by basename with
    --match-names; strain_metrics.csv and strain_curve_summary.json."""
    from csof_tpu_torch.analysis.strain_curves import aggregate_strain_curve_metrics

    p = argparse.ArgumentParser("csof_torch_strain_curve_metric")
    p.add_argument("--ai", required=True, help="folder of AI strain curve files")
    p.add_argument("--gt", required=True, help="folder of GT strain curve files")
    p.add_argument("-o", "--output", default=None, help="output folder (default: AI folder)")
    p.add_argument("--match-names", action="store_true",
                   help="pair by identical basename instead of sorted order")
    a = p.parse_args(argv)
    exts = ("*.mat", "*.npz", "*.npy")
    ai_files = sorted(f for pat in exts for f in Path(a.ai).glob(pat))
    gt_files = sorted(f for pat in exts for f in Path(a.gt).glob(pat))
    if a.match_names:
        gt_by_name = {f.name: f for f in gt_files}
        pairs = [(f, gt_by_name[f.name]) for f in ai_files if f.name in gt_by_name]
    else:
        pairs = list(zip(ai_files, gt_files))
    if not pairs:
        p.error(f"no curve file pairs between {a.ai} and {a.gt}")
    out_dir = Path(a.output) if a.output else Path(a.ai)
    out_dir.mkdir(parents=True, exist_ok=True)
    res = aggregate_strain_curve_metrics(pairs, csv_out=out_dir / "strain_metrics.csv",
                                         json_out=out_dir / "strain_curve_summary.json")
    print(json.dumps(res["mean"], indent=2))
    print(f"{len(pairs)} cases -> {out_dir}/strain_metrics.csv")


def find_best_configuration_entry(argv=None):
    """The best configuration or pairwise ensemble from validation softmax
    dumps (``<case>.npz`` with ``softmax``, as csof_torch_predict --save-npz
    writes them) against the ground-truth labels: a JSON of the scores, the
    winner and its postprocessing decision."""
    from csof_tpu_torch.evaluation.model_selection import find_best_configuration
    from csof_tpu_torch.utils.nifti import load_nifti

    p = argparse.ArgumentParser("csof_torch_find_best_configuration")
    p.add_argument("-f", "--folders", nargs="+", required=True,
                   help="named softmax folders as name=path (npz dumps per case)")
    p.add_argument("-r", "--ref", required=True, help="GT label folder")
    p.add_argument("-l", "--labels", type=int, nargs="+", required=True)
    p.add_argument("-o", "--output", default="best_configuration.json")
    a = p.parse_args(argv)
    configs, cases = {}, None
    for spec in a.folders:
        name, _, path = spec.partition("=")
        if not path:
            p.error(f"folder spec must be name=path, got {spec!r}")
        folder = Path(path)
        ids = sorted(f.stem for f in folder.glob("*.npz"))
        if cases is None:
            cases = ids
        elif ids != cases:
            p.error(f"case mismatch between folders: {name}")
        configs[name] = [np.load(folder / f"{c}.npz")["softmax"] for c in ids]
    gts = []
    for c in cases:
        gt_file = Path(a.ref) / f"{c}.nii.gz"
        if not gt_file.exists():
            p.error(f"missing GT {gt_file}")
        gts.append(load_nifti(gt_file).data_czyx)
    res = find_best_configuration(configs, gts, a.labels, output_file=a.output)
    print(json.dumps({"best": res["best"], "scores": res["scores"]}, indent=2))


def determine_postprocessing_entry(argv=None):
    """Decide keep-largest-component postprocessing from validation
    predictions (``*.nii.gz``) against their labels; postprocessing.json."""
    from csof_tpu_torch.evaluation.postprocessing import determine_postprocessing
    from csof_tpu_torch.utils.nifti import load_nifti

    p = argparse.ArgumentParser("csof_torch_determine_postprocessing")
    p.add_argument("-p", "--pred", required=True, help="validation predictions (*.nii.gz)")
    p.add_argument("-r", "--ref", required=True, help="GT label folder")
    p.add_argument("-l", "--labels", type=int, nargs="+", required=True)
    p.add_argument("-o", "--output", default=None,
                   help="postprocessing.json path (default: <pred>/postprocessing.json)")
    a = p.parse_args(argv)
    pred_dir = Path(a.pred)
    pairs = [(load_nifti(f).data_czyx, load_nifti(Path(a.ref) / f.name).data_czyx)
             for f in sorted(pred_dir.glob("*.nii.gz")) if (Path(a.ref) / f.name).exists()]
    if not pairs:
        p.error(f"no matching pairs between {a.pred} and {a.ref}")
    out = a.output or (pred_dir / "postprocessing.json")
    print(json.dumps(determine_postprocessing(pairs, a.labels, output_file=out), indent=2))


#: the files a model zip keeps: the JAX package's checkpoints and sidecars,
#: and the port's ``.pt`` checkpoints
EXPORTED_SUFFIXES = (".msgpack", ".json", ".yaml", ".pkl", ".pt")


def export_model_entry(argv=None):
    """A trained folder's checkpoints, sidecars and postprocessing decision
    (every file with a suffix of EXPORTED_SUFFIXES, subfolders included) as
    a zip: the JAX command's members, the sidecars deflated and the
    checkpoints stored (float weights barely compress, and deflating a 2d
    U-Net's two 236 MB checkpoints took 47 s of host time)."""
    import zipfile

    p = argparse.ArgumentParser("csof_torch_export_model_to_zip")
    p.add_argument("-m", "--model", required=True, help="trained folder (e.g. results/fold_0)")
    p.add_argument("-o", "--output", required=True, help="output .zip")
    a = p.parse_args(argv)
    model = Path(a.model)
    if not model.is_dir():
        p.error(f"{model} is not a directory")
    n = 0
    with zipfile.ZipFile(a.output, "w", zipfile.ZIP_DEFLATED) as z:
        for f in sorted(model.rglob("*")):
            if f.is_file() and f.suffix in EXPORTED_SUFFIXES:
                stored = f.suffix in (".pt", ".msgpack")
                z.write(f, f.relative_to(model),
                        compress_type=zipfile.ZIP_STORED if stored else None)
                n += 1
    if not n:
        p.error(f"nothing exportable in {model}")
    print(f"exported {n} files -> {a.output}")


def install_model_entry(argv=None):
    """Unpack a model zip into a folder; a member that would land outside it
    is refused before anything is written."""
    import zipfile

    p = argparse.ArgumentParser("csof_torch_install_model_from_zip")
    p.add_argument("zip", help="model zip produced by csof_torch_export_model_to_zip")
    p.add_argument("-o", "--output", required=True, help="target model folder")
    a = p.parse_args(argv)
    out = Path(a.output)
    out.mkdir(parents=True, exist_ok=True)
    root = out.resolve()
    with zipfile.ZipFile(a.zip) as z:
        for name in z.namelist():
            dest = (out / name).resolve()
            # a path test, not a string prefix: /x/model2 is not inside /x/model
            if not (dest == root or dest.is_relative_to(root)):
                p.error(f"refusing unsafe zip member path {name!r}")
        z.extractall(out)
        n = len(z.namelist())
    print(f"installed {n} files -> {out}")


def print_models_entry(argv=None):
    """The trained folders (a ``model_*.msgpack`` or ``model_*.pt`` inside)
    under a results root, each with the model kind of its config.yaml."""
    from csof_tpu_torch.config.paths import default_paths

    p = argparse.ArgumentParser("csof_torch_print_available_models")
    p.add_argument("-r", "--root", default=None, help="results root (default: CSOF results dir)")
    a = p.parse_args(argv)
    root = Path(a.root) if a.root else default_paths().results
    found = sorted({f.parent for pat in ("model_*.msgpack", "model_*.pt")
                    for f in Path(root).rglob(pat)})
    if not found:
        print(f"no trained models under {root}")
    for folder in found:
        cfg = folder / "config.yaml"
        kind = ""
        if cfg.exists():
            for line in cfg.read_text().splitlines():
                if line.startswith("model:"):
                    kind = line.split(":", 1)[1].strip()
        print(f"{folder}  model={kind}")


def _sorted_keys(value):
    """``value`` with every mapping's keys sorted, as PyYAML's safe_dump
    sorts them by default."""
    if isinstance(value, dict):
        return {k: _sorted_keys(value[k]) for k in sorted(value)}
    if isinstance(value, (list, tuple)):
        return [_sorted_keys(v) for v in value]
    return value


def change_model_entry(argv=None):
    """Rewrite the ``model:`` kind in a trained folder's config.yaml, the
    file written as the JAX package writes it (keys sorted)."""
    from csof_tpu_torch.utils.yaml_subset import safe_dump, safe_load

    p = argparse.ArgumentParser("csof_torch_change_model")
    p.add_argument("-m", "--model", required=True, help="trained folder with config.yaml")
    p.add_argument("-k", "--kind", required=True,
                   help="new model kind (unet2d/unet3d/segflow/raft/voxelmorph/...)")
    a = p.parse_args(argv)
    cfg_path = Path(a.model) / "config.yaml"
    if not cfg_path.exists():
        p.error(f"{cfg_path} not found")
    cfg = safe_load(cfg_path.read_text())
    old = cfg.get("model")
    cfg["model"] = a.kind
    cfg_path.write_text(safe_dump(_sorted_keys(cfg)))
    print(f"{cfg_path}: model {old} -> {a.kind}")


def plot_task_pngs_entry(argv=None):
    """An overlay PNG (image and label, RGBA) for every labelled case of a
    raw task folder, at the slice with the most foreground, the image
    windowed to its 1st-99th percentiles."""
    from csof_tpu_torch.utils.nifti import load_nifti
    from csof_tpu_torch.utils.png import write_png
    from csof_tpu_torch.utils.visualization import seg_overlay

    p = argparse.ArgumentParser("csof_torch_plot_task_pngs")
    p.add_argument("-t", "--task", required=True, help="raw task folder (imagesTr/ labelsTr/)")
    p.add_argument("-o", "--output", default=None, help="default: <task>/overlays")
    a = p.parse_args(argv)
    task = Path(a.task)
    out = Path(a.output) if a.output else task / "overlays"
    out.mkdir(parents=True, exist_ok=True)
    n = 0
    for lab in sorted((task / "labelsTr").glob("*.nii.gz")):
        case = lab.name.replace(".nii.gz", "")
        img_f = task / "imagesTr" / f"{case}_0000.nii.gz"
        if not img_f.exists():
            continue
        img = load_nifti(img_f).data_czyx
        seg = load_nifti(lab).data_czyx
        z = int(np.argmax((seg > 0).sum(axis=(1, 2))))  # the most-foreground slice
        sl = img[z].astype(np.float32)
        lo, hi = np.percentile(sl, (1, 99))
        sl = np.clip((sl - lo) / max(hi - lo, 1e-6), 0, 1)
        rgb = seg_overlay(sl, seg[z])
        alpha = np.full(rgb.shape[:2] + (1,), 255, np.uint8)  # as plt.imsave writes RGB
        write_png(out / f"{case}.png", np.concatenate([rgb, alpha], -1))
        n += 1
    print(f"wrote {n} overlays -> {out}")


COMMANDS = {"convert_acdc": convert_acdc_entry, "convert_mnms": convert_mnms_entry,
            "convert_decathlon": convert_decathlon_entry,
            "plan_and_preprocess": plan_and_preprocess_entry, "train": train_entry,
            "predict": predict_entry, "predict_flow": predict_flow_entry,
            "evaluate": evaluate_entry, "ensemble": ensemble_entry, "strain": strain_entry,
            "jacobian": jacobian_entry, "strain_curve_metric": strain_curve_metric_entry,
            "find_best_configuration": find_best_configuration_entry,
            "determine_postprocessing": determine_postprocessing_entry,
            "export_model_to_zip": export_model_entry,
            "install_model_from_zip": install_model_entry,
            "print_available_models": print_models_entry, "change_model": change_model_entry,
            "plot_task_pngs": plot_task_pngs_entry}


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else list(argv)
    if not argv or argv[0] not in COMMANDS:
        raise SystemExit(f"usage: python -m csof_tpu_torch.cli.main {{{','.join(COMMANDS)}}} "
                         "[arguments]")
    COMMANDS[argv[0]](argv[1:])


if __name__ == "__main__":
    main()
