"""Model restore: rebuild a trainer from a results folder (port of
``csof_tpu/training/restore.py``).

A folder holds ``config.yaml`` (the experiment config), ``plans.json`` (the
U-Net's plans) and ``meta.json`` (the class count), written at training
time by ``save_trainer_sidecar`` with the JAX package's bytes, beside a
checkpoint triad of either package (``.pt`` or ``.msgpack``). So a folder
the JAX package trained serves in the port unchanged, and the JAX package
reads a port-written folder's sidecars.
"""

from __future__ import annotations

import json
from pathlib import Path

import torch

from csof_tpu_torch.config.experiment import ExperimentConfig, load_experiment_config
from csof_tpu_torch.config.plans import Plans
from csof_tpu_torch.training.trainer import Trainer


def save_trainer_sidecar(folder: str | Path, config: ExperimentConfig, plans: Plans | None,
                         num_classes: int) -> None:
    folder = Path(folder)
    folder.mkdir(parents=True, exist_ok=True)
    config.to_yaml(folder / "config.yaml")
    if plans is not None:
        plans.to_json(folder / "plans.json")
    (folder / "meta.json").write_text(json.dumps({"num_classes": num_classes}))


def load_pretrained_weights(state_dict: dict, pretrained: dict,
                            verbose: bool = False) -> tuple[dict, int, int]:
    """Shape-checked partial transfer between two ``state_dict``s: each entry
    of ``state_dict`` takes the pretrained tensor of the same name and shape,
    and keeps its own value elsewhere. Returns (the merged state dict, loaded,
    kept)."""
    out, loaded, kept = {}, 0, 0
    for name, value in state_dict.items():
        old = pretrained.get(name)
        if old is not None and tuple(old.shape) == tuple(value.shape):
            out[name] = old.to(value)
            loaded += 1
        else:
            out[name] = value
            kept += 1
            if verbose and old is not None:
                print(f"skip {name}: {tuple(old.shape)} != {tuple(value.shape)}")
    if verbose:
        print(f"pretrained transfer: {loaded} loaded, {kept} kept from init")
    return out, loaded, kept


def restore_trainer(folder: str | Path, checkpoint_name: str | None = None,
                    device: torch.device | str = "cuda", for_training: bool = False) -> Trainer:
    """The port's ``Trainer`` of a results folder, with its weights and
    optimizer state loaded from ``checkpoint_name`` (by default the first of
    final, latest, best; the port's or the JAX package's format). To serve
    (the default), the model may run forward-only kernels (``CSOF_FUSED_NORM=1``);
    ``for_training=True`` applies the trainer's checks."""
    folder = Path(folder)
    config = load_experiment_config(folder / "config.yaml")
    plans = Plans.from_json(folder / "plans.json") if (folder / "plans.json").exists() else None
    meta = json.loads((folder / "meta.json").read_text()) if (folder / "meta.json").exists() else {}
    trainer = Trainer(config, folder, plans=plans, num_classes=meta.get("num_classes"),
                      device=device, for_training=for_training)
    trainer.load_checkpoint(checkpoint_name)
    return trainer
