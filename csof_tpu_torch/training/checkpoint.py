"""Checkpoints: the latest/best/final triad with a JSON sidecar (port of
``csof_tpu/training/checkpoint.py``).

A checkpoint is a ``torch.save`` of a dict (the trainer stores the model's
and the optimizer's state dicts and the step) under the JAX package's file
names with a ``.pt`` suffix; ``<name>.json`` beside it holds the metadata.
The JAX package's triad (``model_*.msgpack``, a flax ``TrainState``) is read
beside it, by the port's own msgpack reader
(:mod:`csof_tpu_torch.compat.flax_msgpack`): ``load_checkpoint`` returns
the restored state dict, which
:func:`csof_tpu_torch.compat.flax_import.load_flax_train_state` maps onto
the port's model and optimizer.
"""

from __future__ import annotations

import json
import os
from pathlib import Path
from typing import Any

import numpy as np
import torch

from csof_tpu_torch.compat.flax_msgpack import load_msgpack

LATEST = "model_latest.pt"
BEST = "model_best.pt"
FINAL = "model_final_checkpoint.pt"
#: the fallback order of a load without a name, as the JAX package's
STEMS = ("model_final_checkpoint", "model_latest", "model_best")
#: file suffix -> format, in the order a stem is looked up
FORMATS = {".pt": "pt", ".msgpack": "msgpack"}


def save_checkpoint(folder: str | Path, state: dict, name: str = LATEST,
                    meta: dict | None = None) -> Path:
    """Write ``state`` to folder/name atomically, and the sidecar if ``meta``."""
    folder = Path(folder)
    folder.mkdir(parents=True, exist_ok=True)
    path = folder / name
    tmp = path.with_suffix(".tmp")
    torch.save(state, tmp)
    os.replace(tmp, path)
    if meta is not None:
        (folder / (name + ".json")).write_text(json.dumps(_jsonable(meta), indent=2))
    return path


def find_checkpoint(folder: str | Path, name: str | None = None) -> tuple[Path, str]:
    """(path, format) of the checkpoint to read. ``name`` is a file name
    (``model_best.pt``, ``model_best.msgpack``) or a stem (``model_best``);
    without one, the stems final, latest, best in turn. At each stem the
    port's ``.pt`` is taken before the JAX package's ``.msgpack``."""
    folder = Path(folder)
    if name is not None and Path(name).suffix in FORMATS:
        candidates = [name]
    else:
        stems = [name] if name else list(STEMS)
        candidates = [stem + suffix for stem in stems for suffix in FORMATS]
    for n in candidates:
        p = folder / n
        if p.exists():
            return p, FORMATS[p.suffix]
    raise FileNotFoundError(f"no checkpoint among {candidates} in {folder}")


def load_checkpoint(folder: str | Path, name: str | None = None,
                    map_location: Any = None) -> tuple[dict, dict, str]:
    """(state, meta, format) of the checkpoint ``find_checkpoint`` picks.
    format "pt": the dict ``save_checkpoint`` wrote; "msgpack": the flax
    state dict of a JAX ``TrainState`` ({"step", "params", "opt_state"},
    numpy leaves)."""
    path, fmt = find_checkpoint(folder, name)
    if fmt == "pt":
        state = torch.load(path, map_location=map_location, weights_only=True)
    else:
        state = load_msgpack(path)
    meta_p = path.with_name(path.name + ".json")
    meta = json.loads(meta_p.read_text()) if meta_p.exists() else {}
    return state, meta, fmt


def _jsonable(o):
    if isinstance(o, dict):
        return {k: _jsonable(v) for k, v in o.items()}
    if isinstance(o, (list, tuple)):
        return [_jsonable(v) for v in o]
    if isinstance(o, np.integer):
        return int(o)
    if isinstance(o, np.floating):
        return float(o)
    if isinstance(o, np.ndarray):
        return o.tolist()
    return o
