"""Checkpoints: the latest/best/final triad with a JSON sidecar (port of
``csof_tpu/training/checkpoint.py``).

A checkpoint is a ``torch.save`` of a dict (the trainer stores the model's
and the optimizer's state dicts and the step) under the JAX package's file
names with a ``.pt`` suffix; ``<name>.json`` beside it holds the metadata.
Reading the JAX package's msgpack checkpoints is not ported.
"""

from __future__ import annotations

import json
import os
from pathlib import Path
from typing import Any

import numpy as np
import torch

LATEST = "model_latest.pt"
BEST = "model_best.pt"
FINAL = "model_final_checkpoint.pt"


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


def load_checkpoint(folder: str | Path, name: str | None = None,
                    map_location: Any = None) -> tuple[dict, dict]:
    """(state, meta) of folder/name; with no name the first that exists of
    final, latest, best."""
    folder = Path(folder)
    names = [name] if name else [FINAL, LATEST, BEST]
    for n in names:
        p = folder / n
        if p.exists():
            state = torch.load(p, map_location=map_location, weights_only=True)
            meta_p = folder / (n + ".json")
            meta = json.loads(meta_p.read_text()) if meta_p.exists() else {}
            return state, meta
    raise FileNotFoundError(f"no checkpoint among {names} in {folder}")


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
