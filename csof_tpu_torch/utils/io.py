"""Small IO and naming helpers (port of ``csof_tpu/utils/io.py``): task id
and name conversion (folders named ``TaskXXX_Name``), pickle and JSON files,
and a folder's files by suffix and prefix."""

from __future__ import annotations

import json
import pickle
from pathlib import Path


def task_name_to_id(name: str) -> int:
    """'Task027_ACDC' -> 27."""
    if not name.startswith("Task"):
        raise ValueError(f"not a task name: {name}")
    return int(name[4:7])


def find_task_name(root: str | Path, task_id: int) -> str:
    """The one 'TaskXXX_*' folder under ``root`` with this numeric id."""
    candidates = [p.name for p in Path(root).iterdir()
                  if p.name.startswith(f"Task{task_id:03d}_")]
    if not candidates:
        raise FileNotFoundError(f"no Task{task_id:03d}_* under {root}")
    if len(candidates) > 1:
        raise RuntimeError(f"ambiguous task id {task_id}: {candidates}")
    return candidates[0]


def load_pickle(path: str | Path):
    with open(path, "rb") as f:
        return pickle.load(f)


def save_pickle(obj, path: str | Path) -> None:
    with open(path, "wb") as f:
        pickle.dump(obj, f)


def load_json(path: str | Path):
    return json.loads(Path(path).read_text())


def save_json(obj, path: str | Path, indent: int = 2) -> None:
    Path(path).write_text(json.dumps(obj, indent=indent, default=float))


def subfiles(folder: str | Path, suffix: str | None = None, prefix: str | None = None,
             sort: bool = True) -> list[Path]:
    out = [p for p in Path(folder).iterdir()
           if p.is_file() and (suffix is None or p.name.endswith(suffix))
           and (prefix is None or p.name.startswith(prefix))]
    return sorted(out) if sort else out
