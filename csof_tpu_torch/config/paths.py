"""Dataset and results folders (port of ``csof_tpu/config/paths.py``).

The environment variables of nnU-Net, ``nnUNet_raw_data_base``,
``nnUNet_preprocessed`` and ``RESULTS_FOLDER``, and their aliases
``CSOF_RAW``, ``CSOF_PREPROCESSED`` and ``CSOF_RESULTS``.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from pathlib import Path


@dataclass(frozen=True)
class Paths:
    raw: Path
    preprocessed: Path
    results: Path

    @property
    def raw_data(self) -> Path:
        return self.raw / "nnUNet_raw_data"

    @property
    def cropped_data(self) -> Path:
        return self.raw / "nnUNet_cropped_data"

    def task_raw(self, task: str) -> Path:
        return self.raw_data / task

    def task_cropped(self, task: str) -> Path:
        return self.cropped_data / task

    def task_preprocessed(self, task: str) -> Path:
        return self.preprocessed / task

    def ensure(self) -> Paths:
        for p in (self.raw_data, self.cropped_data, self.preprocessed, self.results):
            p.mkdir(parents=True, exist_ok=True)
        return self


def default_paths(base: str | os.PathLike | None = None) -> Paths:
    """The folders from the environment; ``base`` overrides it (raw,
    preprocessed and results under one directory)."""
    if base is not None:
        base = Path(base)
        return Paths(base / "raw", base / "preprocessed", base / "results")
    raw = os.environ.get("CSOF_RAW") or os.environ.get("nnUNet_raw_data_base")
    pre = os.environ.get("CSOF_PREPROCESSED") or os.environ.get("nnUNet_preprocessed")
    res = os.environ.get("CSOF_RESULTS") or os.environ.get("RESULTS_FOLDER")
    if not (raw and pre and res):
        raise RuntimeError(
            "Set CSOF_RAW/CSOF_PREPROCESSED/CSOF_RESULTS (or the nnUNet_* "
            "equivalents) or pass an explicit base directory.")
    return Paths(Path(raw), Path(pre), Path(res))
