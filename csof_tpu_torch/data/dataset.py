"""Preprocessed-dataset access: the case dict, npz unpacking and the 5-fold
split (port of ``csof_tpu/data/dataset.py``, numpy only).

``do_split`` draws the folds as scikit-learn's ``KFold(shuffle=True,
random_state=12345)`` does, written out in numpy: the package does not
depend on scikit-learn.
"""

from __future__ import annotations

import pickle
from pathlib import Path

import numpy as np


def load_dataset(folder: str | Path) -> dict[str, dict]:
    """{case: {"data_file", "npy_file", "properties_file"}} for every
    ``<case>.npz`` in ``folder``."""
    folder = Path(folder)
    return {npz.stem: {"data_file": npz, "npy_file": npz.with_suffix(".npy"),
                       "properties_file": npz.with_name(f"{npz.stem}.pkl")}
            for npz in sorted(folder.glob("*.npz"))}


def unpack_dataset(folder: str | Path) -> None:
    """Write each ``<case>.npz``'s array beside it as ``<case>.npy``, which
    loaders memory-map."""
    for npz in sorted(Path(folder).glob("*.npz")):
        npy = npz.with_suffix(".npy")
        if not npy.exists():
            np.save(npy, np.load(npz)["data"])


def load_case(entry: dict) -> tuple[np.ndarray, dict]:
    """(data, properties) of one case: the ``.npy`` memory-mapped where it
    exists, else the ``.npz`` array; the properties that the preprocessor
    pickled beside it."""
    npy = entry.get("npy_file")
    if npy and Path(npy).exists():
        data = np.load(npy, mmap_mode="r")
    else:
        data = np.load(entry["data_file"])["data"]
    with open(entry["properties_file"], "rb") as f:
        props = pickle.load(f)
    return data, props


def kfold_splits(n: int, n_splits: int, seed: int) -> list[tuple[np.ndarray, np.ndarray]]:
    """(train, val) index arrays of each fold, both ascending: the indices
    shuffled by ``RandomState(seed)``, cut into ``n_splits`` consecutive
    folds of which the first ``n % n_splits`` hold one index more."""
    order = np.arange(n)
    np.random.RandomState(seed).shuffle(order)
    sizes = np.full(n_splits, n // n_splits)
    sizes[: n % n_splits] += 1
    out, start = [], 0
    for size in sizes:
        val = np.zeros(n, bool)
        val[order[start:start + size]] = True
        out.append((np.flatnonzero(~val), np.flatnonzero(val)))
        start += size
    return out


def do_split(case_ids: list[str], fold, n_splits: int = 5, seed: int = 12345,
             splits_file: str | Path | None = None) -> tuple[list[str], list[str]]:
    """(train, val) case ids of ``fold`` from a 5-fold split of the sorted
    ids, persisted in ``splits_file`` when given and read back from it when
    it exists. Fold -1 or "all" trains and validates on every case."""
    case_ids = sorted(case_ids)
    if fold in (-1, "all"):
        return case_ids, case_ids
    splits = None
    if splits_file and Path(splits_file).exists():
        with open(splits_file, "rb") as f:
            splits = pickle.load(f)
    if splits is None:
        n_splits = min(n_splits, len(case_ids))
        if n_splits < 2:
            return case_ids, case_ids
        splits = [{"train": [case_ids[i] for i in tr], "val": [case_ids[i] for i in va]}
                  for tr, va in kfold_splits(len(case_ids), n_splits, seed)]
        if splits_file:
            with open(splits_file, "wb") as f:
                pickle.dump(splits, f)
    s = splits[fold]
    return list(s["train"]), list(s["val"])
