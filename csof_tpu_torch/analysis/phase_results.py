"""Per-phase (ED/ES) result aggregation and CSV merging (port of
``csof_tpu/analysis/phase_results.py``, without pandas).

``merge_csvs`` does pandas' outer join of ``read_csv`` frames itself: each
column typed as ``read_csv`` types it (int, float, bool or text; an empty or
"NaN"-like cell is missing, and an int column with one becomes float), the
join keys in sorted order with a key's rows multiplied out, and the result
written as ``DataFrame.to_csv(index=False)`` writes it (missing cells empty,
floats as ``repr``). It returns the merged rows as a list of dicts (None where a cell
is missing) where the JAX package returns a ``DataFrame``.
"""

from __future__ import annotations

import csv
import json
import math
import re
from pathlib import Path

import numpy as np


def phase_of_case(case: str, ed_es: dict[str, dict] | None = None) -> str | None:
    """ED or ES of a case id like patient001_frame01 from the converter's
    ed/es table, or from an _ED / _ES suffix; None if neither says."""
    if case.endswith("_ED"):
        return "ED"
    if case.endswith("_ES"):
        return "ES"
    m = re.match(r"(.+)_frame(\d+)$", case)
    if m and ed_es:
        pid, frame = m.group(1), int(m.group(2))
        info = ed_es.get(pid)
        if info:
            if frame == int(info["ed"]):
                return "ED"
            if frame == int(info["es"]):
                return "ES"
    return None


def results_per_phase(summary_file: str | Path, ed_es: dict[str, dict] | None = None,
                      metric: str = "Dice") -> dict:
    """Split an evaluator summary.json into per-phase ("ED", "ES", "all")
    per-class means of ``metric`` (non-finite values left out)."""
    summary = json.loads(Path(summary_file).read_text())
    buckets: dict[str, dict[str, list[float]]] = {"ED": {}, "ES": {}, "all": {}}
    for case_entry in summary["all"]:
        name = Path(case_entry.get("test", case_entry.get("case", ""))).name
        name = name.replace(".nii.gz", "")
        phase = phase_of_case(name, ed_es)
        for label, metrics in case_entry.items():
            if not isinstance(metrics, dict) or metric not in metrics:
                continue
            v = metrics[metric]
            if v is None or not np.isfinite(v):
                continue
            buckets["all"].setdefault(label, []).append(v)
            if phase:
                buckets[phase].setdefault(label, []).append(v)
    return {ph: {label: float(np.mean(vals)) for label, vals in labels.items()}
            for ph, labels in buckets.items() if labels}


_TRUE, _FALSE = ("True", "TRUE", "true"), ("False", "FALSE", "false")
#: read_csv's default missing-value strings
_NA = {"", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan", "1.#IND",
       "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a", "nan", "null"}
_INT = re.compile(r"[+-]?[0-9]+")


def _parse_float(s: str) -> float:
    """A float cell as read_csv takes it: ``float`` without Python's digit
    separators (pandas' own parser may round 17-digit values one unit
    differently in the last place)."""
    if "_" in s:
        raise ValueError(s)
    return float(s)


def _parse_column(cells: list[str]):
    """read_csv's typing of one column: (kind, values), kind int, float, bool
    or str, None for a missing cell."""
    present = [c for c in cells if c not in _NA]
    if not present:
        return "float", [None] * len(cells)

    def parsed(conv):
        return [None if c in _NA else conv(c) for c in cells]

    if all(c in _TRUE + _FALSE for c in present):
        return "bool", parsed(lambda c: c in _TRUE)
    if all(_INT.fullmatch(c) and abs(int(c)) < 2**63 for c in present):
        if len(present) == len(cells):
            return "int", parsed(int)
        return "float", parsed(lambda c: float(int(c)))
    try:
        return "float", parsed(_parse_float)
    except ValueError:
        return "str", parsed(str)


def _read_csv(path: Path) -> tuple[list[str], dict[str, str], list[dict]]:
    with open(path, newline="") as f:
        reader = csv.reader(f)
        header = next(reader)
        rows = [r + [""] * (len(header) - len(r)) for r in reader if r]
    kinds, columns = {}, {}
    for j, name in enumerate(header):
        kinds[name], columns[name] = _parse_column([r[j] for r in rows])
    return header, kinds, [{name: columns[name][i] for name in header} for i in range(len(rows))]


def _cell(value, kind: str) -> str:
    if value is None or (isinstance(value, float) and math.isnan(value)):
        return ""
    if kind == "float":
        return repr(float(value))
    return str(value)


def merge_csvs(csv_files: list[str | Path], out_file: str | Path, key: str = "case") -> list[dict]:
    """Outer-join CSVs on ``key``, each other column suffixed by its file's
    stem, and write ``out_file`` as pandas writes the merged frame. Returns
    the merged rows (dicts, None where a cell is missing)."""
    columns: list[str] = []
    kinds: dict[str, str] = {}
    merged: list[dict] | None = None
    for f in csv_files:
        header, file_kinds, rows = _read_csv(Path(f))
        stem = Path(f).stem
        rename = {c: (c if c == key else f"{c}_{stem}") for c in header}
        rows = [{rename[c]: v for c, v in r.items()} for r in rows]
        new_cols = [rename[c] for c in header if c != key]
        for c in header:
            kinds[rename[c]] = file_kinds[c]
        if merged is None:
            merged, columns = rows, [key] + new_cols
            continue
        left: dict = {}
        for r in merged:
            left.setdefault(r[key], []).append(r)
        right: dict = {}
        for r in rows:
            right.setdefault(r[key], []).append(r)
        out = []
        for k in sorted(set(left) | set(right)):
            for a in left.get(k, [{}]):
                for b in right.get(k, [{}]):
                    row = {c: None for c in columns + new_cols}
                    row.update(a)
                    row.update(b)
                    row[key] = k
                    out.append(row)
        merged, columns = out, columns + new_cols
        if kinds[key] != file_kinds[key]:
            kinds[key] = "float" if {kinds[key], file_kinds[key]} == {"int", "float"} else "str"
    # a column with a missing cell is no longer int (pandas makes it float)
    for c in columns:
        if kinds[c] == "int" and any(r[c] is None for r in merged):
            kinds[c] = "float"
            for r in merged:
                r[c] = None if r[c] is None else float(r[c])
    with open(out_file, "w", newline="") as f:
        w = csv.writer(f, lineterminator="\n")
        w.writerow(columns)
        for r in merged:
            w.writerow([_cell(r[c], kinds[c]) for c in columns])
    return merged
