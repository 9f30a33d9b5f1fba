"""Statistical comparison of methods' per-case results (port of
``csof_tpu/analysis/stats.py``, numpy and scipy): the paired Wilcoxon
signed-rank and t-tests between two methods, with effect sizes.
"""

from __future__ import annotations

import numpy as np
from scipy import stats as sps


def paired_tests(a, b) -> dict:
    """a, b: per-case metric arrays of two methods (same cases, same order)."""
    a, b = np.asarray(a, float), np.asarray(b, float)
    mask = np.isfinite(a) & np.isfinite(b)
    a, b = a[mask], b[mask]
    if len(a) < 3:
        return {"n": int(len(a)), "wilcoxon_p": float("nan"), "ttest_p": float("nan"),
                "mean_diff": float(np.mean(a - b)) if len(a) else float("nan")}
    diff = a - b
    try:
        w_p = float(sps.wilcoxon(a, b).pvalue) if np.any(diff != 0) else 1.0
    except ValueError:
        w_p = float("nan")
    t_p = float(sps.ttest_rel(a, b).pvalue)
    return {
        "n": int(len(a)),
        "mean_a": float(np.mean(a)),
        "mean_b": float(np.mean(b)),
        "mean_diff": float(np.mean(diff)),
        "std_diff": float(np.std(diff)),
        "wilcoxon_p": w_p,
        "ttest_p": t_p,
        "cohens_d": float(np.mean(diff) / (np.std(diff) + 1e-12)),
    }


def compare_methods(results: dict[str, dict[str, float]], baseline: str) -> dict:
    """results: method -> {case: metric}. Compare every method against
    `baseline` over the intersection of cases."""
    base = results[baseline]
    out = {}
    for name, vals in results.items():
        if name == baseline:
            continue
        cases = sorted(set(base) & set(vals))
        out[name] = paired_tests([vals[c] for c in cases], [base[c] for c in cases])
    return out
