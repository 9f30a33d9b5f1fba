"""Intensity normalization (numpy): ``normalize_modality`` and
``normalize_case`` of ``csof_tpu/ops/normalize.py``, carried here so that the
port never imports the JAX package."""

from __future__ import annotations

import numpy as np


def normalize_modality(channel: np.ndarray, scheme: str, *, use_nonzero_mask: bool = False,
                       nonzero_mask: np.ndarray | None = None,
                       intensity_properties: dict | None = None) -> np.ndarray:
    """Normalize one modality channel (a float32 copy): "CT" (global clip and
    standardize), "CT2" (per-case), "noNorm", or z-score (any other name)."""
    channel = channel.astype(np.float32, copy=True)
    masked = use_nonzero_mask and nonzero_mask is not None
    if scheme in ("CT", "CT2"):
        if intensity_properties is None:
            raise ValueError(f"{scheme} normalization requires dataset intensity properties")
        lb = intensity_properties["percentile_00_5"]
        ub = intensity_properties["percentile_99_5"]
        if scheme == "CT":
            channel = np.clip(channel, lb, ub)
            channel = (channel - intensity_properties["mean"]) / intensity_properties["sd"]
        else:
            inrange = (channel > lb) & (channel < ub)
            channel = np.clip(channel, lb, ub)
            mn, sd = channel[inrange].mean(), channel[inrange].std()
            channel = (channel - mn) / sd
        if masked:
            channel[~nonzero_mask] = 0
    elif scheme == "noNorm":
        pass
    elif masked:
        vals = channel[nonzero_mask]
        channel[nonzero_mask] = (vals - vals.mean()) / (vals.std() + 1e-8)
        channel[~nonzero_mask] = 0
    else:
        channel = (channel - channel.mean()) / (channel.std() + 1e-8)
    return channel


def normalize_case(data: np.ndarray, schemes: dict[int, str], use_nonzero_mask: dict[int, bool],
                   seg: np.ndarray | None = None,
                   intensity_properties: dict[int, dict] | None = None) -> np.ndarray:
    """Normalize every modality of a (c, *spatial) case. The nonzero mask is
    ``seg[-1] >= 0`` (cropping stores -1 outside the nonzero bounding box)."""
    mask = (seg[-1] >= 0) if seg is not None else None
    out = np.empty_like(data, dtype=np.float32)
    for c in range(data.shape[0]):
        props = intensity_properties.get(c) if intensity_properties else None
        out[c] = normalize_modality(data[c], schemes.get(c, "zscore"),
                                    use_nonzero_mask=bool(use_nonzero_mask.get(c, False)),
                                    nonzero_mask=mask, intensity_properties=props)
    return out
