"""The SegFlow serving remap (port of ``csof_tpu/inference/serving.py``).

Only parameter-compatible remaps: ``concat`` and ``concat_cm`` checkpoints
serve as ``fused_cm`` (kernel K3: the same conv over the same channel concat,
with the same parameter paths). K3 computes GroupNorm only, so the remap is
taken only for ``norm`` "group" or "batch" (which is GroupNorm); an
``instance`` checkpoint keeps its mode and runs the correlation kernel K1.
(The JAX remap ignores ``norm``.) ``scan_unroll`` is set as the JAX remap
sets it, so the config is the one the JAX package serves; the port's
temporal loop is unrolled whatever its value.
"""

from __future__ import annotations

import dataclasses
import os

SERVING_CORR_FUSE = {"concat": "fused_cm", "concat_cm": "fused_cm"}
FUSED_NORMS = ("group", "batch")


def serving_kwargs(t: int) -> dict:
    """SegFlowModelConfig overrides of the serving config for T frames."""
    return {"scan_unroll": int(t), "corr_fuse": "fused_cm"}


def apply_serving_config(cfg, t: int | None = None):
    """Remap a SegFlowModelConfig onto the serving config; returns a new one.

    - scan_unroll -> t (-1 when T is not known).
    - corr_fuse -> fused_cm when the mode has a parameter-compatible remap
      and the norm is GroupNorm; CSOF_SERVE_FUSE=0 opts out (the concat_cm
      path then runs K1 and the module chain).
    """
    kw: dict = {"scan_unroll": -1 if t is None else int(t)}
    if (
        os.environ.get("CSOF_SERVE_FUSE", "1") != "0"
        and cfg.corr_fuse in SERVING_CORR_FUSE
        and cfg.norm in FUSED_NORMS
    ):
        kw["corr_fuse"] = SERVING_CORR_FUSE[cfg.corr_fuse]
    return dataclasses.replace(cfg, **kw)
