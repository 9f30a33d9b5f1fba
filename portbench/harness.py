"""What every cell's driver shares: the run's context, the weights drawn
from the seed, the statistics of a window, and the comparison with limits.
"""

from __future__ import annotations

import json
import math
import os
from dataclasses import dataclass, field
from pathlib import Path

import torch
from torch import nn

from portbench.generator import child_seed

PKG = Path(__file__).resolve().parent


@dataclass
class Context:
    """One run: the cell, its configuration and traffic mix as read from
    their files, the seed, the window's seconds, whether it is traced, and
    the device."""

    cell: str
    config: dict
    traffic: dict
    seed: int
    seconds: float
    trace: bool
    device: str = "cuda"
    #: what the traced slices recorded, for the per-layer readers
    record: dict = field(default_factory=dict)


def weight_spec(model: nn.Module) -> list[tuple[str, tuple, float, float]]:
    """(name, shape, std, mean) of each parameter of a reference model:
    conv and transposed-conv kernels normal with std sqrt(2 / fan_in),
    linear kernels sqrt(1 / fan_in), norm scales 1 + 0.1 n, biases 0.1 n."""
    spec = []
    for name, p in model.named_parameters():
        shape = tuple(p.shape)
        if name.endswith("bias"):
            spec.append((name, shape, 0.1, 0.0))
        elif len(shape) == 1:
            spec.append((name, shape, 0.1, 1.0))
        elif len(shape) == 2:
            spec.append((name, shape, math.sqrt(1.0 / shape[1]), 0.0))
        else:
            transposed = "ConvTranspose" in name or "expand_" in name
            fan_in = (shape[0] if transposed else shape[1]) * math.prod(shape[2:])
            spec.append((name, shape, math.sqrt(2.0 / fan_in), 0.0))
    return spec


def draw_weights(spec, seed: int, device) -> dict[str, torch.Tensor]:
    """The weights of ``spec`` from the seed: one normal draw on the device,
    cut into the parameters and scaled, float32."""
    gen = torch.Generator(device=device).manual_seed(child_seed(seed, "weights"))
    total = sum(math.prod(shape) for _, shape, _, _ in spec)
    flat = torch.randn(total, generator=gen, device=device)
    out, at = {}, 0
    for name, shape, std, mean in spec:
        n = math.prod(shape)
        out[name] = flat[at:at + n].view(shape) * std + mean
        at += n
    return out


def p95(latencies: list[float]) -> float:
    """The 95th percentile by nearest rank (a failed request counts as
    infinitely slow)."""
    xs = sorted(latencies)
    return xs[max(math.ceil(0.95 * len(xs)) - 1, 0)]


def read_limits(cell: str) -> dict[str, float]:
    """The cell's limits on the numbers its check compares (``limits/<cell>.json``)."""
    data = json.loads((PKG / "limits" / f"{cell}.json").read_text())
    return {k: float(v["limit"]) for k, v in data.items()}


def judge(readings: dict[str, float], limits: dict[str, float]) -> tuple[bool, dict]:
    """(correct, {number: {"value", "limit"}}): correct when every number is
    finite and at most its limit, and none is missing."""
    checks, ok = {}, True
    for name, limit in limits.items():
        value = readings.get(name, float("nan"))
        checks[name] = {"value": value, "limit": limit}
        ok = ok and math.isfinite(value) and value <= limit
    return ok, checks


def free_device() -> None:
    import gc

    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


def set_flags(flags: dict, cuda: bool = True) -> None:
    """TF32 in cuDNN and in cuBLAS, as the configuration states it."""
    if cuda:
        torch.backends.cudnn.allow_tf32 = bool(flags["cudnn_allow_tf32"])
        torch.backends.cuda.matmul.allow_tf32 = bool(flags["matmul_allow_tf32"])


def set_env(env: dict) -> None:
    """The program's switches, as the configuration states them."""
    for k, v in env.items():
        os.environ[k] = str(v)
