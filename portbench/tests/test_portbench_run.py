"""The command without a card: a non-zero exit and no result line."""

import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]


def _run(cwd: Path):
    return subprocess.run([sys.executable, "-m", "portbench.run", "--workload", "unet2d-train-b40",
                           "--seed", str(2**31 + 9), "--seconds", "1", "--trace", "0"],
                          cwd=cwd, capture_output=True, text=True, timeout=300)


def test_no_card_exits_non_zero_without_a_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    proc = _run(ROOT)
    assert proc.returncode != 0
    assert '"correct"' not in proc.stdout


def test_the_benchmark_alone_exits_non_zero(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    proc = _run(tmp_path)
    assert proc.returncode != 0
    assert '"correct"' not in proc.stdout
