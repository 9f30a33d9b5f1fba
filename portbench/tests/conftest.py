"""The benchmark's own CPU tests: ``python3 -m pytest portbench/tests`` from
the root of the repository."""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
