"""The benchmark's tests run from the checkout's root on the CPU; the
checkout's root goes on ``sys.path`` as ``benchmark/run.py`` puts it."""

import sys
from pathlib import Path

ROOT = str(Path(__file__).resolve().parents[2])
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
