"""CPU tests of the benchmark harness (run from the root of the checkout:
``python -m pytest -q cimbench/tests``); the ``cuda`` ones run on a card."""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)
