"""The benchmark's own CPU tests: ``python -m pytest portbench/tests``
from the root of the repository.  Tests that need the card carry the
``cuda`` marker and skip here."""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)
