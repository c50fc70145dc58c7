"""The benchmark's own tests (run with ``python -m pytest odb_bench/tests``
from the checkout's root); they put the root and ``src`` on the path."""

import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[2]
for path in (str(ROOT), str(ROOT / "src")):
    if path not in sys.path:
        sys.path.insert(0, path)
