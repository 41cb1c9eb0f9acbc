"""The benchmark's own tests: ``python -m pytest benchmark/tests -q`` from
the repository's root. Tests marked ``gpu`` decide inside the test whether
a card is there and skip without one."""

import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
for p in (str(BENCH.parent), str(BENCH)):
    if p not in sys.path:
        sys.path.insert(0, p)
