"""The benchmark's own tests: its modules import by their names under
``benchmark/`` (``traffic``, ``counts``, ``reference``, ``run``), the port
from the repository's root."""

import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE.parent), str(HERE.parent.parent)]

