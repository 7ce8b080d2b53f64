"""The program's package from the checkout's ``src``, as ``bench/run.py``
finds it."""
import sys

from bench.harness.spec import ROOT

if str(ROOT / "src") not in sys.path:
    sys.path.insert(0, str(ROOT / "src"))
