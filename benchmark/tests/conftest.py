"""The benchmark's own tests: `python -m pytest benchmark/tests` from the
root of a checkout. Tests that need the card carry the `cuda` marker and
decide inside the test whether one is present."""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))
