"""The benchmark's CPU tests: ``python -m pytest bench/tests`` from the
root of the repository.  They import the harness as the run does (``bench``
and ``src`` on the path) and keep torch to one thread."""
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT / "bench"), str(ROOT / "src")]


@pytest.fixture(autouse=True)
def one_thread():
    import torch
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)
