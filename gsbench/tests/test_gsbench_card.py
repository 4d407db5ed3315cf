"""On the card: one short run of each cell through the command line comes
out correct (run with ``python -m pytest gsbench/tests -m cuda``)."""
import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["garden1m-refine", "garden6m-refine",
                                  "garden6m-serve"])
def test_cell_on_the_card(cell, card):
    out = subprocess.run(
        [sys.executable, "-m", "gsbench.run", "--workload", cell, "--seed",
         "2147483700", "--seconds", "2", "--trace", "0"], cwd=ROOT,
        capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    assert json.loads(out.stdout.strip().splitlines()[-1])["correct"]
