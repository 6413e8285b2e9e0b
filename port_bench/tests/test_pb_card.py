"""On the card: the command end to end, from the root of the checkout, prints the
contract's last line with ``correct`` true; skipped without a card."""
from __future__ import annotations

import json
import subprocess
import sys

import pytest

from .conftest import REPO, SEED


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [0, 1])
def test_command_on_the_card(cuda_card, trace):
    out = subprocess.run([sys.executable, "port_bench/run.py", "--workload", "kitti.odometry", "--seed",
                          str(SEED), "--seconds", "2", "--trace", str(trace)],
                         cwd=REPO, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["platform"] == "gpu"
    assert list(line)[-1] == "check"
    assert out.stderr.strip().splitlines()[-1].startswith("check ")
    if trace:
        assert line["device"]["busy_s"] > 0 and "breakdown" in line
