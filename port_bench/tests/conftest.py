"""Fixtures of the benchmark's own tests: a copy of the benchmark's data
files and named modules cut to a size the CPU runs in seconds (the
kernels' plain twins run there), and the card check of the tests marked
``cuda``."""
from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

BENCH = REPO / "port_bench"
DATA_DIRS = ("configs", "traffic", "limits", "metrics", "entries", "clouds")
SEED = 2 ** 31 + 77  # above 32 signed bits, as a seed may be


def cut_to_cpu(root: Path) -> None:
    """Fewer points, centres, rays and training pairs; every width and every rule as the cell has them."""
    for path in (root / "configs").glob("*.json"):
        cfg = json.loads(path.read_text())
        cfg["num_points"] = 1024 if cfg["num_points"] > 4096 else 512
        cfg["model"]["params"]["cloud_features"]["params"]["npoint"] = [64]
        path.write_text(json.dumps(cfg))
    for path in (root / "traffic").glob("*.json"):
        tr = json.loads(path.read_text())
        tr.update(beams=16, azimuths=128)
        # training clouds at the model's size; raw frames larger, so the helper subsamples
        tr["points"] = 1024 if tr["entry"] == "train" else 3000
        tr["trace_units"] = 2
        if tr["entry"] == "train":   # the CPU's batch: few pairs, each of its own frames
            tr.update(pairs_per_batch=min(tr["pairs_per_batch"], 5), frames=min(tr["frames"], 6))
        path.write_text(json.dumps(tr))


@pytest.fixture(scope="session", autouse=True)
def few_threads():
    """Test workers run side by side: two CPU threads each."""
    import torch

    torch.set_num_threads(2)


@pytest.fixture
def cpu_root(tmp_path) -> Path:
    """A benchmark root (``BENCHMARK.json``, the data files and the modules
    found by name) at CPU size."""
    root = tmp_path / "bench"
    for d in DATA_DIRS:
        shutil.copytree(BENCH / d, root / d, ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(REPO / "BENCHMARK.json", root / "BENCHMARK.json")
    cut_to_cpu(root)
    return root


@pytest.fixture
def cpu_spec(cpu_root):
    from port_bench.spec import Spec

    return Spec.load(cpu_root / "BENCHMARK.json", root=cpu_root)


@pytest.fixture
def cuda_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is False)")
    return torch.device("cuda", 0)
