"""The benchmark's definition: every name in ``BENCHMARK.json`` finds its
file, every name and unit keeps to the allowed characters, the metric
files agree with their entries, and a new configuration, traffic mix and
metric run as added files without an edit to any file that is there."""
from __future__ import annotations

import json
import re
import shutil

import pytest
import torch

from port_bench.spec import NAME, UNIT, Spec

from .conftest import BENCH, REPO, SEED

KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
ENTRY_KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source", "workloads"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves", "workloads"},
}
TEXT = re.compile(r"^[^\t\n\r]{1,200}$")


@pytest.fixture(scope="module")
def bench():
    return json.loads((REPO / "BENCHMARK.json").read_text())


def test_keys_and_characters(bench):
    assert set(bench) == KEYS
    assert (REPO / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert 1 <= bench["run_seconds"] <= 51 and isinstance(bench["run_seconds"], int)
    for kind, allowed in ENTRY_KEYS.items():
        names = [e["name"] for e in bench[kind]]
        assert len(names) == len(set(names)), kind
        for e in bench[kind]:
            assert set(e) <= allowed and set(e) >= allowed - {"workloads"}, (kind, e["name"])
            assert NAME.match(e["name"]), e["name"]
            for key in ("why", "layer", "source"):
                if key in e and kind in ("configs", "workloads", "per_layer") and key != "source":
                    assert TEXT.match(e[key]), (e["name"], key)
            if "unit" in e:
                assert UNIT.match(e["unit"]), e["unit"]
            if "better" in e:
                assert e["better"] in ("lower", "higher")
    for c in bench["configs"]:
        assert TEXT.match(c["source"]) and c["source"].startswith("https://")
        assert all(NAME.match(k) for k in c["reduced"])
    for w in bench["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"]) and w["chips"] in (1, 4)
    for m in bench["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0 < m["bound"] <= 0.25
    assert [m["name"] for m in bench["end_to_end"]] == ["train_pairs_per_s", "frame_ms_p95", "setup_s"]
    assert all(len(w) <= 200 for w in bench["command"]) and len(bench["command"]) <= 32


def test_every_name_finds_its_file(bench):
    spec = Spec(bench)
    for c in bench["configs"]:
        assert (REPO / c["file"]).is_file()
        assert spec.config(c["name"])["name"] == c["name"]
    pairs = set()
    for w in bench["workloads"]:
        spec.config(w["config"])
        tr = spec.traffic(w["traffic"])
        assert isinstance(spec.entry(tr["entry"]), type) and callable(spec.clouds(tr["clouds"]).runs)
        assert set(spec.limits(w["name"]))
        pairs.add((w["config"], w["traffic"]))
        names = {m["name"] for m in spec.end_to_end(w["name"])}
        assert "setup_s" in names and len(names) >= 2, w["name"]
        assert spec.per_layer(w["name"]), w["name"]
    assert len(pairs) == len(bench["workloads"])
    assert {c["name"] for c in bench["configs"]} == {w["config"] for w in bench["workloads"]}


def test_metric_files_agree_with_their_entries(bench):
    """Each entry's fields are its file's, its cells those of the file's
    ``WORKLOADS``, and every metric file has its entry."""
    spec = Spec(bench)
    cells = {w["name"] for w in bench["workloads"]}
    moved = {m["name"]: set(m.get("workloads", cells)) for m in bench["end_to_end"]}
    layers = {}
    for m in bench["per_layer"]:
        reader = spec.reader(m["name"])
        assert (reader.UNIT, reader.BETTER, reader.SOURCE, reader.LAYER, reader.MOVES) == (
            m["unit"], m["better"], m["source"], m["layer"], m["moves"]), m["name"]
        assert m["workloads"] == reader.WORKLOADS and set(m["workloads"]) <= cells, m["name"]
        assert set(m["workloads"]) <= moved[m["moves"]], m["name"]
        layers.setdefault(m["layer"].lower(), set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())
    assert {m["name"] for m in bench["per_layer"]} == {p.name[:-3] for p in (BENCH / "metrics").glob("*.py")}


def test_every_data_file_serves_a_cell(bench):
    """No configuration, traffic mix, limits, entry or cloud source that no
    cell uses."""
    spec = Spec(bench)
    traffic = {w["traffic"]: spec.traffic(w["traffic"]) for w in bench["workloads"]}
    used = {"configs": {w["config"] for w in bench["workloads"]}, "traffic": set(traffic),
            "limits": {w["name"] for w in bench["workloads"]},
            "entries": {t["entry"] for t in traffic.values()}, "clouds": {t["clouds"] for t in traffic.values()}}
    for kind, names in used.items():
        found = {p.stem for p in (BENCH / kind).iterdir() if p.suffix in (".json", ".py")}
        assert found == names, kind


def test_missing_file_is_refused(tmp_path, bench):
    spec = Spec(bench, root=tmp_path)
    with pytest.raises(FileNotFoundError):
        spec.config("kitti_flagship")
    with pytest.raises(ValueError):
        spec.traffic("../etc")


def test_added_files_run_without_an_edit(cpu_root):
    """A new configuration, traffic mix, limits, metric, entry and cloud
    source, each a new file, with new entries in BENCHMARK.json: the cell
    runs, and the metric's reader is found by its name."""
    from port_bench import trace as tracing
    from port_bench.base import Spans
    from port_bench.harness import Cell, Readings, run_cell

    before = {p: p.read_bytes() for p in cpu_root.rglob("*") if p.is_file() and p.name != "BENCHMARK.json"}
    cfg = json.loads((cpu_root / "configs" / "kitti_flagship.json").read_text())
    cfg["name"] = "kitti_copy"
    (cpu_root / "configs" / "kitti_copy.json").write_text(json.dumps(cfg))
    # a cloud source of its own: the drive, each cloud's rows reversed
    (cpu_root / "clouds" / "drive_reversed.py").write_text(
        "from port_bench.clouds import drive\n\n\n"
        "def runs(traffic, rng):\n"
        "    return [[(pose, cloud[::-1].copy()) for pose, cloud in run] for run in drive.runs(traffic, rng)]\n")
    # an entry of its own: the training entry, marking the cloud source it was given
    (cpu_root / "entries" / "train_marked.py").write_text(
        "from port_bench.entries.train import TrainEntry\n\n\n"
        "class Marked(TrainEntry):\n"
        "    def run(self, seconds):\n"
        "        window = super().run(seconds)\n"
        "        self.marks.append(('clouds', self.cell.clouds.__name__))\n"
        "        return window\n\n\n"
        "ENTRY = Marked\n")
    tr = json.loads((cpu_root / "traffic" / "drive_train.json").read_text())
    tr.update(batches=3, frames=16, clouds="drive_reversed", entry="train_marked")
    (cpu_root / "traffic" / "drive_train_short.json").write_text(json.dumps(tr))
    shutil.copy(cpu_root / "limits" / "kitti.train.json", cpu_root / "limits" / "copy.train.json")
    (cpu_root / "metrics" / "steps_seen.copy.py").write_text(
        'NAME = "steps_seen.copy"\nUNIT = "steps"\nBETTER = "higher"\nSOURCE = "program_counter"\n'
        'LAYER = "trainer and model"\nMOVES = "train_pairs_per_s"\nWORKLOADS = ["copy.train"]\n\n\n'
        'def read(r):\n    return float(r.window["micro_steps"])\n')
    bench = json.loads((cpu_root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "kitti_copy", "source": "https://arxiv.org/abs/2007.11255",
                             "file": "port_bench/configs/kitti_copy.json", "reduced": [], "why": "a copy"})
    bench["workloads"].append({"name": "copy.train", "config": "kitti_copy", "traffic": "drive_train_short",
                               "chips": 1, "why": "a copy"})
    next(m for m in bench["end_to_end"] if m["name"] == "train_pairs_per_s")["workloads"].append("copy.train")
    bench["per_layer"].append({"name": "steps_seen.copy", "unit": "steps", "better": "higher",
                               "source": "program_counter", "layer": "trainer and model",
                               "moves": "train_pairs_per_s", "workloads": ["copy.train"]})
    (cpu_root / "BENCHMARK.json").write_text(json.dumps(bench))
    spec = Spec.load(cpu_root / "BENCHMARK.json", root=cpu_root)

    result = run_cell(spec, "copy.train", SEED, 0.2, False, torch.device("cpu"), 0.0)
    assert result["correct"] and set(result["metrics"]) == {"train_pairs_per_s", "setup_s"}
    assert result["marks"][-1] == ("clouds", "port_bench_clouds_drive_reversed")
    cell = Cell(spec.workload("copy.train"), cfg, tr, SEED, torch.device("cpu"))
    trace = tracing.Trace([("k", 0.0, 1.0)], [], 0.0, 2.0, count=1)
    readings = Readings(cell, {"micro_steps": 4}, Spans(), trace, None)
    assert spec.reader("steps_seen.copy").read(readings) == 4.0
    assert all(p.read_bytes() == b for p, b in before.items())
