"""The benchmark's definition, found by name: ``BENCHMARK.json`` at the root
of the checkout, and beside the harness one file per configuration
(``configs/<name>.json``), traffic mix (``traffic/<name>.json``), per-layer
metric (``metrics/<name>.py``) and cell's limits (``limits/<workload>.json``),
and one module per way of driving the program (``entries/<name>.py``, named
by a traffic file's ``entry``) and per source of clouds
(``clouds/<name>.py``, named by its ``clouds``).  A cell, a configuration, a
metric, an entry or a cloud source is added by adding files and entries; no
file of the harness names one."""
from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path
from types import ModuleType
from typing import Dict, List, Optional

HERE = Path(__file__).resolve().parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def check_name(name: str) -> str:
    if not isinstance(name, str) or not NAME.match(name):
        raise ValueError(f"benchmark: bad name {name!r}")
    return name


class Spec:
    def __init__(self, bench: Dict, root: Path = HERE):
        self.bench = bench
        self.root = Path(root)

    @classmethod
    def load(cls, bench_file: Path, root: Path = HERE) -> "Spec":
        return cls(json.loads(Path(bench_file).read_text()), root)

    def _json(self, kind: str, name: str) -> Dict:
        path = self.root / kind / f"{check_name(name)}.json"
        if not path.is_file():
            raise FileNotFoundError(f"benchmark: no {kind[:-1] if kind.endswith('s') else kind} file {path}")
        return json.loads(path.read_text())

    def workload(self, name: str) -> Dict:
        for w in self.bench["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"benchmark: no workload {name!r}")

    def config(self, name: str) -> Dict:
        return self._json("configs", name)

    def traffic(self, name: str) -> Dict:
        return self._json("traffic", name)

    def limits(self, workload: str) -> Dict[str, float]:
        return self._json("limits", workload)

    def end_to_end(self, workload: str) -> List[Dict]:
        return [m for m in self.bench["end_to_end"] if workload in m.get("workloads", [workload])]

    def per_layer(self, workload: str) -> List[Dict]:
        return [m for m in self.bench["per_layer"] if workload in m.get("workloads", [workload])]

    def module(self, kind: str, name: str) -> ModuleType:
        """The module ``<kind>/<name>.py`` beside the benchmark's data."""
        path = self.root / kind / f"{check_name(name)}.py"
        if not path.is_file():
            raise FileNotFoundError(f"benchmark: no {kind} module {path}")
        spec = importlib.util.spec_from_file_location(f"port_bench_{kind}_{re.sub(r'[.-]', '_', name)}", path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        return module

    def reader(self, metric: str) -> ModuleType:
        """The metric's reader module, ``metrics/<name>.py``."""
        module = self.module("metrics", metric)
        if module.NAME != metric:
            raise ValueError(f"benchmark: metrics/{metric}.py reads {module.NAME!r}, not {metric!r}")
        return module

    def entry(self, name: str) -> type:
        """The class ``ENTRY`` of ``entries/<name>.py``: how a cell drives the program."""
        return self.module("entries", name).ENTRY

    def clouds(self, name: str) -> ModuleType:
        """``clouds/<name>.py``: its ``runs(traffic, rng)`` gives a list of
        runs, each a sequence of (pose (4, 4), cloud (N, D)), from a traffic
        file's parameters."""
        return self.module("clouds", name)


def find_bench_file(start: Optional[Path] = None) -> Path:
    """``BENCHMARK.json`` in the working directory (the root of a checkout)."""
    path = Path(start or Path.cwd()) / "BENCHMARK.json"
    if not path.is_file():
        raise FileNotFoundError(f"benchmark: {path} not found; run from the root of the checkout")
    return path
