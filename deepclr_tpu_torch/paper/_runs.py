"""What the paper scripts share: the sorted walk over a base directory's
run directories (``scripts/paper/kitti_odometry_table.py:26-35, 65-73``),
the evaluator of one run, and the table printer."""
from __future__ import annotations

import math
import os
import os.path as osp
from typing import Dict, Iterator, Tuple

from ..config import Config
from ..evaluation import Evaluator
from ..evaluation.cli import load_scenario_from_dir

__all__ = ["format_table", "load_scenario_from_dir", "print_table", "read_run", "scenario_runs"]


def scenario_runs(path: str, scenario_name: str) -> Iterator[Tuple[str, Config]]:
    """(run directory, its scenario) for every directory of ``path``, in
    sorted order, whose ``scenario.yaml`` names ``scenario_name``; an
    invalid scenario file warns, as in the scripts."""
    for dirname in sorted(os.listdir(path)):
        directory = osp.join(path, dirname)
        if not osp.isdir(directory):
            continue
        scenario = load_scenario_from_dir(directory)
        if scenario is not None and scenario.name == scenario_name:
            yield directory, scenario


def read_run(directory: str, scenario: Config) -> Evaluator:
    """The Evaluator of one run: the sequence files its scenario names."""
    return Evaluator.read(directory, [f"{k}.txt" for k in scenario.data.keys()])


def _field(value) -> str:
    value = float(value)
    return "NaN" if math.isnan(value) else repr(value)


def format_table(data: Dict[str, Dict[str, float]]) -> str:
    """The rows of ``pandas.DataFrame(data).transpose()`` (one a key of
    ``data``, every row with the same columns) as a plain text table: each
    number as its shortest repr, NaN as 'NaN', right-aligned under its
    column name."""
    columns = list(next(iter(data.values())))
    cells = [[""] + columns] + [[str(name)] + [_field(row[c]) for c in columns] for name, row in data.items()]
    widths = [max(len(r[i]) for r in cells) for i in range(len(cells[0]))]
    return "\n".join(r[0].ljust(widths[0]) + "".join("  " + v.rjust(w) for v, w in zip(r[1:], widths[1:]))
                     for r in cells)


def print_table(data: Dict[str, Dict[str, float]]) -> None:
    """Print ``pandas.DataFrame(data).transpose()`` as the scripts do, or,
    where pandas does not import, ``format_table(data)``."""
    try:
        import pandas as pd
    except ImportError:
        print(format_table(data))
        return
    print(pd.DataFrame(data).transpose())
