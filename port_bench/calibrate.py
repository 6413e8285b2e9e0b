"""The readings that the limits of ``correct`` are set from, on the card.

    python3 port_bench/calibrate.py --workload <cell> --seeds 1,2,3 [--seconds 2] [--extras control,half_batch]

Runs the cell once a seed, all in one process, through the same set-up,
window and check as ``run.py`` (a short window at the cell's own load), and
prints one JSON line a seed: the program's compared numbers and those of
each extra reading: ``control`` (the reference at float8 in the program's
place) and ``half_batch`` (a training fault: the forward over the whole
batch, the loss's mean over its first half only).  The benchmark's own
runs never run these.
"""
import argparse
import json
import sys
import time
from pathlib import Path


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True)
    parser.add_argument("--seconds", type=float, default=2.0)
    parser.add_argument("--extras", default="control")
    args = parser.parse_args(argv)
    sys.path.insert(0, str(Path.cwd()))

    import torch

    from port_bench.harness import run_cell
    from port_bench.spec import Spec, find_bench_file

    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 1
    spec = Spec.load(find_bench_file())
    extras = [e for e in args.extras.split(",") if e]
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        r = run_cell(spec, args.workload, seed, args.seconds, False, torch.device("cuda", 0), t0, extras)
        print(json.dumps({"workload": args.workload, "seed": seed, "correct": r["correct"],
                          "attempted": r["attempted"], "readings": r["readings"],
                          "metrics": {k: v["value"] for k, v in r["metrics"].items()}, "setup_split": r["setup_split"],
                          "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
