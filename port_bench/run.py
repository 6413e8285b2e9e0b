"""The benchmark of ``deepclr_tpu_torch`` on one NVIDIA card.

    python3 port_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout that holds ``BENCHMARK.json``.  Builds the
cell's program from its configuration file and weights from the seed,
makes its inputs from its traffic file and the seed, warms up, measures for
``--seconds``, checks the window's outputs against the plain reference and
prints the result as the last line of standard output (the end-to-end
metrics with ``--trace 0``, the per-layer ones with ``--trace 1``).  Each
compared number and its limit are the last lines of standard error.  Exits
with 1, printing no result, without a CUDA card or with fewer than the cell
needs, or when the JAX package or JAX was loaded.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    root = Path.cwd()
    # the program's build and kernel caches stay inside the checkout, at fixed paths
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ[var] = str(root / ".bench_cache" / sub)
    sys.path.insert(0, str(root))

    import torch

    from port_bench.harness import forbidden_modules, run_cell
    from port_bench.spec import Spec, find_bench_file

    spec = Spec.load(find_bench_file(root))
    w = spec.workload(args.workload)
    if not torch.cuda.is_available():
        print("port_bench: no CUDA device", file=sys.stderr)
        return 1
    if torch.cuda.device_count() < int(w["chips"]):
        print(f"port_bench: {args.workload} needs {w['chips']} cards, "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 1
    result = run_cell(spec, args.workload, args.seed, args.seconds, bool(args.trace),
                      torch.device("cuda", 0), T_START)
    result.pop("readings")
    split = result.pop("setup_split")
    marks = result.pop("marks")
    found = forbidden_modules()
    if found:
        print(f"port_bench: loaded in the measuring process: {', '.join(found)}", file=sys.stderr)
        return 1
    print("setup " + " ".join(f"{k} {v:.3f}" for k, v in split.items()), file=sys.stderr)
    print("window " + " ".join(f"{t:.2f}:{n}" for t, n in marks), file=sys.stderr)
    for name, c in result["check"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
