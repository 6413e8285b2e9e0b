"""The work each candidate world asks of the first set abstraction, for
choosing a traffic file's ``worlds`` by the data, never by the program's
time.

    python3 port_bench/worlds.py --traffic <name> --config <name> [--pick 0.2,0.4,0.6,0.8]

Ray-casts world seeds 0 to ``CANDIDATES`` - 1 at the traffic file's sizes,
each with the draws of one fixed run seed, and counts each cloud's
in-radius (centre, point) pairs of the first stage at every radius under
the reference's own FPS centres (``yardstick/roofline.py::ball_pairs``), on
the CPU.  A raw scan, larger than the model's clouds, is first subsampled
to the model's points without replacement, as the inference helper's pad
does.  Prints a JSON line a world (its mean pairs a cloud at each radius),
then one with the worlds whose count at the largest radius lies nearest
each asked percentile of the candidates' counts.
"""
import argparse
import json
import sys
from pathlib import Path

import numpy as np

DRAW_SEED = 0
CANDIDATES = 20


def world_pairs(spec, traffic, config, world: int):
    """Mean in-radius pairs a cloud of one world, a count a radius."""
    import torch

    from port_bench import traffic as generator
    from port_bench.yardstick import roofline

    clouds = generator.make(dict(traffic, worlds=[world]), DRAW_SEED, spec.clouds(traffic["clouds"]))
    n = int(config["num_points"])
    rng = generator.rng_for(DRAW_SEED, generator.SAMPLE_STREAM)
    xyz = torch.from_numpy(np.stack([c[rng.choice(len(c), n, replace=False), :3] if len(c) > n else c[:, :3]
                                     for c in clouds]))
    counts = roofline.ball_pairs(config["model"], xyz, torch.ones(xyz.shape[:2], dtype=torch.bool))
    return [c / len(clouds) for c in counts]


def pick(counts, percentiles):
    """The worlds nearest each percentile of ``counts`` (world -> count), each once."""
    left, chosen = dict(counts), []
    for p in percentiles:
        target = np.percentile(list(counts.values()), 100 * p)
        best = min(left, key=lambda w: (abs(left[w] - target), w))
        chosen.append(best)
        del left[best]
    return chosen


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--traffic", required=True)
    parser.add_argument("--config", required=True)
    parser.add_argument("--pick", default="0.5")
    args = parser.parse_args(argv)
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

    import torch

    from port_bench.spec import Spec

    torch.set_num_threads(2)
    spec = Spec({})
    traffic, config = spec.traffic(args.traffic), spec.config(args.config)
    radii = config["model"]["params"]["cloud_features"]["params"]["radii"][0]
    counts = {}
    for w in range(CANDIDATES):
        pairs = world_pairs(spec, traffic, config, w)
        counts[w] = pairs[-1]
        print(json.dumps({"world": w, "pairs_per_cloud": dict(zip(map(str, radii), pairs))}), flush=True)
    percentiles = [float(p) for p in args.pick.split(",")]
    print(json.dumps({"traffic": args.traffic, "radius": radii[-1], "percentiles": percentiles,
                      "worlds": pick(counts, percentiles)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
