"""Ray-cast HDL-64 drives (``yardstick/synthetic.py``), one run through each
world of the traffic file's ``worlds``: ``frames`` scans (``beams``,
``azimuths``, ``speed`` m a frame) along the world's path among its boxes.

A world is fixed data, as a dataset's sequence is: its path and its boxes
come from ``rng_for(world seed, WORLD_STREAM)`` and never from the run's
seed.  Its boxes cover the envelope of a ``drive_frames``-frame drive (by
default ``frames``), of which the run scans ``frames`` consecutive poses,
so that a short run sees its boxes as densely as a long drive does.  Each
scan's draws (azimuth phase, range noise, which hits it keeps, intensity)
come from ``rng``, the run's.  ``points`` draws each scan's points from its
hits (with repeats where there are fewer), so every seed gives clouds of
the same sizes; ``null`` keeps every hit, a raw scan."""
from port_bench.traffic import WORLD_STREAM, rng_for
from port_bench.yardstick import synthetic


def world(traffic, seed: int):
    """(poses, boxes) of world ``seed``, whatever the run's seed."""
    frames = int(traffic["frames"])
    return synthetic.world(rng_for(seed, WORLD_STREAM), frames, speed=float(traffic.get("speed", 1.2)),
                           drive_frames=int(traffic.get("drive_frames", frames)))


def runs(traffic, rng):
    return [list(synthetic.drive(rng, world(traffic, w), traffic.get("points"),
                                 n_beams=int(traffic.get("beams", 64)), n_azimuths=int(traffic.get("azimuths", 2048))))
            for w in traffic["worlds"]]
