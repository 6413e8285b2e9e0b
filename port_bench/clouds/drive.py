"""One ray-cast HDL-64 drive (``yardstick/synthetic.py``): ``frames`` scans
(``beams``, ``azimuths``, ``speed`` m a frame) of one scene along a smooth
path.  ``points`` draws each scan's points from its hits (with repeats
where there are fewer), so every seed gives clouds of the same sizes;
``null`` keeps every hit, a raw scan."""
from port_bench.yardstick import synthetic


def frames(traffic, rng):
    return list(synthetic.drive(
        rng, int(traffic["frames"]), traffic.get("points"), speed=float(traffic.get("speed", 1.2)),
        n_beams=int(traffic.get("beams", 64)), n_azimuths=int(traffic.get("azimuths", 2048))))
