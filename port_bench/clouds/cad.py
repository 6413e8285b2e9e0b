"""CAD models as the ModelNet40 recipe trains on them
(``configs/training/modelnet40.yaml``): self-pairs of one model, the source
moved by the recipe's uniform motion.

The file's ``shapes`` models are fixed data, as a dataset's models are:
model s is ``yardstick/cad.py::cad_cloud`` from ``rng_for(s, WORLD_STREAM)``
at ``surface_points`` points, never drawn from the run's seed, reduced to
``points`` by furthest point sampling from its first point, the ModelNet40
converter's rule (``reference/ops.py::fps``; on the card when there is
one, in set-up).  Only xyz is kept.

A run is one pair: ``frames`` 2, the model at the identity, then the model
moved by inv(M) under the pose M, so that the label inv(pose0) @ pose1 is M
and the template is M times the source.  M is drawn from ``rng``, the
run's: a translation U(-t, t) m and a rotation U(-r, r) degrees about each
axis (``motion``: ``translation`` t, ``rotation_deg`` r), translation
first, as the recipe's ``RandomTransform`` draws them.  There is one run a
pair of the traffic (``pairs_per_batch`` x ``batches``), run i of model i
mod ``shapes``, so that each batch of ``shapes`` pairs holds every model
once, as an epoch over the models does.
"""
import numpy as np
import torch

from port_bench.reference import ops
from port_bench.traffic import WORLD_STREAM, rng_for
from port_bench.yardstick import cad, synthetic


def shapes(traffic, count: int) -> list:
    """The first ``count`` models of the file, (``points``, 3) float32 each."""
    surface = np.stack([cad.cad_cloud(rng_for(s, WORLD_STREAM), int(traffic["surface_points"]))[:, :3]
                        for s in range(count)])
    xyz = torch.from_numpy(surface).to("cuda" if torch.cuda.is_available() else "cpu")
    idx = ops.fps(xyz, int(traffic["points"]), torch.ones(xyz.shape[:2], dtype=torch.bool, device=xyz.device))
    picked = torch.gather(xyz, 1, idx[..., None].expand(-1, -1, 3))
    return list(picked.cpu().numpy())


def motion(traffic, rng) -> np.ndarray:
    """The recipe's motion M (4, 4) of a source."""
    t, r = float(traffic["motion"]["translation"]), float(traffic["motion"]["rotation_deg"])
    shift = rng.uniform(-t, t, 3)
    angles = np.deg2rad(rng.uniform(-r, r, 3))
    m = np.eye(4)
    m[:3, :3] = synthetic.euler_to_matrix(*angles)
    m[:3, 3] = shift
    return m


def runs(traffic, rng):
    if int(traffic["frames"]) != 2:
        raise ValueError(f"clouds/cad.py: a run is one pair, 2 frames, not {traffic['frames']}")
    count = int(traffic["pairs_per_batch"]) * int(traffic["batches"])
    models = shapes(traffic, min(count, int(traffic["shapes"])))
    out = []
    for i in range(count):
        cloud = models[i % len(models)]
        m = motion(traffic, rng)
        inv = np.linalg.inv(m)
        moved = (cloud.astype(np.float64) @ inv[:3, :3].T + inv[:3, 3]).astype(np.float32)
        out.append([(np.eye(4), cloud), (m, moved)])
    return out
