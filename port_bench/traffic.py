"""The one traffic generator: a traffic file's parameters and the seed ->
the inputs of a cell, on the host, as the program's callers hand them.

``clouds`` names the source of clouds, ``clouds/<name>.py``, whose
``runs(traffic, rng)`` gives a list of runs, each a sequence of (pose,
cloud), from the file's parameters; what stays fixed from run to run (a
drive's worlds) is the source's own data and its own concern.  The run's
seed draws everything a caller draws afresh each run: whatever the source
draws from ``rng``, the augmentation and the point noise (``DATA_STREAM``),
the helper's seed and the weights.  ``entry`` names the way the cell drives
the program (``entries/<name>.py``); a training entry asks for ``batches``
batch dicts of ``pairs_per_batch`` pairs (the loader's keys and dtypes),
the others for the raw clouds, run after run.

A training pair is frame i of a run as the template and frame i +
``stride`` of the same run as the source, so that no pair spans two runs.
Pairs take the runs in turn (pair j from run j mod R) and go over each
run's consecutive i, starting again at its first frame once its frames run
out (as an epoch does), each pair with draws of its own, so a batch mixes
the runs as a batch shuffled from several sequences does.  ``augment``
applies the recipe's transforms (``transforms`` of
``configs/training/kitti_00-10.yaml``, all normal): a random motion R of
the source (``translation_noise`` m and ``rotation_noise_deg`` a axis),
deferred to the device as the source's augmentation inv(R) and folded into
the label, then ``point_noise`` on the coordinates of both clouds.  Every
size is fixed by the file.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np

from .yardstick import synthetic

DATA_STREAM = 0  # np.random.default_rng([seed, stream]) streams of a run
HELPER_STREAM = 1
SAMPLE_STREAM = 2
WORLD_STREAM = 3  # clouds/drive.py's, with a world seed in place of the run's


def rng_for(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng([int(seed), stream])


def helper_seed(seed: int) -> int:
    """The seed the benchmark gives the inference helper's own generator."""
    return int(rng_for(seed, HELPER_STREAM).integers(2 ** 62))


def _augmentation(augment, rng) -> np.ndarray:
    """The recipe's random motion of the source, R (4, 4)."""
    t = rng.normal(0.0, augment["translation_noise"])
    roll, pitch, yaw = np.deg2rad(rng.normal(0.0, augment["rotation_noise_deg"]))
    m = np.eye(4)
    m[:3, :3] = synthetic.euler_to_matrix(roll, pitch, yaw)
    m[:3, 3] = t
    return m


def train_pairs(traffic, runs, rng, count: int):
    """(template, source, source augmentation, label motion) of ``count``
    pairs from ``runs``, the source's runs of frames."""
    stride = int(traffic.get("stride", 1))
    augment = traffic.get("augment")
    distinct = [len(frames) - stride for frames in runs]
    if min(distinct) < 1:
        raise ValueError(f"traffic: {min(map(len, runs))} frames give no pair of stride {stride}")
    for j in range(count):
        k = j % len(runs)
        i = (j // len(runs)) % distinct[k]
        (pose0, cloud0), (pose1, cloud1) = runs[k][i], runs[k][i + stride]
        motion = np.linalg.inv(pose0) @ pose1    # template ~ motion @ source
        aug = np.eye(4)
        if augment:
            r = _augmentation(augment, rng)
            aug, motion = np.linalg.inv(r), motion @ r
            sigma = float(augment.get("point_noise", 0.0))
            cloud0, cloud1 = (np.concatenate([c[:, :3] + rng.normal(0.0, sigma, (c.shape[0], 3)), c[:, 3:]], 1)
                              for c in (cloud0, cloud1))
        yield cloud0, cloud1, aug, motion


def train_batches(traffic, runs, rng) -> List[Dict[str, np.ndarray]]:
    per, count = int(traffic["pairs_per_batch"]), int(traffic["batches"])
    pairs = list(train_pairs(traffic, runs, rng, per * count))
    batches = []
    for i in range(count):
        rows = pairs[i * per:(i + 1) * per]
        template = np.stack([r[0] for r in rows]).astype(np.float32)
        source = np.stack([r[1] for r in rows]).astype(np.float32)
        batches.append({
            "template": template,
            "source": source,
            "template_mask": np.ones(template.shape[:2], bool),
            "source_mask": np.ones(source.shape[:2], bool),
            "aug_template": np.tile(np.eye(4, dtype=np.float32), (per, 1, 1)),
            "aug_source": np.stack([r[2] for r in rows]).astype(np.float32),
            "y": synthetic.dual_quat_label(np.stack([r[3] for r in rows])).astype(np.float32),
        })
    return batches


def make(traffic, seed: int, clouds, batches: bool = False):
    """The cell's inputs from the cloud source module ``clouds``: a list of
    training batch dicts (``batches``) or of raw clouds, run after run."""
    rng = rng_for(seed, DATA_STREAM)
    runs = clouds.runs(traffic, rng)
    if batches:
        return train_batches(traffic, runs, rng)
    return [cloud for frames in runs for _, cloud in frames]
