"""The traffic generator: the same seed gives the same inputs, another seed
other inputs of the same sizes."""
from __future__ import annotations

import json

import numpy as np

from port_bench import traffic
from port_bench.clouds import drive as DRIVE
from port_bench.weights import make_weights

from .conftest import BENCH, SEED


def _mix(name):
    return json.loads((BENCH / "traffic" / f"{name}.json").read_text())


def _small(name):
    tr = _mix(name)
    tr.update(beams=16, azimuths=128, frames=min(tr["frames"], 6), points=256)
    if tr["entry"] == "train":
        tr["batches"] = 1
    return tr


def test_train_batches_deterministic_by_seed():
    tr = _small("drive_train")
    a, b, c = (traffic.make(tr, s, DRIVE, batches=True) for s in (SEED, SEED, SEED + 1))
    for x, y, z in zip(a, b, c):
        assert set(x) == {"template", "source", "template_mask", "source_mask", "aug_template",
                          "aug_source", "y"}
        for k in x:
            assert np.array_equal(x[k], y[k]) and x[k].shape == z[k].shape and x[k].dtype == z[k].dtype
        assert not np.array_equal(x["template"], z["template"])


def test_raw_frames_deterministic_by_seed():
    tr = _small("drive_sequential")
    a, b, c = (traffic.make(tr, s, DRIVE) for s in (SEED, SEED, SEED + 1))
    assert len(a) == len(c) == tr["frames"]
    for x, y in zip(a, b):
        assert np.array_equal(x, y) and x.shape[1] == 4
    assert not np.array_equal(a[0], c[0])
    assert traffic.helper_seed(SEED) == traffic.helper_seed(SEED)


def test_drive_labels_map_source_to_template():
    tr = _small("drive_train")
    batch = traffic.make(tr, SEED, DRIVE, batches=True)[0]
    y = batch["y"]
    assert np.allclose(np.linalg.norm(y[:, :4], axis=1), 1.0, atol=1e-5)
    # neighbouring frames ~1.2 m apart: the translation of the dual part
    assert np.all(np.abs(y[:, 4:]).max(axis=1) > 0.1)


def test_augmentation_moves_the_source_and_its_label_together():
    """The recipe's augmentation R: the source moves by inv(R) on the device
    and the label by R, so template ~ label @ aug_source @ source still; the
    pairs of a batch get labels that differ."""
    tr = _small("drive_train")
    tr.update(frames=6, pairs_per_batch=5)
    plain = dict(tr, augment=None)
    rng = traffic.rng_for(SEED, traffic.DATA_STREAM)
    frames = DRIVE.frames(tr, rng)
    (_, _, aug, motion), = traffic.train_pairs(tr, frames, rng, 1)
    (_, _, aug0, motion0), = traffic.train_pairs(plain, frames, rng, 1)
    assert np.allclose(aug0, np.eye(4)) and not np.allclose(aug, np.eye(4))
    assert np.allclose(motion @ aug, motion0)
    y = traffic.make(tr, SEED, DRIVE, batches=True)[0]["y"]
    assert np.abs(y - y.mean(0)).max() > 0.05


def test_weights_deterministic_by_seed():
    cfg = json.loads((BENCH / "configs" / "kitti_flagship.json").read_text())["model"]
    a, b, c = (make_weights(cfg, s, "cpu") for s in (SEED, SEED, SEED + 1))
    assert a.keys() == c.keys()
    assert all(np.array_equal(a[k].numpy(), b[k].numpy()) for k in a)
    assert not np.array_equal(a["_merge_layers.1.output.weight"].numpy(), c["_merge_layers.1.output.weight"].numpy())
