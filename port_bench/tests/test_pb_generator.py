"""The traffic generator: the same seed gives the same inputs, another seed
other inputs of the same sizes: the same worlds (paths and boxes), other
scans of them and other augmentations."""
from __future__ import annotations

import json

import numpy as np
import pytest

from port_bench import traffic
from port_bench.clouds import drive as DRIVE
from port_bench.weights import make_weights
from port_bench.yardstick import synthetic

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
    runs = DRIVE.runs(dict(tr, worlds=tr["worlds"][:1]), rng)
    (_, _, aug, motion), = traffic.train_pairs(tr, runs, rng, 1)
    (_, _, aug0, motion0), = traffic.train_pairs(plain, runs, rng, 1)
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


def _runs(tr, seed):
    """The frames of each world as ``traffic.make`` draws them."""
    return DRIVE.runs(tr, traffic.rng_for(seed, traffic.DATA_STREAM))


@pytest.mark.parametrize("name", ["drive_train", "drive_sequential"])
def test_seeds_share_the_worlds_and_differ_in_the_scans(name, monkeypatch):
    """Two run seeds drive the same paths among the same boxes; their scans
    of them differ, as two passes of a sensor do."""
    tr = _small(name)
    seen = []
    world = synthetic.world

    def recorded(*args, **kwargs):
        seen.append(world(*args, **kwargs))
        return seen[-1]

    monkeypatch.setattr(synthetic, "world", recorded)
    a, b = _runs(tr, SEED), _runs(tr, SEED + 1)
    assert len(seen) == 2 * len(tr["worlds"])
    for (poses_a, (lo_a, hi_a)), (poses_b, (lo_b, hi_b)) in zip(seen[:len(a)], seen[len(a):]):
        assert all(np.array_equal(p, q) for p, q in zip(poses_a, poses_b))
        assert np.array_equal(lo_a, lo_b) and np.array_equal(hi_a, hi_b)
    for run_a, run_b in zip(a, b):
        assert all(np.array_equal(pa, pb) for (pa, _), (pb, _) in zip(run_a, run_b))
        assert all(ca.shape == cb.shape and not np.array_equal(ca, cb) for (_, ca), (_, cb) in zip(run_a, run_b))


@pytest.mark.parametrize("name", ["drive_train", "drive_sequential"])
def test_same_seed_same_inputs(name):
    tr = _small(name)
    a, b = _runs(tr, SEED), _runs(tr, SEED)
    assert [len(r) for r in a] == [tr["frames"]] * len(tr["worlds"])
    for run_a, run_b in zip(a, b):
        for (pa, ca), (pb, cb) in zip(run_a, run_b):
            assert np.array_equal(pa, pb) and np.array_equal(ca, cb)
    for x, y in zip(traffic.make(tr, SEED, DRIVE, batches=tr["entry"] == "train"),
                    traffic.make(tr, SEED, DRIVE, batches=tr["entry"] == "train")):
        if isinstance(x, dict):
            assert all(np.array_equal(x[k], y[k]) for k in x)
        else:
            assert np.array_equal(x, y)


@pytest.mark.parametrize("name", ["drive_train", "drive_sequential"])
def test_world_does_not_depend_on_the_run_seed(name):
    """Each listed world is what its own seed makes, whatever the run's
    seed; the listed worlds differ from one another."""
    tr = _small(name)
    worlds = [DRIVE.world(tr, w) for w in tr["worlds"]]
    for seed in (SEED, 3):
        for (poses, (lo, hi)), run in zip(worlds, _runs(tr, seed)):
            assert all(np.array_equal(p, q) for p, (q, _) in zip(poses, run))
            assert lo.shape == hi.shape and lo.shape[0] >= 60
    assert len(set(tr["worlds"])) == len(tr["worlds"])
    assert all(not np.array_equal(worlds[0][1][0], w[1][0]) for w in worlds[1:])


def _pair_worlds(tr, seed):
    """(template's world and frame, source's world and frame) of each pair
    of each batch, found among the worlds' frames (no augmentation, so
    the batch holds the frames' own clouds)."""
    tr = dict(tr, augment=None)
    frames = {}
    for w, run in enumerate(_runs(tr, seed)):
        for i, (_, cloud) in enumerate(run):
            frames[cloud.astype(np.float32).tobytes()] = (w, i)
    return [[(frames[t.tobytes()], frames[s.tobytes()]) for t, s in zip(b["template"], b["source"])]
            for b in traffic.make(tr, seed, DRIVE, batches=True)]


def test_every_world_in_every_batch():
    """The batches of ``drive_train`` mix every listed world, as a batch
    shuffled from several sequences does."""
    tr = dict(_small("drive_train"), batches=2)
    batches = _pair_worlds(tr, SEED)
    assert len(batches) == 2 and len(tr["worlds"]) == 4
    for pairs in batches:
        assert {t[0] for t, _ in pairs} == set(range(len(tr["worlds"])))


def test_no_pair_spans_two_worlds():
    """A pair is frame i and i + stride of one world; the pairs run over
    every such i of every world."""
    tr = dict(_small("drive_train"), batches=2)
    pairs = [p for batch in _pair_worlds(tr, SEED) for p in batch]
    assert all(t[0] == s[0] and s[1] == t[1] + tr["stride"] for t, s in pairs)
    assert {t for t, _ in pairs} == {(w, i) for w in range(len(tr["worlds"])) for i in range(tr["frames"] - 1)}


def test_world_is_a_stretch_of_a_longer_drive():
    """``drive_frames`` > ``frames``: the poses are consecutive poses of the
    longer drive, and its boxes cover the whole drive's envelope, not only
    the stretch's."""
    tr = _small("drive_train")
    assert tr["drive_frames"] > tr["frames"]
    poses, (lo, hi) = DRIVE.world(tr, tr["worlds"][0])
    full = synthetic.trajectory(traffic.rng_for(tr["worlds"][0], traffic.WORLD_STREAM), tr["drive_frames"])
    assert len(poses) == tr["frames"]
    assert sum(all(np.array_equal(p, q) for p, q in zip(poses, full[i:]))
               for i in range(len(full) - len(poses) + 1)) == 1
    stretch = np.array([p[:2, 3] for p in poses])
    centres = (lo[:, :2] + hi[:, :2]) / 2
    assert np.ptp(centres[:, 0]) > np.ptp(stretch[:, 0]) + 100
