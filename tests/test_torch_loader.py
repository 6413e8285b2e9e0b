"""The port's data loader (deepclr_tpu_torch.data.loader) against the JAX
package's on the CPU, over packs written in the test: at ``num_workers: 0``
the batches are equal key for key, bit for bit, for two epochs (the epoch
seeds, the shuffles, the transforms' and the batcher's draws all follow the
JAX order).  With worker threads the workers share one transform Generator,
and worker processes reseed theirs, so there only the order, the shapes, the
count and what draws nothing (labels, names, stamps) are held."""
import copy

import numpy as np
import pytest

pytest.importorskip("torch")

from deepclr_tpu.config import Mode as JaxMode  # noqa: E402
from deepclr_tpu.config import create_default_config as jax_default_config  # noqa: E402
from deepclr_tpu.config import finish_config as jax_finish_config  # noqa: E402
from deepclr_tpu.data import make_data_loader as jax_make_data_loader  # noqa: E402
from deepclr_tpu_torch.config import Mode, create_default_config, finish_config  # noqa: E402
from deepclr_tpu_torch.data import DataLoader, PackWriter, make_data_loader, make_dataflow  # noqa: E402

NUM_POINTS = 64


def _write_sequence(path, n_frames, seed):
    rng = np.random.default_rng(seed)
    pose = np.eye(4)
    with PackWriter(str(path)) as w:
        for i in range(n_frames):
            pose = pose.copy()
            pose[0, 3] += 1.0
            pose[1, 3] = 0.1 * np.sin(i)
            w.put(f"{i:06d}", {"idx": i, "timestamp": i * 1e5, "pose": pose,
                               "cloud": (rng.normal(size=(50 + 4 * i, 4)) * 5).astype(np.float32)})


def _write_pairs(path, n_pairs, seed):
    rng = np.random.default_rng(seed)
    with PackWriter(str(path)) as w:
        for i in range(n_pairs):
            m = np.eye(4)
            m[:3, 3] = rng.normal(size=3)
            w.put(f"{i:06d}", {"idx": [i, i + 1], "timestamps": [float(i), float(i + 1)],
                               "clouds": [rng.normal(size=(60 + i, 4)).astype(np.float32),
                                          rng.normal(size=(80 - i, 4)).astype(np.float32)],
                               "transform": m})


def _write_models(path, n_models, seed):
    rng = np.random.default_rng(seed)
    with PackWriter(str(path)) as w:
        for i in range(n_models):
            w.put(f"{i:06d}", {"idx": i, "cloud": rng.normal(size=(70 + 3 * i, 6)).astype(np.float32)})


@pytest.fixture(scope="module")
def packs(tmp_path_factory):
    ws = tmp_path_factory.mktemp("loader")
    _write_sequence(ws / "00.pack", 12, seed=0)
    _write_sequence(ws / "01.pack", 8, seed=1)
    _write_pairs(ws / "pairs.pack", 9, seed=2)
    _write_models(ws / "train.pack", 10, seed=3)
    return ws


NOISE = {"point_noise": {"scale": 0.01}, "translation_noise": {"scale": [0.1, 0.01, 0.01]},
         "rotation_noise_deg": {"scale": [0.1, 0.1, 0.5]}}

CASES = {  # name -> (dataset_type, training, validation, transforms, data_loader, presorted)
    "sequence": ("kitti_odometry_velodyne", "00.pack", "01.pack", NOISE, {"batch_size": 4, "buffer_size": 0}, False),
    "sequence_mix_presorted_prefetch": ("kitti_odometry_velodyne", ["00.pack", "01.pack"], ["01.pack", "00.pack"],
                                        dict(NOISE, nth_point=2, nth_point_random=True, keep_probability=0.9),
                                        {"batch_size": 3, "buffer_size": 2}, True),
    "pairs": ("generic", "pairs.pack", "pairs.pack", dict(NOISE, max_points=70), {"batch_size": 2, "buffer_size": 1},
              False),
    "self_pairs_on_validation": ("modelnet40", "train.pack", "train.pack",
                                 {"on_validation": True, "point_noise": {"scale": 0.02},
                                  "translation_noise": {"type": "uniform", "scale": 0.1},
                                  "rotation_noise_deg": {"type": "uniform", "scale": 5.0}},
                                 {"batch_size": 3, "buffer_size": 0}, False),
}


def _cfg_dict(ws, case, **data_loader):
    dataset_type, training, validation, transforms, dl, presorted = CASES[case]

    def path(p):
        return [str(ws / x) for x in p] if isinstance(p, list) else str(ws / p)

    input_dim = 3 if dataset_type == "modelnet40" else 4
    return {"base_dir": str(ws), "seed": 3,
            "data": {"training": path(training), "validation": path(validation), "dataset_type": dataset_type},
            "transforms": copy.deepcopy(transforms),
            "data_loader": dict(dl, num_points=NUM_POINTS, num_workers=0, **data_loader),
            "model": {"input_dim": input_dim, "point_dim": 3, "label_type": "pose3d_dual_quat",
                      "model_type": "deepclr", "params": {"presorted": presorted}}}


def _configs(d):
    port, ref = create_default_config(Mode.TEST), jax_default_config(JaxMode.TEST)
    for cfg, finish in ((port, finish_config), (ref, jax_finish_config)):
        cfg.read_dict(copy.deepcopy(d))
        finish(cfg)
    return port, ref


def _assert_batches_equal(got, ref):
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert sorted(g) == sorted(r)
        for k in r:
            if k == "d":
                assert g[k] == r[k]
                continue
            assert g[k].dtype == r[k].dtype, k
            np.testing.assert_array_equal(g[k], r[k], err_msg=k)


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("is_train", [True, False])
def test_loader_batches_equal_jax_for_two_epochs(packs, case, is_train):
    port_cfg, jax_cfg = _configs(_cfg_dict(packs, case))
    port, ref = make_data_loader(port_cfg, is_train), jax_make_data_loader(jax_cfg, is_train)
    assert len(port) == len(ref) > 0
    for _ in range(2):
        got, want = list(port), list(ref)
        assert len(got) == len(port)
        _assert_batches_equal(got, want)


def test_presorted_batches_are_morton_sorted(packs):
    from deepclr_tpu_torch.ops.morton import morton_argsort_np

    port_cfg, _ = _configs(_cfg_dict(packs, "sequence_mix_presorted_prefetch"))
    for batch in make_data_loader(port_cfg, True):
        for cloud, mask in zip(batch["template"], batch["template_mask"]):
            valid = cloud[mask]
            np.testing.assert_array_equal(morton_argsort_np(valid), np.arange(len(valid)))


def test_len_drops_the_remainder_only_when_training(packs):
    port_cfg, _ = _configs(_cfg_dict(packs, "sequence"))  # 11 training pairs, 7 validation pairs, batch 4
    train, val = make_data_loader(port_cfg, True), make_data_loader(port_cfg, False)
    assert len(train) == 2 and [b["y"].shape[0] for b in train] == [4, 4]
    assert len(val) == 2 and [b["y"].shape[0] for b in val] == [4, 3]
    assert len(make_dataflow(port_cfg, False, source=str(packs / "00.pack"), batch_size=5)) == 3
    d = _cfg_dict(packs, "sequence")
    d["data"]["validation"] = None
    no_val, _ = _configs(d)
    assert make_data_loader(no_val, False) is None
    assert len(make_data_loader(no_val, False, source=str(packs / "01.pack"))) == 2


def test_shards_are_disjoint_and_exhaustive(packs):
    port_cfg, _ = _configs(_cfg_dict(packs, "sequence"))
    stamps = []
    for shard in range(3):
        loader = DataLoader(port_cfg, is_train=False, source=port_cfg.data.training, batch_size=1,
                            shard_index=shard, num_shards=3)
        assert len(loader) == 3  # 11 pairs: each shard runs the smallest shard's 3
        stamps.append({float(b["t"][0, 0]) for b in loader})
    assert not (stamps[0] & stamps[1]) and not (stamps[0] & stamps[2]) and not (stamps[1] & stamps[2])
    assert sum(len(s) for s in stamps) == 9


@pytest.mark.parametrize("worker_type", ["thread", "process"])
def test_worker_loaders_keep_order_shapes_and_labels(packs, worker_type):
    """Point noise only: the clouds draw, the labels, names and stamps do not."""
    d = _cfg_dict(packs, "sequence", worker_type=worker_type)
    d["transforms"] = {"point_noise": {"scale": 0.01}}
    d["data_loader"].update(buffer_size=2)
    serial, _ = _configs(d)
    d["data_loader"]["num_workers"] = 2
    workers, _ = _configs(d)
    ref, got = list(make_data_loader(serial, True)), list(make_data_loader(workers, True))
    assert len(got) == len(ref) == 2
    for g, r in zip(got, ref):
        assert {k: np.shape(v) for k, v in g.items()} == {k: np.shape(v) for k, v in r.items()}
        for k in ("y", "t", "aug_source", "template_mask"):
            np.testing.assert_array_equal(g[k], r[k], err_msg=k)
        assert g["d"] == r["d"]
        assert not np.array_equal(g["template"], r["template"]) or worker_type == "thread"


def test_an_early_stop_stops_the_prefetcher(packs):
    """Leaving the loop after one batch (the trainer at its last iteration)
    ends the producer thread."""
    import threading

    d = _cfg_dict(packs, "sequence")
    d["data_loader"].update(buffer_size=1, batch_size=1)
    port_cfg, _ = _configs(d)
    before = threading.active_count()
    it = iter(make_data_loader(port_cfg, True))
    next(it)
    it.close()
    assert threading.active_count() == before
