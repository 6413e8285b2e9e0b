"""The port's remaining host modules against the JAX package's, on files the
tests write (no KITTI or ModelNet40 data ships with the repository):

* ``data/readers.py``: a tiny KITTI odometry layout (scans, times, calib,
  poses; and one without the optional files) and a ModelNet40 split, read
  by both packages in the same shuffled order: every array equal bit for
  bit;
* ``data/lmdb_reader.py``: the hand-written LMDB environment of
  ``tests/data/test_lmdb_import.py`` (overflow pages, the ``__keys__``
  entry) and msgpack-numpy blobs, parsed by the port without the lmdb or
  msgpack packages: the JAX package's values, types and bits;
* ``utils/flops.py``: ``model_flops_per_pair`` equal for the flagship and
  ModelNet40 configurations; the peak raises for a card it does not know;
* ``utils/factory.py``, ``utils/parsing.py``, ``utils/tensor.py``,
  ``utils/profiling.py`` (``device_timer``, a ``torch.profiler`` trace on
  the CPU) and ``utils/pcv.py`` (``save``, when matplotlib imports).
"""
import argparse
import enum
import json
import os.path as osp

import numpy as np
import pytest
import yaml

torch = pytest.importorskip("torch")

from deepclr_tpu.data import lmdb_reader as jax_lmdb  # noqa: E402
from deepclr_tpu.data import readers as jax_readers  # noqa: E402
from deepclr_tpu.utils import flops as jax_flops  # noqa: E402
from deepclr_tpu.utils.factory import factory as jax_factory  # noqa: E402
from deepclr_tpu.utils.parsing import ParseEnum as JaxParseEnum  # noqa: E402
from deepclr_tpu_torch.configs import KITTI_MODEL_CFG  # noqa: E402
from deepclr_tpu_torch.data import lmdb_reader, readers  # noqa: E402
from deepclr_tpu_torch.utils import factory, flops, prepare_tensor  # noqa: E402
from deepclr_tpu_torch.utils.parsing import ParseEnum  # noqa: E402
from deepclr_tpu_torch.utils.profiling import device_timer, sync, trace  # noqa: E402
from tests.data.test_lmdb_import import _msgpack_numpy, _write_lmdb  # noqa: E402

REPO_CONFIGS = osp.join(osp.dirname(osp.dirname(osp.abspath(__file__))), "configs", "training")


def _same(a, b):
    """Equal values, types and (for arrays) dtypes and bits, recursively."""
    assert type(a) is type(b), (type(a), type(b))
    if isinstance(a, np.ndarray) or isinstance(a, np.generic):
        assert a.dtype == b.dtype and np.shape(a) == np.shape(b)
        assert np.asarray(a).tobytes() == np.asarray(b).tobytes()
    elif isinstance(a, dict):
        assert list(a) == list(b)
        for k in a:
            _same(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    else:
        assert a == b


# --- readers ------------------------------------------------------------------------------------------------

@pytest.fixture(scope="module")
def kitti(tmp_path_factory):
    base = tmp_path_factory.mktemp("kitti")
    rng = np.random.default_rng(0)
    for seq, full in (("00", True), ("01", False)):
        velo = base / "sequences" / seq / "velodyne"
        velo.mkdir(parents=True)
        for i in range(7):
            rng.normal(size=(50 + 3 * i, 4)).astype(np.float32).tofile(velo / f"{i:06d}.bin")
        if not full:  # no times, calib or poses: the readers' defaults
            continue
        np.savetxt(base / "sequences" / seq / "times.txt", np.cumsum(rng.uniform(0.09, 0.11, 7)))
        tr = np.concatenate([np.linalg.qr(rng.normal(size=(3, 3)))[0], rng.normal(size=(3, 1))], 1)
        with open(base / "sequences" / seq / "calib.txt", "w") as f:
            f.write("P0: " + " ".join(map(str, rng.normal(size=12))) + "\n")
            f.write("Tr: " + " ".join(f"{v:.12e}" for v in tr.ravel()) + "\n")
        (base / "poses").mkdir()
        poses = []
        for i in range(7):
            r = np.linalg.qr(rng.normal(size=(3, 3)))[0]
            poses.append(np.concatenate([r, [[0.0], [0.0], [1.3 * i]]], 1).ravel())
        np.savetxt(base / "poses" / f"{seq}.txt", np.asarray(poses))
    return str(base)


@pytest.mark.parametrize("seq", ["00", "01"])
def test_kitti_readers_match_jax(kitti, seq):
    got, want = readers.KittiOdometrySequence(kitti, seq), jax_readers.KittiOdometrySequence(kitti, seq)
    assert len(got) == len(want) == 7
    _same(got.timestamps, want.timestamps)
    _same(got.T_cam0_velo, want.T_cam0_velo)
    for i in range(7):
        _same(got.get_velo(i), want.get_velo(i))
        _same(got.get_pose_velo(i), want.get_pose_velo(i))
    _same(readers.cam2velo(want.T_cam0_velo, got.T_cam0_velo), jax_readers.cam2velo(want.T_cam0_velo, got.T_cam0_velo))
    _same(readers.velo2cam(want.T_cam0_velo, got.T_cam0_velo), jax_readers.velo2cam(want.T_cam0_velo, got.T_cam0_velo))
    for shuffle in (False, True):
        _same(list(readers.KittiOdometryVelodyneData(kitti, seq, shuffle=shuffle, seed=5)),
              list(jax_readers.KittiOdometryVelodyneData(kitti, seq, shuffle=shuffle, seed=5)))
        pairs = readers.KittiSamplePairData(kitti, seq, frame_interval=2, max_distance=3.0, shuffle=shuffle, seed=6)
        ref = jax_readers.KittiSamplePairData(kitti, seq, frame_interval=2, max_distance=3.0, shuffle=shuffle, seed=6)
        assert pairs.pairs == ref.pairs and len(pairs) == len(ref) > 0
        _same(list(pairs), list(ref))


def test_a_sequence_without_scans_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        readers.KittiOdometrySequence(str(tmp_path), "00")


def test_modelnet40_reader_matches_jax(tmp_path):
    rng = np.random.default_rng(1)
    names = []
    for shape in ("airplane", "chair", "night_stand"):
        (tmp_path / shape).mkdir()
        for i in (1, 2):
            name = f"{shape}_{i:04d}"
            names.append(name)
            np.savetxt(tmp_path / shape / f"{name}.txt", rng.normal(size=(20, 6)), delimiter=",", fmt="%.6f")
    split = tmp_path / "modelnet40_train.txt"
    split.write_text("\n".join(names) + "\n")
    for shape_list in (None, ["chair", "night_stand"]):
        for shuffle in (False, True):
            got = readers.ModelNet40PointClouds(str(split), shape_list, shuffle=shuffle, seed=3)
            want = jax_readers.ModelNet40PointClouds(str(split), shape_list, shuffle=shuffle, seed=3)
            assert got.data == want.data
            _same(list(got), list(want))


# --- the LMDB parser ----------------------------------------------------------------------------------------

@pytest.fixture
def lmdb_file(tmp_path):
    """tests/data/test_lmdb_import.py's fixture, and a value of every
    msgpack-numpy kind (a numpy scalar, strings, nested lists)."""
    rng = np.random.default_rng(0)
    entries, keys = [], []
    for i in range(3):
        key = f"{i:08d}".encode()
        sample = {b"idx": i, b"timestamp": float(i) * 1e5, b"pose": np.eye(4, dtype=np.float64),
                  b"cloud": rng.normal(size=(700, 4)).astype(np.float32)}
        if i == 2:
            sample.update({b"name": "seq_00", b"scale": np.float32(0.5), b"ids": [np.int64(3), -1, [True, None]]})
        entries.append((key, _msgpack_numpy(sample)))
        keys.append(key)
    entries.append((b"__keys__", _msgpack_numpy(keys)))
    path = tmp_path / "00.lmdb"
    _write_lmdb(path, entries)
    return str(path)


def test_lmdb_parser_matches_jax(lmdb_file):
    got, want = lmdb_reader.LMDBFile(lmdb_file), jax_lmdb.LMDBFile(lmdb_file)
    assert len(got) == len(want) == 4
    _same(list(got.items()), list(want.items()))
    _same(list(lmdb_reader.iter_reference_lmdb(lmdb_file)), list(jax_lmdb.iter_reference_lmdb(lmdb_file)))
    assert lmdb_reader.load_keys(lmdb_file) == jax_lmdb.load_keys(lmdb_file) == [f"{i:08d}" for i in range(3)]
    for _, blob in want.items():
        _same(lmdb_reader.decode_msgpack_numpy(blob), jax_lmdb.decode_msgpack_numpy(blob))


def test_lmdb_parser_rejects_what_is_not_lmdb(tmp_path):
    short = tmp_path / "short.lmdb"
    short.write_bytes(b"\0" * 100)
    with pytest.raises(ValueError):
        lmdb_reader.LMDBFile(str(short))
    bad = tmp_path / "bad.lmdb"
    bad.write_bytes(b"\0" * 3 * 4096)
    with pytest.raises(ValueError, match="magic"):
        lmdb_reader.LMDBFile(str(bad))


# --- flops ------------------------------------------------------------------------------------------------------

def _modelnet40_model():
    with open(f"{REPO_CONFIGS}/modelnet40.yaml") as f:
        return yaml.safe_load(f)["model"]


@pytest.mark.parametrize("name", ["kitti", "modelnet40"])
@pytest.mark.parametrize("num_points", [2048, 16384])
def test_model_flops_match_jax(name, num_points):
    cfg = KITTI_MODEL_CFG if name == "kitti" else _modelnet40_model()
    got = flops.model_flops_per_pair(cfg, num_points)
    assert got == jax_flops.model_flops_per_pair(cfg, num_points) and got > 0


def test_peak_flops_know_the_h100_and_raise_otherwise():
    assert flops.peak_flops_per_chip("NVIDIA H100 80GB HBM3") == 989e12
    with pytest.raises(ValueError):
        flops.peak_flops_per_chip("TPU v5 lite")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            flops.peak_flops_per_chip()
    want = 2000.0 * jax_flops.model_flops_per_pair(KITTI_MODEL_CFG, 16384) / 989e12
    assert flops.mfu(2000.0, KITTI_MODEL_CFG, device_name="NVIDIA H100 80GB HBM3") == pytest.approx(want, rel=1e-12)


# --- factory, parsing, tensor, profiling, pcv ---------------------------------------------------------------

def test_factory_finds_subclasses_by_name():
    class Base:
        def __init__(self, v):
            self.v = v

    class Child(Base):
        pass

    class GrandChild(Child):
        pass

    for make in (factory, jax_factory):
        assert type(make(Base, "GrandChild", 3)) is GrandChild
        assert make(Base, "Child", 5).v == 5 and type(make(Base, "Base", 1)) is Base
        with pytest.raises(ValueError):
            make(Base, "Nope")


class _Mode(enum.Enum):
    NEW = "new"
    CONTINUE = "continue"


def test_parse_enum_matches_jax():
    for action in (ParseEnum, JaxParseEnum):
        parser = argparse.ArgumentParser()
        parser.add_argument("--mode", action=action, enum_type=_Mode, default=_Mode.NEW)
        assert parser.parse_args([]).mode is _Mode.NEW
        assert parser.parse_args(["--mode", "continue"]).mode is _Mode.CONTINUE
        with pytest.raises(SystemExit):
            parser.parse_args(["--mode", "other"])
        with pytest.raises(ValueError):
            argparse.ArgumentParser().add_argument("--x", action=action)


def test_prepare_tensor_moves_nested_containers():
    tree = {"a": np.ones((2, 3), np.float32), "b": [torch.zeros(3, dtype=torch.float64), "keep", (np.arange(2),)],
            "c": 4}
    moved = prepare_tensor(tree, torch.device("cpu"))
    assert isinstance(moved["a"], torch.Tensor) and moved["a"].dtype == torch.float32
    assert torch.equal(moved["a"], torch.ones(2, 3))
    assert moved["b"][0].dtype == torch.float64 and moved["b"][1] == "keep" and moved["c"] == 4
    assert isinstance(moved["b"][2], tuple) and torch.equal(moved["b"][2][0], torch.arange(2))


def test_device_timer_and_a_profiler_trace_on_the_cpu(tmp_path, capsys):
    x = torch.randn(64, 64)
    with device_timer("step") as t:
        out = {"y": [x @ x]}
        sync(out)
    assert t["ms"] >= 0.0 and "step:" in capsys.readouterr().out
    with trace(str(tmp_path / "trace")) as prof:
        (x @ x).sum()
    assert any("mm" in e.key for e in prof.key_averages())
    with open(tmp_path / "trace" / "trace.json") as f:
        assert json.load(f)["traceEvents"]


def test_point_cloud_visualizer_saves_a_figure(tmp_path):
    pytest.importorskip("matplotlib")
    from deepclr_tpu_torch.utils.pcv import PointCloudVisualizer

    viz = PointCloudVisualizer()
    rng = np.random.default_rng(0)
    viz.add_cloud("a", rng.normal(size=(50, 3)), color=(1, 0, 0))
    viz.update_point_cloud("b", rng.normal(size=(70, 4)), color=rng.uniform(size=(70, 3)))
    viz.add_ground_plane(z=-1.0)
    viz.set_camera_params(position=(10.0, 0.0, 5.0))
    out = tmp_path / "clouds.png"
    viz.save(str(out))
    viz.close()
    assert out.exists() and out.stat().st_size > 1000
