"""The port's data modules against the JAX package's on the same seeded
inputs: the `.pack` format byte for byte (each package reads the other's
files), the pair-sample dataflows and their shuffled orders, the host label
math and the host Morton argsort."""
import numpy as np
import pytest

pytest.importorskip("torch")

from deepclr_tpu.data import datasets as jax_datasets  # noqa: E402
from deepclr_tpu.data.pack import PackReader as JaxPackReader, PackWriter as JaxPackWriter  # noqa: E402
from deepclr_tpu.data.pack import decode_obj as jax_decode_obj, encode_obj as jax_encode_obj  # noqa: E402
from deepclr_tpu.data.types import DatasetType as JaxDatasetType  # noqa: E402
from deepclr_tpu.geometry import LabelType as JaxLabelType  # noqa: E402
from deepclr_tpu.geometry import hostmath as jax_hostmath  # noqa: E402
from deepclr_tpu.ops.morton import morton_argsort_np as jax_morton_argsort_np  # noqa: E402
from deepclr_tpu_torch.data import DatasetType, build_dataset, create_input_dataflow  # noqa: E402
from deepclr_tpu_torch.data.pack import PackReader, PackWriter, decode_obj, encode_obj  # noqa: E402
from deepclr_tpu_torch.geometry import LabelType, hostmath  # noqa: E402
from deepclr_tpu_torch.ops import morton_argsort_np  # noqa: E402


def _records(seed=0):
    """Every value type the codec knows, in one record list."""
    rng = np.random.default_rng(seed)
    return [
        ("b", {"cloud": rng.normal(size=(7, 4)).astype(np.float32), "pose": rng.normal(size=(4, 4)),
               "idx": 3, "timestamp": 1.5e5, "name": "seq", "ok": True, "flag": np.bool_(False),
               "n32": np.int32(-4), "f32": np.float32(0.25)}),
        ("a", {"codes": rng.integers(0, 65535, size=(5, 3)).astype(np.uint16), "mask": rng.random(6) > 0.5,
               "scalar": np.array(2.5), "empty": np.zeros((0, 3), np.float32), "i64": np.arange(4)}),
        ("c", [1, 2.0, "x", None, b"\x00\xff", (3, 4), [np.float64(1.0)], {"nested": {"deep": [None]}}]),
    ]


def _assert_equal(a, b):
    assert type(a) is type(b), (type(a), type(b))
    if isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    elif isinstance(a, dict):
        assert list(a) == list(b)
        for k in a:
            _assert_equal(a[k], b[k])
    elif isinstance(a, list):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _assert_equal(x, y)
    else:
        assert a == b


def test_codec_encodes_the_same_bytes():
    for _, obj in _records():
        data = encode_obj(obj)
        assert data == jax_encode_obj(obj)
        got, end = decode_obj(data)
        ref, ref_end = jax_decode_obj(data)
        assert end == ref_end == len(data)
        _assert_equal(got, ref)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_packs_are_byte_identical_and_cross_readable(tmp_path, writer):
    paths = {}
    for name, cls in (("port", PackWriter), ("jax", JaxPackWriter)):
        paths[name] = tmp_path / f"{name}.pack"
        with cls(str(paths[name])) as w:
            for key, obj in _records():
                w.put(key, obj)
            assert len(w) == 3
    assert paths["port"].read_bytes() == paths["jax"].read_bytes()
    readers = (PackReader, JaxPackReader)
    with readers[0](str(paths[writer])) as r0, readers[1](str(paths[writer])) as r1:
        assert r0.keys == r1.keys == ["a", "b", "c"] and len(r0) == 3 and "b" in r0
        for (k0, v0), (k1, v1) in zip(r0.items(), r1.items()):
            assert k0 == k1
            _assert_equal(v0, v1)


def test_reader_rejects_a_file_that_is_not_a_pack(tmp_path):
    bad = tmp_path / "bad.pack"
    bad.write_bytes(b"NOTAPACK" + b"\x00" * 32)
    with pytest.raises(ValueError, match="Not a pack file"):
        PackReader(str(bad))


def _sequence_pack(path, n_frames, seed):
    rng = np.random.default_rng(seed)
    with PackWriter(str(path)) as w:
        for i in range(n_frames):
            pose = np.eye(4)
            pose[:3, 3] = rng.normal(size=3)
            w.put(f"{i:06d}", {"idx": i, "timestamp": i * 1e5, "pose": pose,
                               "cloud": rng.normal(size=(20 + i, 4))})


def _pair_pack(path, n, seed):
    rng = np.random.default_rng(seed)
    with PackWriter(str(path)) as w:
        for i in range(n):
            w.put(f"{i:06d}", {"idx": [i, i], "timestamps": [float(i), float(i) + 0.1],
                               "clouds": [rng.normal(size=(12, 3)), rng.normal(size=(13, 3))],
                               "transform": np.eye(4) + 0.01 * rng.normal(size=(4, 4))})


def _model_pack(path, n, seed):
    rng = np.random.default_rng(seed)
    with PackWriter(str(path)) as w:
        for i in range(n):
            w.put(f"{i:06d}", {"idx": i, "cloud": rng.normal(size=(9, 3))})


_MAKERS = {"generic": _pair_pack, "kitti_odometry_velodyne": _sequence_pack, "modelnet40": _model_pack}


@pytest.mark.parametrize("shuffle", [False, True])
@pytest.mark.parametrize("kind", list(_MAKERS))
def test_dataflows_yield_equal_samples(tmp_path, kind, shuffle):
    path = tmp_path / "data.pack"
    _MAKERS[kind](path, 6, seed=3)
    got = create_input_dataflow(DatasetType(kind), str(path), shuffle=shuffle, seed=4)
    ref = jax_datasets.create_input_dataflow(JaxDatasetType(kind), str(path), shuffle=shuffle, seed=4)
    assert len(got) == len(ref) == (5 if kind == "kitti_odometry_velodyne" else 6)
    for epoch in range(2):  # a shuffled flow draws a new order each epoch
        samples = list(got)
        refs = list(ref)
        assert len(samples) == len(refs) == len(got)
        for s, r in zip(samples, refs):
            _assert_equal(s, r)
            assert s["clouds"][0].dtype == np.float32 and s["transform"].dtype == np.float32


@pytest.mark.parametrize("shuffle", [False, True])
def test_build_dataset_with_a_list_gives_the_same_order(tmp_path, shuffle):
    files = []
    for i, n in enumerate((4, 6, 3)):
        files.append(str(tmp_path / f"{i}.pack"))
        _sequence_pack(files[-1], n, seed=10 + i)
    kind = "kitti_odometry_velodyne"
    got = build_dataset(DatasetType(kind), files, shuffle=shuffle, seed=2)
    ref = jax_datasets.build_dataset(JaxDatasetType(kind), files, shuffle=shuffle, seed=2)
    assert len(got) == len(ref) == 10
    order = [(s["dataset"], s["idx"]) for s in got]
    assert order == [(s["dataset"], s["idx"]) for s in ref]
    assert shuffle or order == sorted(order)
    single = build_dataset(DatasetType(kind), files[0], shuffle=shuffle, seed=2)
    assert [s["idx"] for s in single] == [s["idx"] for s in jax_datasets.build_dataset(
        JaxDatasetType(kind), files[0], shuffle=shuffle, seed=2)]


def test_unknown_dataset_type_raises(tmp_path):
    with pytest.raises(NotImplementedError):
        create_input_dataflow("generic", str(tmp_path / "x.pack"))


def _transforms(seed, n=32):
    from scipy.spatial.transform import Rotation

    rng = np.random.default_rng(seed)
    m = np.tile(np.eye(4), (n, 1, 1))
    m[:, :3, :3] = Rotation.random(n, random_state=seed).as_matrix()
    m[:3, :3, :3] = np.eye(3)  # the identity, and near-degenerate quaternion branches
    m[1, :3, :3] = np.diag([1.0, -1.0, -1.0])
    m[2, :3, :3] = np.diag([-1.0, 1.0, -1.0])
    m[:, :3, 3] = rng.normal(size=(n, 3)) * 5
    return m


@pytest.mark.parametrize("label_type", [lt.name for lt in LabelType])
def test_hostmath_round_trips_every_label_type_as_jax(label_type):
    lt, jlt = LabelType[label_type], JaxLabelType[label_type]
    m = _transforms(1)
    label = hostmath.label_from_matrix_np(lt, m)
    np.testing.assert_array_equal(label, jax_hostmath.label_from_matrix_np(jlt, m))
    back = hostmath.label_to_matrix_np(lt, label)
    np.testing.assert_array_equal(back, jax_hostmath.label_to_matrix_np(jlt, label))
    np.testing.assert_allclose(back, m, atol=1e-9)
    # unnormalised labels, as a network predicts them
    noisy = label + np.random.default_rng(2).normal(size=label.shape) * 0.05
    np.testing.assert_array_equal(hostmath.label_to_matrix_np(lt, noisy),
                                  jax_hostmath.label_to_matrix_np(jlt, noisy))


def test_hostmath_quaternion_helpers_equal_jax():
    rng = np.random.default_rng(3)
    q1, q2 = rng.normal(size=(2, 16, 4))
    np.testing.assert_array_equal(hostmath.qmult_np(q1, q2), jax_hostmath.qmult_np(q1, q2))
    np.testing.assert_array_equal(hostmath.qconjugate_np(q1), jax_hostmath.qconjugate_np(q1))
    np.testing.assert_array_equal(hostmath.quat_to_matrix_np(q1), jax_hostmath.quat_to_matrix_np(q1))
    r = _transforms(4)[:, :3, :3]
    np.testing.assert_array_equal(hostmath.matrix_to_quat_np(r), jax_hostmath.matrix_to_quat_np(r))


@pytest.mark.parametrize("case", ["normal", "grid_ties", "flat", "single"])
def test_morton_argsort_np_equals_jax(case):
    rng = np.random.default_rng(5)
    pts = {"normal": rng.normal(size=(2048, 4)) * [30, 30, 2, 1],
           "grid_ties": np.round(rng.normal(size=(2048, 3)) * 3),
           "flat": np.concatenate([rng.normal(size=(500, 2)), np.zeros((500, 1))], 1),
           "single": np.ones((1, 3))}[case].astype(np.float32)
    got = morton_argsort_np(pts)
    np.testing.assert_array_equal(got, jax_morton_argsort_np(pts))
    assert sorted(got.tolist()) == list(range(len(pts)))
