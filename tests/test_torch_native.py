"""The port's host libraries (deepclr_tpu_torch/native, built from its own
copies in csrc/host) against the Python paths and the JAX package's builds:
the pack reader, the Morton row sort and pad_points with it, and where the
builds land."""
import subprocess
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("torch")

from deepclr_tpu_torch import native  # noqa: E402
from deepclr_tpu_torch.data.pack import PackReader, PackWriter  # noqa: E402
from deepclr_tpu_torch.native.morton_sort import morton_sort_rows_native  # noqa: E402
from deepclr_tpu_torch.native.pack_reader import NativePackReader  # noqa: E402
from deepclr_tpu_torch.ops.morton import morton_argsort_np  # noqa: E402

REPO = Path(__file__).resolve().parents[1]


def test_pack_reader_matches_the_python_reader(tmp_path):
    path = str(tmp_path / "t.pack")
    rng = np.random.default_rng(0)
    with PackWriter(path) as w:
        for i in range(5):
            w.put(f"{i:08d}", {"idx": i, "cloud": rng.normal(size=(50 + i, 4)).astype(np.float32),
                               "pose": np.eye(4), "name": f"rec{i}", "stamps": [i * 1e5, (i + 1) * 1e5]})
    with NativePackReader(path) as got, PackReader(path) as want:
        assert got.keys == want.keys == [f"{i:08d}" for i in range(5)]
        assert len(got) == 5 and "00000003" in got and "missing" not in got
        for key in want.keys:
            a, b = got[key], want[key]
            assert sorted(a) == sorted(b)
            for name in b:
                np.testing.assert_array_equal(a[name], b[name], err_msg=name)
                assert type(a[name]) is type(b[name])
        with pytest.raises(KeyError):
            got["missing"]
    with pytest.raises(ValueError, match="Not a pack file"):
        NativePackReader(str(tmp_path / "none.pack"))


def _clouds():
    rng = np.random.default_rng(3)
    return [
        (rng.normal(size=(4096, 4)) * 30).astype(np.float32),
        # repeated points: tied keys, where the sort's stability decides
        np.repeat((rng.normal(size=(256, 4)) * 5).astype(np.float32), 8, axis=0),
        # a flat axis (LiDAR-like z) and extra feature columns
        np.concatenate([rng.normal(size=(1000, 2)) * 50, np.zeros((1000, 1)), rng.random((1000, 2))],
                       axis=1).astype(np.float32),
        rng.normal(size=(1, 3)).astype(np.float32),
    ]


@pytest.mark.parametrize("case", range(4))
def test_morton_sort_is_bit_identical_to_numpy_and_to_the_jax_build(case):
    from deepclr_tpu.native.morton_sort import morton_sort_rows_native as jax_native_sort
    from deepclr_tpu.native.morton_sort import native_morton_available

    cloud = _clouds()[case]
    got = morton_sort_rows_native(cloud)
    np.testing.assert_array_equal(got, cloud[morton_argsort_np(cloud)])
    assert native_morton_available()
    np.testing.assert_array_equal(got, jax_native_sort(cloud))


def test_pad_points_morton_is_the_same_with_and_without_the_native_sort(monkeypatch):
    """pad_points(morton=True) sorts through the library, and through numpy
    under DEEPCLR_NATIVE_PAD=0, with the same batch (subsampled and padded)."""
    from deepclr_tpu_torch.data import batching

    rng = np.random.default_rng(7)
    calls = []
    monkeypatch.setattr(batching, "morton_sort_rows_native",
                        lambda c: calls.append(1) or morton_sort_rows_native(c))
    for n in (900, 1500):
        cloud = (rng.normal(size=(n, 4)) * 20).astype(np.float32)
        monkeypatch.delenv("DEEPCLR_NATIVE_PAD", raising=False)
        native_out = batching.pad_points(cloud.copy(), 1024, np.random.default_rng(0), morton=True)
        monkeypatch.setenv("DEEPCLR_NATIVE_PAD", "0")
        numpy_out = batching.pad_points(cloud.copy(), 1024, np.random.default_rng(0), morton=True)
        for a, b in zip(native_out, numpy_out):
            np.testing.assert_array_equal(a, b)
    assert len(calls) == 2


def test_builds_land_in_the_ports_build_directory(tmp_path, monkeypatch):
    """Each library builds from csrc/host into _build/ under a name that
    carries its source's hash; nothing reads or writes under native/."""
    for name in ("kitti_devkit", "pack_reader", "morton_sort"):
        path = Path(native.build_library(name))
        assert path.parent == REPO / "deepclr_tpu_torch" / "_build" and path.exists()
        assert path.name.startswith(f"lib{name}_") and len(path.stem) == len(f"lib{name}_") + 12
    commands = []
    run = subprocess.run
    monkeypatch.setattr(native, "_BUILD", tmp_path / "_build")
    monkeypatch.setattr(native.subprocess, "run", lambda cmd, **kw: commands.append(cmd) or run(cmd, **kw))
    built = Path(native.build_library("morton_sort"))
    assert built.parent == tmp_path / "_build" and built.exists()
    assert native.build_library("morton_sort") == str(built) and len(commands) == 1  # cached
    (cmd,) = commands
    assert cmd[:5] == ["g++", "-O3", "-std=c++17", "-shared", "-fPIC"]
    assert cmd[5] == str(REPO / "deepclr_tpu_torch" / "csrc" / "host" / "morton_sort.cpp")
    assert not any(arg.startswith(str(REPO / "native")) for arg in cmd)
    assert not list((tmp_path / "_build").glob("*.tmp"))


def test_copies_differ_from_the_jax_sources_only_in_comments():
    """The port keeps its own copies; their code is the JAX build's."""
    def code(path):
        return [ln for ln in path.read_text().splitlines() if not ln.lstrip().startswith("//")]

    for name in ("kitti_devkit", "pack_reader", "morton_sort"):
        assert code(REPO / "deepclr_tpu_torch" / "csrc" / "host" / f"{name}.cpp") == \
            code(REPO / "native" / f"{name}.cpp"), name


def test_a_failed_build_raises(tmp_path, monkeypatch):
    src = tmp_path / "csrc"
    src.mkdir()
    (src / "broken.cpp").write_text("this is not C++\n")
    monkeypatch.setattr(native, "_SRC", src)
    monkeypatch.setattr(native, "_BUILD", tmp_path / "_build")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed for broken.cpp"):
        native.build_library("broken")
