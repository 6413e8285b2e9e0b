"""The port's evaluation modules against the JAX package's on the same
seeded trajectories: the 26-column sequence files byte for byte, the step
and KITTI segment errors (to 1e-12, float64), the readers, and the plots."""
import os

import numpy as np
import pytest

pytest.importorskip("torch")

from deepclr_tpu.evaluation import Evaluator as JaxEvaluator  # noqa: E402
from deepclr_tpu.evaluation import metrics as jax_metrics  # noqa: E402
from deepclr_tpu_torch.evaluation import SEGMENT_LENGTHS, STEP_SIZE, Evaluator, metrics  # noqa: E402

N_FRAMES = 1100  # ~1.1 km at ~1 m a frame: every segment length up to 800 m occurs


def _rot(yaw, pitch, roll):
    from scipy.spatial.transform import Rotation

    return Rotation.from_euler("zyx", [yaw, pitch, roll]).as_matrix()


def _trajectory(seed, n=N_FRAMES, noise=0.0):
    """Relative motions of a car: ~1 m forward a frame, small turns; with
    ``noise`` the prediction's error on top."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        m = np.eye(4)
        m[:3, :3] = _rot(*(rng.normal(size=3) * [0.02, 0.002, 0.002] + rng.normal(size=3) * noise))
        m[:3, 3] = [1.0 + 0.1 * rng.normal(), 0.02 * rng.normal(), 0.005 * rng.normal()]
        m[:3, 3] += rng.normal(size=3) * noise
        out.append(m)
    return out


def _fill(ev, names=("00", "01"), n=N_FRAMES):
    for k, name in enumerate(names):
        gt = _trajectory(10 + k, n)
        pred = [g @ d for g, d in zip(gt, _trajectory(20 + k, n, noise=0.01))]
        times = np.random.default_rng(30 + k).uniform(1, 5, size=n)
        for i in range(n):
            ev.add_transforms(name, i * 1e5, pred[i], gt[i], times[i])
    return ev


@pytest.fixture(scope="module")
def evaluators():
    return _fill(Evaluator()), _fill(JaxEvaluator())


def test_protocol_constants_equal_jax():
    from deepclr_tpu.evaluation import SEGMENT_LENGTHS as J_LENGTHS, STEP_SIZE as J_STEP

    assert (STEP_SIZE, SEGMENT_LENGTHS) == (J_STEP, J_LENGTHS) == (10, [100, 200, 300, 400, 500, 600, 700, 800])


def test_write_is_byte_identical(evaluators, tmp_path):
    ev, jev = evaluators
    ev.write(str(tmp_path / "port"))
    jev.write(str(tmp_path / "jax"))
    for name in ("00", "01"):
        got = (tmp_path / "port" / f"{name}.txt").read_bytes()
        assert got == (tmp_path / "jax" / f"{name}.txt").read_bytes()
        assert np.loadtxt(tmp_path / "port" / f"{name}.txt").shape == (N_FRAMES, 26)


def _flat(container):
    out = []
    for x in container:
        out += [x.translation.kitti, x.translation.rmse, *x.translation.vec, x.rotation.kitti, x.rotation.rmse,
                x.rotation.chordal, *x.rotation.vec]
        out += [x.time] if hasattr(x, "time") else [x.first_frame, x.segment_length, x.speed]
    return np.array(out, float)


def _stats(container):
    return np.array([[getattr(s, a).kitti, getattr(s, a).rmse] for s in
                     (container.min, container.max, container.mean, container.median, container.std)
                     for a in ("translation", "rotation")], float)


@pytest.mark.parametrize("kind", ["step", "segment"])
def test_errors_equal_jax(evaluators, kind):
    ev, jev = evaluators
    per, jper = getattr(ev, f"get_{kind}_errors")(), getattr(jev, f"get_{kind}_errors")()
    assert list(per) == list(jper) == ["00", "01"]
    for name in per:
        got, ref = _flat(per[name]), _flat(jper[name])
        assert got.shape == ref.shape and got.size > 0
        np.testing.assert_allclose(got, ref, atol=1e-12, rtol=0)
        np.testing.assert_allclose(_stats(per[name]), _stats(jper[name]), atol=1e-12, rtol=0)
    total, jtotal = getattr(ev, f"get_total_{kind}_errors")(), getattr(jev, f"get_total_{kind}_errors")()
    np.testing.assert_allclose(_stats(total), _stats(jtotal), atol=1e-12, rtol=0)
    if kind == "segment":
        assert {x.segment_length for x in total} == set(SEGMENT_LENGTHS)
    else:
        assert len(total) == 2 * N_FRAMES and np.isfinite(_flat(total)).all()


def test_metric_functions_equal_jax():
    rng = np.random.default_rng(4)
    for _ in range(20):
        a, b = np.eye(4), np.eye(4)
        a[:3, :3], b[:3, :3] = _rot(*rng.normal(size=3)), _rot(*rng.normal(size=3))
        a[:3, 3], b[:3, 3] = rng.normal(size=3), rng.normal(size=3)
        for fn in ("translation_error_rmse", "rotation_error_rmse", "rotation_error_chordal"):
            assert getattr(metrics, fn)(a, b) == getattr(jax_metrics, fn)(a, b)
        for fn in ("translation_error_kitti", "rotation_error_kitti"):
            (e, v), (je, jv) = getattr(metrics, fn)(a, b), getattr(jax_metrics, fn)(a, b)
            assert e == je
            np.testing.assert_array_equal(v, jv)


def test_empty_container_is_nan():
    c = metrics.MetricsContainer([])
    assert len(c) == 0 and np.isnan(c.mean.translation.kitti) and np.isnan(c.std.time)


def test_read_round_trips(evaluators, tmp_path):
    ev, _ = evaluators
    ev.write(str(tmp_path))
    back = Evaluator.read(str(tmp_path))
    assert list(back.get_sequences()) == ["00", "01"]
    sub = Evaluator.read(str(tmp_path), ["01.txt"])
    assert list(sub.get_sequences()) == ["01"]
    for name, seq in back.get_sequences().items():
        orig = ev.get_sequence(name)
        assert len(seq) == len(orig) == N_FRAMES
        np.testing.assert_array_equal(seq.stamps, orig.stamps)
        np.testing.assert_array_equal(seq.times, orig.times)
        np.testing.assert_array_equal(np.array(seq.prediction.transforms), np.array(orig.prediction.transforms))
        np.testing.assert_array_equal(np.array(seq.ground_truth.poses), np.array(orig.ground_truth.poses))
    np.testing.assert_array_equal(_flat(back.get_total_segment_errors()), _flat(ev.get_total_segment_errors()))


@pytest.mark.parametrize("has_poses", [True, False])
def test_read_separate_round_trips(evaluators, tmp_path, has_poses):
    """KITTI-style 12-column files; prediction and ground truth in two
    folders, as poses or as relative transforms, read as the JAX reader
    reads them."""
    from deepclr_tpu.evaluation import Evaluator as JaxEv

    ev, _ = evaluators
    seq = ev.get_sequence("00")
    for where, motion in (("pred", seq.prediction), ("gt", seq.ground_truth)):
        os.makedirs(tmp_path / where, exist_ok=True)
        motion.write(str(tmp_path / where / "00.txt"), use_poses=not has_poses)
    got = Evaluator.read_separate(str(tmp_path / "pred"), str(tmp_path / "gt"), has_poses)
    ref = JaxEv.read_separate(str(tmp_path / "pred"), str(tmp_path / "gt"), has_poses)
    s, r = got.get_sequence("00"), ref.get_sequence("00")
    n = N_FRAMES  # a pose file holds the start pose too: N + 1 poses, N transforms
    assert len(s.prediction.transforms) == len(r.prediction.transforms) == n
    np.testing.assert_array_equal(np.array(s.prediction.poses), np.array(r.prediction.poses))
    np.testing.assert_allclose(np.array(s.ground_truth.poses), np.array(seq.ground_truth.poses), atol=1e-9)
    assert s.stamps == list(map(float, range(n))) and s.times == [0.0] * n
    np.testing.assert_array_equal(_flat(got.get_total_step_errors()), _flat(ref.get_total_step_errors()))
    os.remove(tmp_path / "gt" / "00.txt")
    with pytest.raises(RuntimeError, match="ground truth"):
        Evaluator.read_separate(str(tmp_path / "pred"), str(tmp_path / "gt"), has_poses)


def test_scoring_needs_no_matplotlib():
    import subprocess
    import sys

    code = ("import sys\n"
            "class Block:\n"
            "    def find_spec(self, name, path=None, target=None):\n"
            "        if name.split('.')[0] in ('matplotlib', 'yaml'):\n"
            "            raise ImportError(name)\n"
            "sys.meta_path.insert(0, Block())\n"
            "import numpy as np\n"
            "from deepclr_tpu_torch.evaluation import Evaluator\n"
            "ev = Evaluator()\n"
            "for i in range(30):\n"
            "    ev.add_transforms('a', i, np.eye(4), np.eye(4), 1.0)\n"
            "assert len(ev.get_total_step_errors()) == 30\n"
            "try:\n"
            "    ev.plot_sequences()\n"
            "except ImportError:\n"
            "    print('plots need matplotlib')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120,
                         cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "plots need matplotlib"


def test_plots_render():
    pytest.importorskip("matplotlib")
    import matplotlib.pyplot as plt

    short = _fill(Evaluator(), n=900)
    figs = [*short.plot_error_over_time().values(), *short.plot_kitti_errors().values(),
            short.plot_total_kitti_errors(), short.plot_segment_error_bars(),
            *short.plot_sequences().values(), *short.plot_sequences_2d().values()]
    assert len(figs) == 2 + 2 + 1 + 1 + 2 + 2
    for fig in figs:
        fig.canvas.draw()
        plt.close(fig)
