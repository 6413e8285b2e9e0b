"""Scenario inference of the PyTorch port against the JAX package on the CPU:
the host padding, Morton sort and uint16 quantisation, the two inference
helpers (pairwise, batched pairwise, sequential, batched sequential, uint16
uploads, presorted models) under the same weights (through the port's
weight bridge), and ``python -m deepclr_tpu_torch.inference`` against
``scripts/inference.py`` on one workspace, scored by ``scripts/evaluation.py``.

The model is the narrow DeepCLR of ``tests/model/test_upload_quant.py``
(npoint 32, k 4) on clouds of 200-300 points padded or subsampled to 256.

Tolerances: float32 1e-4 on the pose labels (|y| <~ 1), as in
``test_torch_model.py``: the JAX CPU path computes ball distances in the
expanded form and sums matmuls in another order.  bfloat16 2e-2: the JAX CPU
set abstraction accumulates its bf16 tail in bf16 where the port accumulates
in float32, and the bf16 roundings of the merge and head MLPs compound.
The written transforms (columns 1-24) are held to 1e-4 of each column's
scale; the port against itself (batched lanes against single helpers) to
1e-5, the float32 summation-order difference of batched matmuls.
"""
import copy
import os
import os.path as osp
import subprocess
import sys

import numpy as np
import pytest
import yaml

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from deepclr_tpu.data.pack import PackWriter as JaxPackWriter  # noqa: E402
from deepclr_tpu.models import BatchedSequentialHelper as JaxBatched  # noqa: E402
from deepclr_tpu.models import ModelInferenceHelper as JaxHelper  # noqa: E402
from deepclr_tpu.models import build_model as jax_build_model, init_params as jax_init_params  # noqa: E402
from deepclr_tpu.models import save_weights as jax_save_weights  # noqa: E402
from deepclr_tpu.models.base import _quantize_u16 as jax_quantize_u16, pad_cloud as jax_pad_cloud  # noqa: E402
from deepclr_tpu_torch.models import (BatchedSequentialHelper, ModelInferenceHelper, build_model,  # noqa: E402
                                      load_jax_params, save_weights)
from deepclr_tpu_torch.models.base import (UPLOAD_DTYPES, _fit_dim, _quantize_u16, _SequentialGraph,  # noqa: E402
                                           device_batch, host_batch, host_layout, pad_cloud)

REPO = osp.realpath(osp.join(osp.dirname(__file__), ".."))
N = 256
_TOL = {"float32": 1e-4, "bfloat16": 2e-2}

MODEL_CFG = {
    "input_dim": 4,
    "point_dim": 3,
    "label_type": "pose3d_dual_quat",
    "model_type": "deepclr",
    "params": {
        "batch_norm": False,
        "dropout": 1.0,
        "cloud_features": {
            "name": "SetAbstraction",
            "params": {"npoint": [32], "radii": [[1.0, 2.0]], "nsamples": [[8, 16]],
                       "mlps": [[[8, 8, 16], [8, 8, 16]]]},
        },
        "merge": {"name": "MotionEmbedding", "params": {"k": 4, "radius": 10.0, "mlp": [16, 32]}},
        "output": {"name": "OutputSimple", "params": {"mlp": [32, 64], "linear": [64, 32]}},
    },
}


def _cfg(compute_dtype="float32", presorted=False):
    cfg = copy.deepcopy(MODEL_CFG)
    cfg["params"].update(compute_dtype=compute_dtype, presorted=presorted)
    return cfg


def _cloud(seed, n, scale=20.0):
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-scale, scale, size=(n, 3)).astype(np.float32)
    return np.concatenate([pts, rng.uniform(0, 1, size=(n, 1)).astype(np.float32)], 1)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _models(cfg):
    jmodel = jax_build_model(cfg)
    variables = jax_init_params(jmodel, jax.random.PRNGKey(0), num_points=N)
    model = build_model(cfg, device="cpu", seed=1)
    model.load_state_dict(load_jax_params(_np_tree(variables)))
    return jmodel, variables, model


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def pair(request):
    return (request.param, *_models(_cfg(request.param)))


# clouds above (subsampled) and below (padded) num_points
SIZES = (300, 200, 256, 280)


def _clouds(offset=0):
    return [_cloud(100 + offset + i, n) for i, n in enumerate(SIZES)]


# --- host-side helpers, exact -------------------------------------------------------------------

@pytest.mark.parametrize("n", [200, 256, 300])
@pytest.mark.parametrize("morton", [False, True])
def test_pad_cloud_equals_jax(n, morton):
    cloud = _cloud(n, n)
    got = pad_cloud(cloud, N, np.random.default_rng(3), morton=morton)
    ref = jax_pad_cloud(cloud, N, np.random.default_rng(3), morton=morton)
    for g, r in zip(got, ref):
        assert g.dtype == r.dtype
        np.testing.assert_array_equal(g, r)


_INPUTS = {"float32": lambda c: c, "float64": lambda c: c.astype(np.float64) * (1 + 1e-9),
           "five_columns": lambda c: np.concatenate([c, c[:, :1] * 2], 1)}


@pytest.mark.parametrize("n", [200, 256, 300])
@pytest.mark.parametrize("morton", [False, True])
@pytest.mark.parametrize("kind", sorted(_INPUTS))
def test_pad_cloud_into_buffers_equals_jax(n, morton, kind):
    """``pad_cloud(..., out=...)`` fills and returns the given arrays,
    bit-equal to new arrays and to the JAX package on the same draws,
    whatever a 300-point subsample left in them before; a float64 input
    is cast as ``astype`` casts it, a wider one cut by ``_fit_dim``."""
    cloud = _fit_dim(_INPUTS[kind](_cloud(n, n)), 4, "cloud")
    out = np.empty((N, 4), np.float32), np.empty(N, bool)
    pad_cloud(_cloud(1, 300), N, np.random.default_rng(2), out=out)   # every row stale
    got = pad_cloud(cloud, N, np.random.default_rng(3), morton=morton, out=out)
    assert got[0] is out[0] and got[1] is out[1]
    new = pad_cloud(cloud, N, np.random.default_rng(3), morton=morton)
    ref = jax_pad_cloud(cloud, N, np.random.default_rng(3), morton=morton)
    for g, a, r in zip(got, new, ref):
        assert g.dtype == a.dtype == r.dtype
        np.testing.assert_array_equal(g, a)
        np.testing.assert_array_equal(g, r)
    valid = min(n, N)
    assert got[1][:valid].all() and not got[1][valid:].any()
    assert not got[0][valid:].any()


@pytest.mark.parametrize("scale", [1.0, 100.0])
def test_quantize_u16_equals_jax(scale):
    pts, _ = pad_cloud(_cloud(7, 200, scale), N)
    for g, r in zip(_quantize_u16(pts), jax_quantize_u16(pts)):
        assert g.dtype == r.dtype
        np.testing.assert_array_equal(g, r)


def test_int16_bits_upload_equals_uint16():
    """The codes travel as int16 bits and are widened on the device; the
    dequantised points equal the uint16 codes' float32 dequantisation."""
    padded = [pad_cloud(_cloud(8 + i, 300, 100.0), N, np.random.default_rng(i)) for i in range(2)]
    host = host_batch(padded, "uint16")
    assert host[0].dtype == np.int16 and host[0].shape == (2, N, 4)
    pts, mask = device_batch(host, torch.device("cpu"))
    q = np.stack([_quantize_u16(p)[0] for p, _ in padded])
    assert q.max() > 32767  # codes above the int16 range take the sign bit
    lo, scale = host[1], host[2]
    ref = q.astype(np.float32) * scale[:, None, :] + lo[:, None, :]
    assert pts.dtype == torch.float32
    np.testing.assert_array_equal(pts.numpy(), ref)
    np.testing.assert_array_equal(mask.numpy(), np.stack([m for _, m in padded]))
    np.testing.assert_array_equal(host_batch(padded, "float32")[0], np.stack([p for p, _ in padded]))


def test_bad_upload_dtype_raises():
    model = build_model(_cfg(), device="cpu")
    for make in (lambda: ModelInferenceHelper(model, upload_dtype="int8"),
                 lambda: BatchedSequentialHelper(model, batch=2, upload_dtype="float16")):
        with pytest.raises(ValueError, match="upload_dtype"):
            make()


# --- the helpers against the JAX helpers under the same weights ---------------------------------

@pytest.mark.parametrize("upload_dtype", ["float32", "uint16"])
def test_pairwise_helpers_match_jax(pair, upload_dtype):
    """predict and predict_batch, templates drawn first in both packages."""
    dtype, jmodel, variables, model = pair
    clouds = _clouds()
    jh = JaxHelper(jmodel, variables, num_points=N, upload_dtype=upload_dtype)
    h = ModelInferenceHelper(model, num_points=N, upload_dtype=upload_dtype)
    np.testing.assert_allclose(h.predict(clouds[0], clouds[1]), jh.predict(clouds[0], clouds[1]),
                               atol=_TOL[dtype], rtol=0)
    got = h.predict_batch(clouds[:2], clouds[2:])
    assert got.shape == (2, 8)
    np.testing.assert_allclose(got, jh.predict_batch(clouds[:2], clouds[2:]), atol=_TOL[dtype], rtol=0)


@pytest.mark.parametrize("upload_dtype", ["float32", "uint16"])
def test_batched_sequential_matches_jax(pair, upload_dtype):
    """Two lanes over three frames, a lane restarted midway."""
    dtype, jmodel, variables, model = pair
    frames = [_clouds(10 * t)[:2] for t in range(4)]
    jh = JaxBatched(jmodel, variables, batch=2, num_points=N, seed=5, upload_dtype=upload_dtype)
    h = BatchedSequentialHelper(model, batch=2, num_points=N, seed=5, upload_dtype=upload_dtype)
    for t, fr in enumerate(frames):
        if t == 2:
            jh.reset_stream(1)
            h.reset_stream(1)
        got, ref = h.step(fr), jh.step(fr)
        fresh = [True, True] if t == 0 else [False, True] if t == 2 else [False, False]
        assert [g is None for g in got] == [r is None for r in ref] == fresh
        for g, r in zip(got, ref):
            if r is not None:
                np.testing.assert_allclose(g, r, atol=_TOL[dtype], rtol=0)


def test_sequential_helper_matches_jax(pair):
    dtype, jmodel, variables, model = pair
    jseq = JaxHelper(jmodel, variables, is_sequential=True, num_points=N, upload_dtype="uint16")
    seq = ModelInferenceHelper(model, is_sequential=True, num_points=N, upload_dtype="uint16")
    clouds = _clouds()
    assert seq.predict(clouds[0]) is None and jseq.predict(clouds[0]) is None
    for c in clouds[1:]:
        np.testing.assert_allclose(seq.predict(c), jseq.predict(c), atol=_TOL[dtype], rtol=0)


def test_uint16_upload_within_2e2_of_float32(pair):
    _, _, _, model = pair
    clouds = [_cloud(40 + i, 300, 100.0) for i in range(4)]
    y32 = ModelInferenceHelper(model, num_points=N).predict_batch(clouds[:2], clouds[2:])
    y16 = ModelInferenceHelper(model, num_points=N, upload_dtype="uint16").predict_batch(clouds[:2], clouds[2:])
    np.testing.assert_allclose(y16, y32, atol=2e-2, rtol=0)


def test_batched_sequential_equals_per_lane_helpers():
    """Lane i of the batched helper is a single helper seeded seed + i."""
    model = build_model(_cfg(), device="cpu", seed=2)
    lanes = [ModelInferenceHelper(model, is_sequential=True, num_points=N, seed=7 + i) for i in range(2)]
    batched = BatchedSequentialHelper(model, batch=2, num_points=N, seed=7)
    for t in range(4):
        fr = _clouds(20 * t)[1:3]
        got = batched.step(fr)
        for i, lane in enumerate(lanes):
            ref = lane.predict(fr[i])
            if t == 0:
                assert got[i] is None and ref is None
            else:
                np.testing.assert_allclose(got[i], ref, atol=1e-5, rtol=0)


def _eager_sequential_poses(model, clouds, seed, upload_dtype, resets=()):
    """A sequential helper's poses computed eagerly from the same draws: one
    ``default_rng(seed)`` pads every frame, ``device_batch`` uploads it,
    ``encode`` on the first frame and after a reset, ``encode_register``
    on every other."""
    rng, state, poses = np.random.default_rng(seed), None, []
    with torch.inference_mode():
        for t, cloud in enumerate(clouds):
            if t in resets:
                state = None
            pts, mask = device_batch(host_batch([pad_cloud(cloud, N, rng)], upload_dtype), torch.device("cpu"))
            if state is None:
                state = model.encode(pts, mask)
                poses.append(None)
            else:
                y, state = model.encode_register(state, pts, mask)
                poses.append(y[0].numpy())
    return poses


@pytest.mark.parametrize("upload_dtype", UPLOAD_DTYPES)
def test_cpu_sequential_helper_runs_eagerly_and_captures_no_graph(upload_dtype):
    model = build_model(_cfg("bfloat16"), device="cpu", seed=3)
    helper = ModelInferenceHelper(model, is_sequential=True, num_points=N, seed=5, upload_dtype=upload_dtype)
    clouds = _clouds() + _clouds(10)
    got = []
    for t, cloud in enumerate(clouds):
        if t == 5:
            helper.reset_state()
        got.append(helper.predict(cloud))
    for g, r in zip(got, _eager_sequential_poses(model, clouds, 5, upload_dtype, resets=(5,))):
        assert (g is None) == (r is None)
        if r is not None:
            np.testing.assert_array_equal(g, r)
    assert helper.graph_counts() == {"captures": 0, "replays": 0, "eager": 6}


@pytest.mark.parametrize("upload_dtype", UPLOAD_DTYPES)
def test_the_graphed_step_is_the_eager_step(upload_dtype):
    """The body that a helper on the card captures (dequantise the static
    inputs, ``encode_register`` against the state buffer, copy the new
    features into it), run on CPU buffers, gives the eager poses and
    features frame after frame."""
    model = build_model(_cfg("bfloat16"), device="cpu", seed=4)
    rng = np.random.default_rng(6)
    hosts = [host_batch([pad_cloud(c, N, rng)], upload_dtype) for c in _clouds() + _clouds(10)]
    cpu = torch.device("cpu")
    with torch.inference_mode():
        state = model.encode(*device_batch(hosts[0], cpu))
        graph = _SequentialGraph(host_layout(1, N, model.input_dim, upload_dtype), state)
        assert [b.dtype for b in graph.inputs] == [torch.from_numpy(a).dtype for a in hosts[1]]
        previous = state
        for host in hosts[1:]:
            for buf, a in zip(graph.staging(), host):
                buf[...] = a
            graph.load(previous)
            y = graph._step(model)
            y_ref, state = model.encode_register(state, *device_batch(host, cpu))
            assert torch.equal(y, y_ref) and torch.equal(graph.state, state)
            previous = graph.state


@pytest.mark.parametrize("upload_dtype", UPLOAD_DTYPES)
@pytest.mark.parametrize("batch", [1, 3])
def test_host_batch_into_buffers_equals_new_arrays(upload_dtype, batch):
    """``host_batch(..., out=)`` fills ``host_layout``'s arrays with what
    it returns as new arrays, overwriting every value of an earlier batch."""
    rng = np.random.default_rng(7)
    padded = [pad_cloud(c, N, rng) for c in _clouds()[:batch]]
    host = host_batch(padded, upload_dtype)
    assert [(a.shape, a.dtype) for a in host] == host_layout(batch, N, padded[0][0].shape[1], upload_dtype)
    out = [np.empty(a.shape, a.dtype) for a in host]
    host_batch([pad_cloud(c, N, rng) for c in _clouds(10)[:batch]], upload_dtype, out=out)
    filled = host_batch(padded, upload_dtype, out=out)
    assert all(f is o for f, o in zip(filled, out))
    for f, a in zip(filled, host):
        np.testing.assert_array_equal(f, a)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_presorted_helpers_match_jax_presorted(dtype):
    """presorted=True against the JAX package's presorted=True (the host
    Morton order, never the port's device sort): pairwise on 200-300 point
    clouds, and the encode of 4096-point clouds, where the first stage would
    sort on the device and skips it."""
    jmodel, variables, model = _models(_cfg(dtype, presorted=True))
    assert model.cloud_features.presorted and model.cloud_features._sa0.presorted
    clouds = _clouds()
    ref = JaxHelper(jmodel, variables, num_points=N).predict_batch(clouds[:2], clouds[2:])
    got = ModelInferenceHelper(model, num_points=N).predict_batch(clouds[:2], clouds[2:])
    np.testing.assert_allclose(got, ref, atol=_TOL[dtype], rtol=0)

    big = [pad_cloud(_cloud(60 + i, 4096), 4096, morton=True)[0] for i in range(2)]
    big = np.stack(big)
    ref = np.asarray(jmodel.apply(variables, big, None, method="encode"))
    with torch.inference_mode():
        got = model.encode(torch.from_numpy(big)).numpy()
    np.testing.assert_array_equal(got[..., :3], ref[..., :3])  # FPS from the same host order
    np.testing.assert_allclose(got[..., 3:], ref[..., 3:], atol=_TOL[dtype] * np.abs(ref).max(), rtol=0)


# --- end to end: the CLI against scripts/inference.py ------------------------------------------

N_FRAMES = {"04": 12, "05": 8}
N_PAIRS = 7


def _write_sequence_pack(path, n_frames, seed):
    rng = np.random.default_rng(seed)
    base = rng.normal(size=(300, 4)).astype(np.float32) * 5
    with JaxPackWriter(str(path)) as w:
        for i in range(n_frames):
            pose = np.eye(4)
            pose[0, 3] = i * 1.0
            w.put(f"{i:08d}", {"idx": i, "timestamp": i * 1e5, "pose": pose,
                               "cloud": base + rng.normal(size=base.shape).astype(np.float32) * 0.01})


def _write_pair_pack(path, seed):
    rng = np.random.default_rng(seed)
    with JaxPackWriter(str(path)) as w:
        for i in range(N_PAIRS):
            t = _cloud(seed + i, int(rng.integers(200, 300)), 5.0)
            m = np.eye(4)
            m[:3, 3] = rng.normal(size=3) * 0.3
            s = t.copy()
            s[:, :3] = t[:, :3] + m[:3, 3]
            w.put(f"{i:06d}", {"idx": [i, i + 1], "timestamps": [float(i), float(i + 1)],
                               "clouds": [t, s], "transform": m})


def _scenario(ws, name, dataset_type, sequential, data):
    path = ws / f"{name}.yaml"
    with open(path, "w") as f:
        yaml.dump({"name": name, "dataset_type": dataset_type, "sequential": sequential,
                   "data": {k: str(ws / v) for k, v in data.items()}}, f)
    return str(path)


MODES = {  # mode -> (scenario, extra arguments)
    "stream": ("seq", []),
    "parallel": ("seq", ["--parallel_sequences", "2"]),
    "pairwise_batched": ("pairs", ["--parallel_sequences", "3"]),
}


def _run(cmd, env, timeout=300):
    out = subprocess.run(cmd, capture_output=True, text=True, env=env, cwd=REPO, timeout=timeout)
    assert out.returncode == 0, f"{cmd}\nSTDOUT:\n{out.stdout[-2000:]}\nSTDERR:\n{out.stderr[-3000:]}"
    return out


@pytest.fixture(scope="module")
def workspace(tmp_path_factory):
    """Packs, scenarios and a model directory holding model_config.yaml,
    the port's weights.pt and the JAX package's weights.msgpack, both from
    one JAX init; then both CLIs in every mode."""
    ws = tmp_path_factory.mktemp("torch_cli")
    for seq, n in N_FRAMES.items():
        _write_sequence_pack(ws / f"{seq}.pack", n, seed=int(seq))
    _write_pair_pack(ws / "pairs.pack", seed=11)
    scen = {"seq": _scenario(ws, "kitti_two_seq", "kitti_odometry_velodyne", True,
                             {s: f"{s}.pack" for s in N_FRAMES}),
            "pairs": _scenario(ws, "kitti_pairs", "generic", False, {"08": "pairs.pack"})}

    model_dir = ws / "models" / "toy"
    model_dir.mkdir(parents=True)
    with open(model_dir / "model_config.yaml", "w") as f:
        yaml.dump(MODEL_CFG, f)
    jmodel = jax_build_model(MODEL_CFG)
    variables = jax_init_params(jmodel, jax.random.PRNGKey(0), num_points=N)
    jax_save_weights(str(model_dir / "weights.msgpack"), variables)
    model = build_model(MODEL_CFG, device="cpu")
    model.load_state_dict(load_jax_params(_np_tree(variables)))
    save_weights(str(model_dir / "weights.pt"), model)

    env = dict(os.environ, MODEL_PATH=str(ws / "models"), JAX_PLATFORMS="cpu", JAX_PLATFORM_NAME="cpu",
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    runs = {}
    jax_argvs = []
    for mode, (sc, extra) in MODES.items():
        common = [scen[sc], "toy", None, "--num_points", str(N), *extra]
        port_out, jax_out = ws / f"port_{mode}", ws / f"jax_{mode}"
        _run([sys.executable, "-m", "deepclr_tpu_torch.inference",
              *[str(port_out) if a is None else a for a in common], "--device", "cpu"], env)
        jax_argvs.append(["inference.py", *[str(jax_out) if a is None else a for a in common]])
        runs[mode] = (port_out, jax_out)
    # the three JAX runs in one process (one jax import)
    code = ("import runpy, sys\n"
            f"for argv in {jax_argvs!r}:\n"
            "    sys.argv = argv\n"
            f"    runpy.run_path({osp.join(REPO, 'scripts', 'inference.py')!r}, run_name='__main__')\n")
    _run([sys.executable, "-c", code], env)
    return ws, env, {m: tuple(d / os.listdir(d)[0] for d in dirs) for m, dirs in runs.items()}


@pytest.mark.parametrize("mode", list(MODES))
def test_cli_matches_jax_inference_script(workspace, mode):
    ws, _, runs = workspace
    port_dir, jax_dir = runs[mode]
    assert port_dir.name.endswith("_DEEPCLR") and port_dir.name.split("_", 2)[2] == jax_dir.name.split("_", 2)[2]
    with open(port_dir / "scenario.yaml") as f:
        port_scen = yaml.safe_load(f)
    with open(jax_dir / "scenario.yaml") as f:
        jax_scen = yaml.safe_load(f)
    assert port_scen["method"]["params"]["weights_file"].endswith("weights.pt")
    port_scen["method"]["params"].pop("weights_file")
    jax_scen["method"]["params"].pop("weights_file")
    assert port_scen == jax_scen
    files = sorted(os.listdir(port_dir))
    assert files == sorted(os.listdir(jax_dir))
    expected = {f"{s}.txt": n - 1 for s, n in N_FRAMES.items()} if MODES[mode][0] == "seq" else {"08.txt": N_PAIRS}
    assert [f for f in files if f.endswith(".txt")] == sorted(expected)
    for name, rows in expected.items():
        got = np.atleast_2d(np.loadtxt(port_dir / name))
        ref = np.atleast_2d(np.loadtxt(jax_dir / name))
        assert got.shape == ref.shape == (rows, 26)
        np.testing.assert_array_equal(got[:, 0], ref[:, 0])        # stamps
        np.testing.assert_array_equal(got[:, 13:25], ref[:, 13:25])  # ground truth
        # predicted transforms: 1e-4 of each column's scale (at least 1)
        scale = np.maximum(1.0, np.abs(ref[:, 1:13]).max(axis=0))
        err = np.abs(got[:, 1:13] - ref[:, 1:13])
        assert (err <= 1e-4 * scale).all(), err.max()
        assert (got[:, 25] > 0).all() and np.isfinite(got).all()


def test_evaluation_script_scores_the_port_output(workspace):
    _, env, runs = workspace
    for mode in ("stream", "pairwise_batched"):
        run_dir = runs[mode][0]
        _run([sys.executable, osp.join(REPO, "scripts", "evaluation.py"), str(run_dir)], env)
        assert (run_dir / "evaluation" / "step_errors.csv").exists()
    assert (runs["stream"][0] / "evaluation" / "segment_errors.csv").exists()


def test_cli_refuses_cuda_without_a_card(workspace):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    ws, env, _ = workspace
    out = subprocess.run([sys.executable, "-m", "deepclr_tpu_torch.inference", str(ws / "kitti_pairs.yaml"), "toy",
                          str(ws / "never"), "--num_points", str(N)],
                         capture_output=True, text=True, env=env, cwd=REPO, timeout=120)
    assert out.returncode != 0 and "CUDA" in out.stderr
    assert not (ws / "never").exists()


def test_weights_file_round_trip_and_missing_file(tmp_path):
    from deepclr_tpu_torch.models import load_trained_model

    model = build_model(_cfg(), device="cpu", seed=4)
    save_weights(str(tmp_path / "weights.pt"), model)
    loaded = load_trained_model(_cfg(), str(tmp_path / "weights.pt"), device="cpu", seed=9)
    assert all(torch.equal(a, b) for a, b in zip(model.state_dict().values(), loaded.state_dict().values()))
    fresh = load_trained_model(_cfg(), device="cpu", seed=4)  # no path: the seeded initialisation
    assert all(torch.equal(a, b) for a, b in zip(model.state_dict().values(), fresh.state_dict().values()))
    with pytest.raises(FileNotFoundError):
        load_trained_model(_cfg(), str(tmp_path / "missing.pt"), device="cpu")
    other = copy.deepcopy(MODEL_CFG)
    other["params"]["merge"]["params"]["mlp"] = [16, 16]
    with pytest.raises(RuntimeError, match="size mismatch|Missing|Unexpected"):
        load_trained_model(other, str(tmp_path / "weights.pt"), device="cpu")
