"""The port's spans (``deepclr_tpu_torch/utils/profiling.py``) and where the
port opens them: off they cost a flag check and record nothing; on they
sum count, seconds and self seconds per name, nest per thread, and lie on
the ``torch.profiler`` clock; the inference helpers, the train step and
the loader's prefetcher open one span a frame, micro-step or batch, and
the model one a block.  The motion embedding's counters move only while
spans are on, and never inside a captured CUDA graph."""
import copy
import json
import logging
import threading

import numpy as np
import pytest
import torch

from deepclr_tpu_torch import solver
from deepclr_tpu_torch.config import Mode, create_default_config, finish_config
from deepclr_tpu_torch import ops
from deepclr_tpu_torch.configs import KITTI_MODEL_CFG, KITTI_TRAIN_CFG, MODELNET40_MODEL_CFG
from deepclr_tpu_torch.data import PackWriter, make_data_loader
from deepclr_tpu_torch.data.loader import _Prefetcher
from deepclr_tpu_torch.engine import create_train_state, make_train_step, run_trainer
from deepclr_tpu_torch.losses import make_loss_fn, make_metric_fns
from deepclr_tpu_torch.models import BatchedSequentialHelper, ModelInferenceHelper, base, build_model
from deepclr_tpu_torch.synthetic import cad_train_batch, kitti_like_sequence, train_batch
from deepclr_tpu_torch.utils import profiling
from deepclr_tpu_torch.utils.profiling import counter_stats, enable_spans, reset_spans, span, span_stats, spans

POINTS = 256
HELPER = ("helper.predict", "helper.pad", "helper.upload", "helper.model", "helper.fetch")
TRAIN = ("train.upload", "train.forward", "train.backward", "train.metrics")
MODEL = ("model.encode", "model.merge", "model.head")


@pytest.fixture(autouse=True)
def spans_off_after():
    reset_spans()
    yield
    enable_spans(False)
    reset_spans()


def _tiny_model(seed=1):
    """The flagship architecture at reduced size, float32, on the CPU."""
    cfg = copy.deepcopy(KITTI_MODEL_CFG)
    params = cfg["params"]
    params["compute_dtype"] = "float32"
    params["cloud_features"]["params"].update(npoint=[16], nsamples=[[32, 64]])
    params["merge"]["params"].update(k=8, mlp=[64, 64, 128])
    params["output"]["params"].update(mlp=[128, 128, 256], linear=[256, 128, 64])
    return build_model(cfg, device="cpu", seed=seed)


def _frames(n, seed=0, points=400):
    rng = np.random.default_rng(seed)
    return [(rng.normal(size=(points, 4)) * [5.0, 5.0, 1.0, 0.3]).astype(np.float32) for _ in range(n)]


class _Clock:
    """A fake ``perf_counter_ns``: each read advances by the next step."""

    def __init__(self, steps):
        self.t, self.steps = 0, iter(steps)

    def __call__(self):
        self.t += next(self.steps)
        return self.t


# --- the facility -----------------------------------------------------------------------------------------------

def test_spans_off_make_no_clock_read_no_scope_and_no_record(monkeypatch):
    calls = []
    monkeypatch.setattr(profiling, "record_function", lambda *a: calls.append(("scope", a)))
    monkeypatch.setattr(profiling, "_now", lambda: calls.append("clock"))
    assert span("a") is span("b", id=3)   # one shared no-op context
    with span("a") as s, span("b"):
        pass
    assert s is None and calls == [] and span_stats() == {} and spans() == []


def test_nested_spans_sum_count_seconds_and_self_seconds(monkeypatch):
    # outer [10, 110): inner [20, 50) and [60, 80); the second outer [110, 116)
    monkeypatch.setattr(profiling, "_now", _Clock([10, 10, 30, 10, 20, 30, 0, 6]))
    scopes = []   # no profiler records: no record_function scope either
    monkeypatch.setattr(profiling, "record_function", lambda *a: scopes.append(a))
    enable_spans(True)
    with span("outer", id=7):
        with span("inner"):
            pass
        with span("inner", id=8):
            pass
    with span("outer"):
        pass
    stats = span_stats()
    assert stats["outer"] == {"count": 2, "seconds": pytest.approx(106e-9), "self_seconds": pytest.approx(56e-9)}
    assert stats["inner"] == {"count": 2, "seconds": pytest.approx(50e-9), "self_seconds": pytest.approx(50e-9)}
    assert spans() == [("inner", 7, "outer", 20, 50), ("inner", 8, "outer", 60, 80),
                       ("outer", 7, None, 10, 110), ("outer", None, None, 110, 116)]
    assert scopes == []
    reset_spans()
    assert span_stats() == {} and spans() == []


def test_a_discarded_span_records_nothing():
    enable_spans(True)
    with span("kept"):
        with span("gone") as s:
            s.discard()
    assert set(span_stats()) == {"kept"} and span_stats()["kept"]["self_seconds"] == span_stats()["kept"]["seconds"]


def test_a_threads_spans_do_not_nest_under_another_threads():
    enable_spans(True)
    started, release = threading.Event(), threading.Event()

    def other():
        with span("thread.outer", id="t"):
            started.set()
            release.wait(10)
            with span("thread.inner"):
                pass

    t = threading.Thread(target=other)
    with span("main.outer", id="m"):
        t.start()
        assert started.wait(10)
        with span("main.inner"):
            release.set()
            t.join(10)
    assert not t.is_alive()
    parents = {name: (id_, parent) for name, id_, parent, _, _ in spans()}
    assert parents == {"thread.inner": ("t", "thread.outer"), "thread.outer": ("t", None),
                       "main.inner": ("m", "main.outer"), "main.outer": ("m", None)}
    assert all(v["count"] == 1 for v in span_stats().values())


def test_trace_turns_spans_on_and_names_them_in_its_file(tmp_path):
    with profiling.trace(str(tmp_path)):
        with span("outer.block"):
            torch.ones(4).add_(1)
    assert span_stats()["outer.block"]["count"] == 1
    with span("after.trace"):
        pass
    assert "after.trace" not in span_stats()
    names = {e.get("name") for e in json.loads((tmp_path / "trace.json").read_text())["traceEvents"]}
    assert "outer.block" in names


# --- the inference helpers --------------------------------------------------------------------------------------

def test_sequential_predict_gives_one_span_of_each_a_frame(monkeypatch):
    padded = []
    original = base.pad_cloud
    monkeypatch.setattr(base, "pad_cloud", lambda *a, **k: padded.append(1) or original(*a, **k))
    helper = ModelInferenceHelper(_tiny_model(), is_sequential=True, num_points=POINTS)
    frames = _frames(5)
    enable_spans(True)
    poses = [helper.predict(f) for f in frames[:4]]
    assert poses[0] is None and all(p is not None for p in poses[1:])
    stats = span_stats()
    assert {n: s["count"] for n, s in stats.items()} == {"helper.predict": 4, "helper.pad": 4, "helper.upload": 4,
                                                        "helper.model": 4, "helper.fetch": 3, "model.encode": 4,
                                                        "model.merge": 3, "model.head": 3}
    by_id = {}
    for name, id_, parent, start, end in spans():
        by_id.setdefault(id_, []).append(name)
        want = "helper.model" if name in MODEL else None if name == "helper.predict" else "helper.predict"
        assert parent == want and end >= start
    assert sorted(by_id) == [1, 2, 3, 4]
    assert all(sorted(by_id[i]) == sorted(HELPER + MODEL) for i in (2, 3, 4))
    children = sum(stats[n]["seconds"] for n in HELPER[1:])
    assert stats["helper.predict"]["self_seconds"] == pytest.approx(stats["helper.predict"]["seconds"] - children)
    assert len(padded) == 4   # the benchmark's wrapper at the module global sees every pad
    enable_spans(False)
    helper.predict(frames[4])
    assert span_stats() == stats and len(padded) == 5


def test_pairwise_and_batched_helpers_open_the_same_spans():
    model = _tiny_model()
    frames = _frames(6)
    enable_spans(True)
    ModelInferenceHelper(model, num_points=POINTS).predict_batch(frames[:2], frames[2:4])
    assert {n: s["count"] for n, s in span_stats().items()} == {
        "helper.predict": 1, "helper.pad": 2, "helper.upload": 2, "helper.model": 1, "helper.fetch": 1,
        "model.encode": 1, "model.merge": 1, "model.head": 1}
    reset_spans()
    lanes = BatchedSequentialHelper(model, batch=2, num_points=POINTS)
    for i in range(3):
        lanes.step(frames[2 * i:2 * i + 2])
    assert {n: s["count"] for n, s in span_stats().items()} == {
        "helper.predict": 3, "helper.pad": 3, "helper.upload": 3, "helper.model": 3, "helper.fetch": 2,
        "model.encode": 3, "model.merge": 2, "model.head": 2}
    assert {id_ for _, id_, _, _, _ in spans()} == {1, 2, 3}


def test_the_uploads_operators_lie_inside_its_span_on_the_profilers_clock():
    """uint16 uploads dequantise on the device: operators of their own."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    helper = ModelInferenceHelper(_tiny_model(), is_sequential=True, num_points=POINTS, upload_dtype="uint16")
    frames = _frames(3)
    helper.predict(frames[0])
    enable_spans(True)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for f in frames[1:]:
            helper.predict(f)
    events = [e for e in prof.events() if e.device_type == DeviceType.CPU]
    window = {n: [(e.time_range.start, e.time_range.end) for e in events if e.name == n] for n in HELPER}
    assert all(len(v) == 2 for v in window.values())
    ops = [e for e in events if e.name.startswith("aten::")]
    in_upload = [e for e in ops if any(s <= e.time_range.start < t for s, t in window["helper.upload"])]
    assert "aten::bitwise_and" in {e.name for e in in_upload}
    for e in in_upload:
        assert any(s <= e.time_range.start and e.time_range.end <= t for s, t in window["helper.upload"]), e.name
    children = [w for n in HELPER[1:] for w in window[n]]
    for e in ops:   # every operator of a frame is inside one of its children
        assert any(s <= e.time_range.start and e.time_range.end <= t for s, t in children), e.name


# --- the train step ---------------------------------------------------------------------------------------------

def _step(model, k):
    opt = solver.make_optimizer(KITTI_TRAIN_CFG, model.parameters())
    losses, other = KITTI_TRAIN_CFG["metrics"]["loss"], KITTI_TRAIN_CFG["metrics"]["other"]
    step = make_train_step(model, opt, make_loss_fn(losses, "pose3d_dual_quat"),
                           make_metric_fns(losses, other, "pose3d_dual_quat"), accumulation_steps=k)
    return opt, step


def test_the_train_step_updates_in_a_span_every_kth_micro_step():
    model = _tiny_model()
    opt, step = _step(model, k=2)
    hooked = []
    opt.register_step_pre_hook(lambda *_: hooked.append([s for s in spans() if s[0] == "train.update"]))
    state = create_train_state(model)
    batch = train_batch(2, POINTS, seed=3)
    enable_spans(True)
    for _ in range(4):
        step(state, batch, 1e-3)
    stats = span_stats()
    assert stats["train.step"]["count"] == 4 and stats["train.update"]["count"] == 2
    assert all(stats[n]["count"] == 4 for n in TRAIN)
    records = spans()
    assert [i for n, i, _, _, _ in records if n == "train.update"] == [1, 3]
    assert [i for n, i, _, _, _ in records if n == "train.step"] == [0, 1, 2, 3]
    assert all(p == ("train.forward" if n in MODEL else "train.step") for n, _, p, _, _ in records if n != "train.step")
    # the optimizer's hooks fire inside the update's span: before it has exited
    assert len(hooked) == 2 and hooked[1] == [r for r in records if r[0] == "train.update"][:1]
    children = sum(stats[n]["seconds"] for n in TRAIN + ("train.update",))
    assert stats["train.step"]["self_seconds"] == pytest.approx(stats["train.step"]["seconds"] - children)


# --- the model's blocks and counters ----------------------------------------------------------------------------

def test_the_models_blocks_nest_under_the_forward_in_order():
    model = _tiny_model()
    _, step = _step(model, k=2)
    state = create_train_state(model)
    enable_spans(True)
    for _ in range(2):
        step(state, train_batch(2, POINTS, seed=3), 1e-3)
    records = spans()
    blocks = [(name, id_, parent, start) for name, id_, parent, start, _ in records if name.startswith("model.")]
    assert all(parent == "train.forward" for _, _, parent, _ in blocks)
    for step_id in (0, 1):
        assert [n for n, i, _, _ in sorted(blocks, key=lambda r: r[3]) if i == step_id] == list(MODEL)
    forward = span_stats()["train.forward"]
    children = sum(span_stats()[n]["seconds"] for n in MODEL)
    assert forward["self_seconds"] == pytest.approx(forward["seconds"] - children)


def _modelnet40_model(npoint=64):
    cfg = copy.deepcopy(MODELNET40_MODEL_CFG)
    cfg["params"]["compute_dtype"] = "float32"
    cfg["params"]["cloud_features"]["params"]["npoint"] = [npoint]
    return build_model(cfg, device="cpu", seed=2)


def test_the_cut_count_is_the_share_of_neighbours_at_or_beyond_the_radius():
    """``merge.cut`` against a direct count of the kNN distances at or
    beyond the radius; ``merge.pairs`` is B x P x k a forward."""
    model = _modelnet40_model()
    b = {k: torch.from_numpy(v) for k, v in cad_train_batch(3, 512, seed=4).items()}
    enable_spans(True)
    with torch.no_grad():
        model(b["template"], b["source"])
        feats = model.encode(torch.cat([b["template"], b["source"]]))
    merge = model.merge
    _, d2 = ops.knn(feats[:3, :, :3], feats[3:, :, :3], merge.k)
    counts = counter_stats()
    assert counts == {"merge.pairs": 3 * 64 * merge.k, "merge.cut": int((d2 >= merge.radius ** 2).sum())}
    assert 0.5 < counts["merge.cut"] / counts["merge.pairs"] < 1.0
    reset_spans()
    assert counter_stats() == {}


class _Untouchable:
    def __getattr__(self, name):
        raise AssertionError(f"a counter read .{name} with spans off")


def test_spans_off_move_no_counter_and_enter_no_scope(monkeypatch):
    scopes = []
    monkeypatch.setattr(profiling, "record_function", lambda *a: scopes.append(a))
    profiling.count("merge.cut", _Untouchable(), total="merge.pairs")   # one flag check: the mask is not read
    model = _modelnet40_model(npoint=16)
    _, step = _step(model, k=2)
    step(create_train_state(model), cad_train_batch(2, 256, seed=4), 1e-3)
    assert counter_stats() == {} and span_stats() == {} and scopes == []


@pytest.mark.cuda
def test_spans_on_leave_the_sequential_graph_bit_equal_and_count_only_eager_frames():
    """On the card: a sequential helper with spans on replays the graph it
    captured bit-equal to one with spans off, and its counters hold only
    the warm-up frame, which ran eagerly: nothing was captured into the
    graph."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the sequential graph is captured only there")
    model = build_model(KITTI_MODEL_CFG, device="cuda", seed=3)
    frames = kitti_like_sequence(6, 20000, seed=31)[0]
    poses = {}
    for on in (False, True):
        enable_spans(on)
        reset_spans()
        helper = ModelInferenceHelper(model, is_sequential=True, num_points=16384, seed=4)
        poses[on] = [helper.predict(f) for f in frames]
        assert helper.graph_counts() == {"captures": 1, "replays": 4, "eager": 1}
        enable_spans(False)
        counts = counter_stats()
        k = KITTI_MODEL_CFG["params"]["merge"]["params"]["k"]
        assert counts == ({} if not on else {"merge.pairs": 1024 * k, "merge.cut": counts["merge.cut"]})
    assert poses[True][0] is None and poses[False][0] is None
    for got, want in zip(poses[True][1:], poses[False][1:]):
        np.testing.assert_array_equal(got, want)


# --- the loader -------------------------------------------------------------------------------------------------

@pytest.fixture(scope="module")
def pack_cfg(tmp_path_factory):
    ws = tmp_path_factory.mktemp("tracing")
    rng = np.random.default_rng(0)
    with PackWriter(str(ws / "00.pack")) as w:
        for i in range(9):
            pose = np.eye(4)
            pose[0, 3] = float(i)
            w.put(f"{i:06d}", {"idx": i, "timestamp": i * 1e5, "pose": pose,
                               "cloud": (rng.normal(size=(80, 4)) * 5).astype(np.float32)})
    cfg = create_default_config(Mode.TEST)
    cfg.read_dict({"base_dir": str(ws), "seed": 3,
                   "data": {"training": str(ws / "00.pack"), "validation": str(ws / "00.pack"),
                            "dataset_type": "kitti_odometry_velodyne"},
                   "transforms": {"point_noise": {"scale": 0.01}},
                   "data_loader": {"batch_size": 2, "buffer_size": 2, "num_points": 64, "num_workers": 0},
                   "model": {"input_dim": 4, "point_dim": 3, "label_type": "pose3d_dual_quat",
                             "model_type": "deepclr", "params": {"presorted": False}}})
    finish_config(cfg)
    return cfg


def test_the_loader_waits_once_a_batch_handed_out(pack_cfg):
    loader = make_data_loader(pack_cfg, True)
    enable_spans(True)
    batches = list(loader)
    assert len(batches) == len(loader) == 4
    assert span_stats()["loader.wait"]["count"] == 4
    assert [i for n, i, _, _, _ in spans()] == [0, 1, 2, 3]
    next(iter(loader))   # a consumer that stops early has waited once
    assert span_stats()["loader.wait"]["count"] == 5


class _Loader:
    """A sized prefetched loader of fixed batches."""

    def __init__(self, batches):
        self.batches = batches

    def __len__(self):
        return len(self.batches)

    def __iter__(self):
        return iter(_Prefetcher(lambda: iter(self.batches), 2))


@pytest.mark.parametrize("on", [False, True])
def test_the_epoch_log_line_gives_the_loaders_wait_when_spans_are_on(on):
    cfg = copy.deepcopy(KITTI_TRAIN_CFG)
    cfg["optimizer"].update(max_iterations=2, max_epochs=None)
    cfg["logging"].update(log_period=100, checkpoint_period=100, validation_period=100)
    model = _tiny_model()
    losses, other = cfg["metrics"]["loss"], cfg["metrics"]["other"]
    lines = []
    handler = logging.Handler()
    handler.emit = lambda record: lines.append(record.getMessage())
    log = logging.getLogger("deepclr_tpu_torch.engine.trainer")
    log.addHandler(handler)
    previous_level = log.level
    log.setLevel(logging.INFO)
    try:
        enable_spans(on)
        run_trainer(cfg, model, _Loader([train_batch(2, POINTS, seed=s) for s in (3, 4)]), None,
                    solver.make_optimizer(cfg, model.parameters()), solver.make_schedule(cfg),
                    make_loss_fn(losses, "pose3d_dual_quat"), make_metric_fns(losses, other, "pose3d_dual_quat"))
    finally:
        log.removeHandler(handler)
        log.setLevel(previous_level)
    epoch = [line for line in lines if line.startswith("Epoch 1 done.")]
    assert len(epoch) == 1
    if on:
        assert span_stats()["loader.wait"]["count"] == 2
        ms = 1e3 * span_stats()["loader.wait"]["seconds"] / 2
        assert epoch[0].endswith(f"Loader wait: {ms:.3f}[ms/batch]")
    else:
        assert "Loader wait" not in epoch[0] and span_stats() == {}
