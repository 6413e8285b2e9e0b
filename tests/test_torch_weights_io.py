"""Weight files the port reads without JAX: Flax msgpack (the JAX package's
``weights.msgpack`` and ``ckpt_*.msgpack``) through the port's own reader,
held bit for bit against ``flax.serialization``, and reference PyTorch
checkpoints (``weights.tar`` / ``ckpt.tar``), held against the JAX
package's converter; then ``load_trained_model`` and ``python -m
deepclr_tpu_torch.convert_weights`` on each.  Predictions of a loaded model
equal the source model's within 1e-5 (float32)."""
import copy

import flax.serialization
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import yaml

torch = pytest.importorskip("torch")

from deepclr_tpu.engine.checkpoint import Checkpointer  # noqa: E402
from deepclr_tpu.engine.trainer import create_train_state as jax_create_train_state  # noqa: E402
from deepclr_tpu.models import build_model as jax_build_model, init_params as jax_init_params  # noqa: E402
from deepclr_tpu.models import save_weights as jax_save_weights  # noqa: E402
from deepclr_tpu.models.torch_convert import load_torch_checkpoint  # noqa: E402
from deepclr_tpu.models.torch_io import write_torch_checkpoint  # noqa: E402
from deepclr_tpu.solver.build import make_optimizer as jax_make_optimizer  # noqa: E402
from deepclr_tpu_torch import convert_weights  # noqa: E402
from deepclr_tpu_torch.configs import KITTI_MODEL_CFG  # noqa: E402
from deepclr_tpu_torch.geometry import LabelType  # noqa: E402
from deepclr_tpu_torch.models import (DeepCLR, MotionEmbedding, OutputSimple, SetAbstraction,  # noqa: E402
                                      build_model, init_params, load_jax_params, load_reference_checkpoint,
                                      load_trained_model, load_weights, save_weights)
from deepclr_tpu_torch.models.flax_msgpack import restore_flax_msgpack  # noqa: E402
from deepclr_tpu_torch.models.torch_convert import convert_reference_state_dict  # noqa: E402


def _tiny_cfg(loss=None):
    cfg = copy.deepcopy(KITTI_MODEL_CFG)
    params = cfg["params"]
    params["compute_dtype"] = "float32"
    params["cloud_features"]["params"].update(npoint=[32], nsamples=[[8, 16]])
    params["merge"]["params"].update(k=6, mlp=[16, 16, 32])
    params["output"]["params"].update(mlp=[32, 32, 64], linear=[64, 32, 16])
    if loss is not None:
        params["loss"] = loss
    return cfg


def _clouds(seed, b=2, n=256):
    rng = np.random.default_rng(seed)
    pts = rng.normal(size=(2 * b, n, 3)) * np.array([3.0, 3.0, 0.5])
    return np.concatenate([pts, rng.uniform(size=(2 * b, n, 1))], -1).astype(np.float32)


def _predict(model, seed=0):
    c = torch.from_numpy(_clouds(seed))
    with torch.no_grad():
        return model(c[:2], c[2:])[0].numpy()


def _assert_same_state(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        assert torch.equal(got[k].float(), want[k].float()), k


# --- the msgpack reader -----------------------------------------------------

def _assert_trees_bit_equal(got, want):
    if isinstance(want, dict):
        assert isinstance(got, dict) and sorted(got) == sorted(want)
        for k in want:
            _assert_trees_bit_equal(got[k], want[k])
    elif isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want)
        for g, w in zip(got, want):
            _assert_trees_bit_equal(g, w)
    elif isinstance(want, (np.ndarray, np.generic)):
        w = np.asarray(want)
        if w.dtype == jnp.bfloat16:  # the reader widens bfloat16 exactly to float32
            w = w.astype(np.float32)
        g = np.asarray(got)
        assert g.dtype == w.dtype and g.shape == w.shape
        assert g.tobytes() == w.tobytes()
    else:
        assert type(got) is type(want) and got == want


def _sample_tree():
    rng = np.random.default_rng(0)
    return {
        "params": {"merge": {"mlp": {"dense_0": {"kernel": rng.normal(size=(7, 16)).astype(np.float32),
                                                 "bias": rng.normal(size=16).astype(np.float32)},
                                     "bn_0": {"scale": np.ones(16, np.float32), "bias": np.zeros(16, np.float32)}}}},
        "batch_stats": {"merge": {"mlp": {"bn_0": {"mean": rng.normal(size=16).astype(np.float32),
                                                   "var": rng.uniform(size=16).astype(np.float32)}}}},
        "step": np.int32(7), "scale": np.float32(0.5), "epoch": 3, "negative": -40, "large": 2 ** 40,
        "rate": 1.25, "name": "deepclr", "blob": b"\x00\x01", "nothing": None, "flag": True,
        "mixed": [1, 2.5, "x", [np.arange(3, dtype=np.int64)]],
        "half": jnp.asarray(rng.normal(size=(3, 5)), jnp.bfloat16), "mask": rng.uniform(size=(4,)) > 0.5,
        "double": rng.normal(size=(2, 2)), "long": np.arange(70000, dtype=np.int32),
        "empty": {}, "zero_d": np.array(3.0, np.float32),
    }


def test_msgpack_reader_equals_flax_bit_for_bit():
    tree = _sample_tree()
    data = flax.serialization.to_bytes(tree)
    want = flax.serialization.msgpack_restore(data)
    _assert_trees_bit_equal(restore_flax_msgpack(data), want)


def test_msgpack_reader_reassembles_chunked_arrays(monkeypatch):
    monkeypatch.setattr(flax.serialization, "MAX_CHUNK_SIZE", 64)
    tree = {"params": {"w": np.arange(300, dtype=np.float32).reshape(10, 30), "b": np.arange(5, dtype=np.float32)}}
    data = flax.serialization.to_bytes(tree)
    assert b"__msgpack_chunked_array__" in data
    got = restore_flax_msgpack(data)
    _assert_trees_bit_equal(got, {"params": {"w": tree["params"]["w"], "b": tree["params"]["b"]}})
    assert got["params"]["w"].flags.writeable


@pytest.mark.parametrize("case", ["complex", "truncated", "trailing", "unused_byte"])
def test_msgpack_reader_rejects_what_it_cannot_read(case):
    data = {"complex": lambda: flax.serialization.to_bytes({"c": 1 + 2j}),
            "truncated": lambda: flax.serialization.to_bytes({"w": np.ones(4, np.float32)})[:-3],
            "trailing": lambda: flax.serialization.to_bytes({"w": 1}) + b"\x00",
            "unused_byte": lambda: b"\x81\xa1w\xc1"}[case]()
    with pytest.raises(ValueError, match="flax msgpack"):
        restore_flax_msgpack(data)


# --- JAX weight files ---------------------------------------------------------

@pytest.fixture(scope="module")
def jax_model():
    cfg = _tiny_cfg()
    jmodel = jax_build_model(cfg)
    variables = jax.jit(lambda key: jax_init_params(jmodel, key, num_points=256, batch_size=2))(
        jax.random.PRNGKey(3))
    c = _clouds(0)
    y_ref = np.asarray(jax.jit(lambda v: jmodel.apply(v, c[:2], c[2:])[0])(variables))
    return cfg, jmodel, jax.device_get(variables), y_ref


def test_load_trained_model_on_jax_weights_msgpack_predicts_what_jax_predicts(jax_model, tmp_path):
    cfg, _, variables, y_ref = jax_model
    path = str(tmp_path / "weights.msgpack")
    jax_save_weights(path, variables)
    model = load_trained_model(cfg, path, device="cpu")
    np.testing.assert_allclose(_predict(model), y_ref, rtol=0, atol=1e-5)


def test_jax_checkpoint_msgpack_loads_its_params(jax_model, tmp_path):
    """A full ``ckpt_*.msgpack`` (epoch, iteration and the train state, with
    Ranger's state) loads the state's params."""
    cfg, jmodel, variables, y_ref = jax_model
    opt = jax_make_optimizer(type("C", (), {"optimizer": type("O", (), {
        "name": "Ranger", "base_lr": 1e-3, "weight_decay": 0.0, "params": {}})()})())
    state = jax_create_train_state(jmodel, variables, opt, ["loss"])
    path = Checkpointer(str(tmp_path)).save_checkpoint(1, 5, state, variables)
    assert path.endswith("ckpt_5.msgpack")
    model = build_model(cfg, device="cpu", seed=9)
    load_weights(path, model)
    np.testing.assert_allclose(_predict(model), y_ref, rtol=0, atol=1e-5)


# --- reference checkpoints ----------------------------------------------------

def _reference_layout(state):
    """The port's state dict as the reference writes it: 1x1 convolution
    weights, Dropout taking every other index of the pose head's linear
    stack, and each batch norm's num_batches_tracked."""
    out = {}
    for key, value in state.items():
        value = value.detach().numpy().copy()
        if key.startswith("_cloud_layers.") and key.endswith("conv.weight"):
            value = value[:, :, None, None]
        elif key.endswith("_sequential.0.weight"):
            value = value[:, :, None]
        if key.startswith("_merge_layers.1.linear._sequential."):
            i = int(key.split(".")[4])
            key = key.replace(f"linear._sequential.{i}.", f"linear._sequential.{2 * i}.", 1)
        out[key] = value
        if key.endswith("running_var"):
            out[key.replace("running_var", "num_batches_tracked")] = np.array(4, np.int64)
    return out


def test_reference_checkpoint_reader_agrees_with_the_jax_converter(tmp_path):
    model = build_model(_tiny_cfg(), device="cpu", seed=5)
    path = str(tmp_path / "weights.tar")
    write_torch_checkpoint(path, _reference_layout(model.state_dict()))
    got = load_reference_checkpoint(path)
    _assert_same_state(got, load_jax_params(load_torch_checkpoint(path)))
    _assert_same_state(got, model.state_dict())
    # a ckpt.tar holds the state dict under model_state_dict
    ckpt = str(tmp_path / "ckpt.tar")
    torch.save({"epoch": 2, "iteration": 10, "model_state_dict": {
        k: torch.from_numpy(v) for k, v in _reference_layout(model.state_dict()).items()}}, ckpt)
    _assert_same_state(load_reference_checkpoint(ckpt), model.state_dict())


def test_reference_checkpoint_with_batch_norm_and_its_strict_check():
    """Batch-norm layers (beside their convolution, Dropout shifting the
    indices) map to the port's; an entry the map does not use raises."""
    sa = SetAbstraction(4, npoint=[16], radii=[[0.5, 1.0]], nsamples=[[8, 8]], mlps=[[[8, 8, 16], [8, 8, 16]]])
    me = MotionEmbedding(32, mlp=[16, 32], k=4, batch_norm=True)
    head = OutputSimple(35, mlp=[32, 32], linear=[32, 16], label_type=LabelType.POSE3D_DUAL_QUAT, batch_norm=True)
    model = init_params(DeepCLR(sa, me, head), 2)
    with torch.no_grad():
        for name, buf in model.named_buffers():
            buf.copy_(torch.rand(buf.shape) + 0.5)
    ref = _reference_layout(model.state_dict())
    assert any(k.endswith("num_batches_tracked") for k in ref)
    got = convert_reference_state_dict({k: torch.from_numpy(v) for k, v in ref.items()})
    _assert_same_state(got, model.state_dict())
    ref["_merge_layers.1.extra.weight"] = np.ones(2, np.float32)
    with pytest.raises(ValueError, match="_merge_layers.1.extra.weight"):
        convert_reference_state_dict({k: torch.from_numpy(v) for k, v in ref.items()})


def test_learned_accumulated_loss_round_trips_through_a_reference_checkpoint(tmp_path):
    """The indexed ``_loss_layer.losses.{i}._{sx,sq}`` of an AccumulatedLoss
    go out to a reference checkpoint and come back."""
    loss = [{"name": "TransformLoss"}, {"name": "TransformUncertaintyLoss", "params": {"sx": 0.0, "sq": -2.5}}]
    model = build_model(_tiny_cfg(loss=loss), device="cpu", seed=6)
    with torch.no_grad():
        model.loss_module.losses[1]._sx.fill_(0.25)
    path = str(tmp_path / "weights.tar")
    write_torch_checkpoint(path, _reference_layout(model.state_dict()))
    other = load_trained_model(_tiny_cfg(loss=loss), path, device="cpu", seed=7)
    assert other.loss_module.losses[1]._sx.item() == 0.25 and other.loss_module.losses[1]._sq.item() == -2.5
    _assert_same_state(other.state_dict(), model.state_dict())


@pytest.mark.parametrize("kind", ["tar", "msgpack"])
def test_convert_weights_cli_writes_a_loadable_weights_pt(kind, jax_model, tmp_path, capsys):
    cfg, _, variables, y_ref = jax_model
    cfg_path = tmp_path / "model_config.yaml"
    with open(cfg_path, "w") as f:
        yaml.dump(cfg, f)
    if kind == "msgpack":
        src = str(tmp_path / "weights.msgpack")
        jax_save_weights(src, variables)
        want = y_ref
    else:
        model = build_model(cfg, device="cpu", seed=8)
        src = str(tmp_path / "weights.tar")
        write_torch_checkpoint(src, _reference_layout(model.state_dict()))
        want = _predict(model)
    out = str(tmp_path / "weights.pt")
    convert_weights.main([src, str(cfg_path), out])
    assert f"wrote {out}" in capsys.readouterr().out
    np.testing.assert_allclose(_predict(load_trained_model(cfg, out, device="cpu")), want, rtol=0, atol=1e-5)
    # and the port's own weights.pt round-trips through save_weights
    again = str(tmp_path / "again.pt")
    save_weights(again, load_weights(out, build_model(cfg, device="cpu")))
    _assert_same_state(torch.load(again, weights_only=True), torch.load(out, weights_only=True))
