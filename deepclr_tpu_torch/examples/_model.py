"""The model of the inference demos: MODEL_PATH/MODEL_NAME's
``model_config.yaml`` and its weights file, ``weights.pt`` (the port's
training runs) or ``weights.msgpack`` (the JAX package's), loaded through
``models.load_weights``; with neither file the model keeps its seed-0
initialisation, as the JAX demos start from ``init_params(PRNGKey(0))``."""
import os.path as osp

from ..config import load_model_config
from ..models import build_model, load_weights

WEIGHT_FILES = ("weights.pt", "weights.msgpack")


def load_demo_model(model_dir: str, device: str):
    """-> (model config, model on ``device``)."""
    found = [osp.join(model_dir, f) for f in WEIGHT_FILES if osp.isfile(osp.join(model_dir, f))]
    weights_file = found[0] if found else osp.join(model_dir, WEIGHT_FILES[0])
    model_cfg = load_model_config(osp.join(model_dir, "model_config.yaml"), weights_file)
    model = build_model(model_cfg, device=device, seed=0)
    if found:
        load_weights(weights_file, model)
    return model_cfg, model
