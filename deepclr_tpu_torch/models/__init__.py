from .base import ModelInferenceHelper, pad_cloud
from .build import build_model, init_params
from .convert import load_jax_params
from .deepclr import DeepCLR, MotionEmbedding, OutputSimple, SetAbstraction

__all__ = [
    "DeepCLR",
    "ModelInferenceHelper",
    "MotionEmbedding",
    "OutputSimple",
    "SetAbstraction",
    "build_model",
    "init_params",
    "load_jax_params",
    "pad_cloud",
]
