from .base import BatchedSequentialHelper, ModelInferenceHelper, pad_cloud
from .build import ModelType, build_model, init_params, load_trained_model, load_weights, save_weights
from .convert import load_jax_params
from .deepclr import DeepCLR, MotionEmbedding, OutputSimple, SetAbstraction

__all__ = [
    "BatchedSequentialHelper",
    "DeepCLR",
    "ModelInferenceHelper",
    "ModelType",
    "MotionEmbedding",
    "OutputSimple",
    "SetAbstraction",
    "build_model",
    "init_params",
    "load_jax_params",
    "load_trained_model",
    "load_weights",
    "pad_cloud",
    "save_weights",
]
