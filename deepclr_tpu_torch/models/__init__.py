from .base import BatchedSequentialHelper, ModelInferenceHelper, pad_cloud
from .build import ModelType, build_model, init_params, load_trained_model, load_weights, save_weights
from .convert import load_jax_feature_propagation_params, load_jax_params
from .deepclr import DeepCLR, MotionEmbedding, OutputSimple, SetAbstraction
from .feature_propagation import FeaturePropagation
from .flax_msgpack import read_flax_msgpack
from .torch_convert import load_reference_checkpoint

__all__ = [
    "BatchedSequentialHelper",
    "DeepCLR",
    "FeaturePropagation",
    "ModelInferenceHelper",
    "ModelType",
    "MotionEmbedding",
    "OutputSimple",
    "SetAbstraction",
    "build_model",
    "init_params",
    "load_jax_feature_propagation_params",
    "load_jax_params",
    "load_reference_checkpoint",
    "load_trained_model",
    "load_weights",
    "pad_cloud",
    "read_flax_msgpack",
    "save_weights",
]
