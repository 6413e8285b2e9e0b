"""Evaluation: sequence files, pose error metrics, the Evaluator and scenarios."""
from .data import Motion, Sequence
from .evaluator import SEGMENT_LENGTHS, STEP_SIZE, Evaluator
from .metrics import (
    MetricsContainer,
    RotationError,
    SegmentMetrics,
    TransformationMetrics,
    TranslationError,
)
from .scenario import load_scenario, scenario_from_dict

__all__ = [
    "Motion",
    "Sequence",
    "Evaluator",
    "STEP_SIZE",
    "SEGMENT_LENGTHS",
    "MetricsContainer",
    "TranslationError",
    "RotationError",
    "TransformationMetrics",
    "SegmentMetrics",
    "load_scenario",
    "scenario_from_dict",
]
