from .labels import LabelType
from . import quaternion
from . import se3

__all__ = ["LabelType", "quaternion", "se3"]
