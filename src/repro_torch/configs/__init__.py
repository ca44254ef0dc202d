from .base import ModelConfig, ShapeSpec, lm_shapes  # noqa: F401
from .registry import ARCHS, get, reduced  # noqa: F401
