from .base import ModelConfig, ShapeConfig, smoke_config
from .registry import ARCHS, get_config, list_archs
from .shapes import SHAPES, applicable

__all__ = ["ModelConfig", "ShapeConfig", "smoke_config", "ARCHS",
           "get_config", "list_archs", "SHAPES", "applicable"]
