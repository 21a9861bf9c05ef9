"""The four assigned input shapes (public-pool assignment)."""
from repro_torch.configs.base import INPUT_SHAPES, InputShape

__all__ = ["INPUT_SHAPES", "InputShape"]
