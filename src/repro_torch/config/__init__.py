from repro_torch.config.model import ModelConfig, ShapeConfig, SHAPES, cell_runnable
from repro_torch.config.registry import register_arch, get_arch, list_archs

__all__ = ["ModelConfig", "ShapeConfig", "SHAPES", "cell_runnable", "register_arch", "get_arch",
           "list_archs"]
