"""The cascade model: parameter init, layers, blocks and CascadeModel."""
from repro_torch.models.model import CascadeModel, build_model

__all__ = ["CascadeModel", "build_model"]
