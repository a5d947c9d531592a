"""Dense causal decoder model: layers, attention, transformer, facade."""
from repro_torch.models.model import Model, build

__all__ = ["Model", "build"]
