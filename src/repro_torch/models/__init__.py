"""Causal decoder model (dense or MoE FFN): layers, attention, MoE,
transformer, facade."""
from repro_torch.models.model import Model, build

__all__ = ["Model", "build"]
