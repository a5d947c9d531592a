"""Device resolution for the port's entry points.

Every entry point (`InferenceEngine`, `models.build`, `params.init_params`)
runs on the card unless its caller names the CPU explicitly, as the CPU
tests do.  Nothing falls back to the CPU silently: asking for the default
device on a machine without CUDA raises.
"""
from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """`None` means "cuda".  A CUDA device without a card raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device and none is available; "
            "pass device='cpu' explicitly to run the plain PyTorch path")
    return dev


def torch_dtype(name: str) -> torch.dtype:
    """ArchConfig.dtype ("bf16" | "f32") -> torch dtype."""
    return torch.bfloat16 if name == "bf16" else torch.float32


def generator_for(device: torch.device, seed: int) -> torch.Generator:
    """A seeded generator on `device` (draws must use a same-device one)."""
    return torch.Generator(device=device).manual_seed(seed)
