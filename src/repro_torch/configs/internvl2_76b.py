"""InternVL2-76B — InternViT frontend (stubbed per spec) + InternLM2-76B
backbone.  [arXiv:2404.16821]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="internvl2-76b", family="vlm",
    n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8,
    d_ff=28672, vocab=128256,
    frontend="vision", n_prefix_tokens=256,   # ViT patch embeddings (stub)
    norm="rms", act="swiglu", rope_theta=1_000_000.0,
)
