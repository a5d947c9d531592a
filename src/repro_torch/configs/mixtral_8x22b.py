"""Mixtral-8x22B — 8 experts top-2, GQA, sliding-window attention.
[arXiv:2401.04088]"""
from repro_torch.configs.base import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="mixtral-8x22b", family="moe",
    n_layers=56, d_model=6144, n_heads=48, n_kv_heads=8,
    d_ff=16384, vocab=32768,
    moe=MoEConfig(num_experts=8, top_k=2),
    swa_window=4096,              # per assignment: SWA -> long_500k runnable
    norm="rms", act="swiglu",
)
