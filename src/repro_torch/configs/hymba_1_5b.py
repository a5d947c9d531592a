"""Hymba-1.5B — hybrid-head layers: parallel attention + mamba(SSM) heads,
meta tokens, SWA everywhere except first/middle/last (global) layers.
[arXiv:2411.13676]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="hymba-1.5b", family="hybrid",
    n_layers=32, d_model=1600, n_heads=25, n_kv_heads=5,
    d_ff=5504, vocab=32001,
    block="hymba", ssm_state=16,
    swa_window=2048, n_meta_tokens=128,
    global_attn_layers=(0, 15, 31),
    norm="rms", act="swiglu",
)
