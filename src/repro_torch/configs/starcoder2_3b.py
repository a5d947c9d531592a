"""StarCoder2-3B — GQA(kv=2), RoPE, sliding-window attention (4096).
[arXiv:2402.19173]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="starcoder2-3b", family="dense",
    n_layers=30, d_model=3072, n_heads=24, n_kv_heads=2,
    d_ff=12288, vocab=49152,
    swa_window=4096,              # makes long_500k runnable (windowed KV)
    norm="rms", act="gelu",
)
