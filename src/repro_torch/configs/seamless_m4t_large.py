"""SeamlessM4T-large-v2 text backbone — encoder-decoder; audio frontend
stubbed as precomputed frame embeddings per spec.  [arXiv:2308.11596]"""
from repro_torch.configs.base import ArchConfig, EncDecConfig

CONFIG = ArchConfig(
    name="seamless-m4t-large-v2", family="audio",
    n_layers=24, d_model=1024, n_heads=16, n_kv_heads=16,
    d_ff=8192, vocab=256206,
    encdec=EncDecConfig(enc_layers=24, src_len_ratio=1.0),
    frontend="audio",
    norm="rms", act="gelu",
)
