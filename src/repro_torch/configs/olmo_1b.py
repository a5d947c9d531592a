"""OLMo-1B — non-parametric LayerNorm, MHA.  [arXiv:2402.00838]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="olmo-1b", family="dense",
    n_layers=16, d_model=2048, n_heads=16, n_kv_heads=16,
    d_ff=8192, vocab=50304,
    norm="nonparam_ln", act="swiglu", tie_embeddings=True,
)
