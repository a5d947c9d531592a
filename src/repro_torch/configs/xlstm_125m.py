"""xLSTM-125M — alternating mLSTM (matrix memory) + sLSTM (scalar memory)
blocks; d_ff=0 (projections live inside the blocks).  [arXiv:2405.04517]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="xlstm-125m", family="ssm",
    n_layers=12, d_model=768, n_heads=4, n_kv_heads=4,
    d_ff=0, vocab=50304,
    block="xlstm", tie_embeddings=True,
    norm="rms",
)
