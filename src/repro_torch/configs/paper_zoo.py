"""The paper's own model zoo (Table 1): Ollama-served open models.

These are the models AIvailable actually deploys on its heterogeneous fleet
(llama3.2 1b/3b, gemma3 1b/4b, deepseek-r1 distills, qwen3, qwen2.5vl, and the
embedding models nomic-embed-text / mxbai-embed-large).  We express each as an
ArchConfig so the SDAI controller places them exactly as the paper does; the
serving examples use scaled-down (`reduced()`) variants so they run on CPU.

Param-count sanity: llama32_1b ~= 1.24e9, gemma3_1b ~= 1.0e9 — matching the
published sizes closely enough for VRAM placement math.
"""
from repro_torch.configs.base import ArchConfig

llama32_1b = ArchConfig(
    name="llama3.2-1b", family="dense",
    n_layers=16, d_model=2048, n_heads=32, n_kv_heads=8, head_dim=64,
    d_ff=8192, vocab=128256, tie_embeddings=True,
    norm="rms", act="swiglu", rope_theta=500000.0,
)

llama32_3b = ArchConfig(
    name="llama3.2-3b", family="dense",
    n_layers=28, d_model=3072, n_heads=24, n_kv_heads=8,
    d_ff=8192, vocab=128256, tie_embeddings=True,
    norm="rms", act="swiglu", rope_theta=500000.0,
)

gemma3_1b = ArchConfig(
    name="gemma3-1b", family="dense",
    n_layers=26, d_model=1152, n_heads=4, n_kv_heads=1, head_dim=256,
    d_ff=6912, vocab=262144, tie_embeddings=True,
    swa_window=512, norm="rms", act="gelu",
)

gemma3_4b = ArchConfig(
    name="gemma3-4b", family="vlm",
    n_layers=34, d_model=2560, n_heads=8, n_kv_heads=4, head_dim=256,
    d_ff=10240, vocab=262144, tie_embeddings=True,
    frontend="vision", n_prefix_tokens=256,
    swa_window=1024, norm="rms", act="gelu",
)

deepseek_r1_1_5b = ArchConfig(
    name="deepseek-r1-1.5b", family="dense",   # Qwen2.5-1.5B distill
    n_layers=28, d_model=1536, n_heads=12, n_kv_heads=2,
    d_ff=8960, vocab=151936, tie_embeddings=True,
    norm="rms", act="swiglu",
)

deepseek_r1_7b = ArchConfig(
    name="deepseek-r1-7b", family="dense",     # Qwen2.5-7B distill
    n_layers=28, d_model=3584, n_heads=28, n_kv_heads=4,
    d_ff=18944, vocab=152064,
    norm="rms", act="swiglu",
)

deepseek_r1_8b = ArchConfig(
    name="deepseek-r1-8b", family="dense",     # Llama-3.1-8B distill
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8,
    d_ff=14336, vocab=128256,
    norm="rms", act="swiglu", rope_theta=500000.0,
)

qwen3_1_7b = ArchConfig(
    name="qwen3-1.7b", family="dense",
    n_layers=28, d_model=2048, n_heads=16, n_kv_heads=8, head_dim=128,
    d_ff=6144, vocab=151936, tie_embeddings=True,
    norm="rms", act="swiglu",
)

qwen3_4b = ArchConfig(
    name="qwen3-4b", family="dense",
    n_layers=36, d_model=2560, n_heads=32, n_kv_heads=8, head_dim=128,
    d_ff=9728, vocab=151936, tie_embeddings=True,
    norm="rms", act="swiglu",
)

qwen3_8b = ArchConfig(
    name="qwen3-8b", family="dense",
    n_layers=36, d_model=4096, n_heads=32, n_kv_heads=8, head_dim=128,
    d_ff=12288, vocab=151936,
    norm="rms", act="swiglu",
)

qwen25vl_3b = ArchConfig(
    name="qwen2.5vl-3b", family="vlm",
    n_layers=36, d_model=2048, n_heads=16, n_kv_heads=2,
    d_ff=11008, vocab=151936, tie_embeddings=True,
    frontend="vision", n_prefix_tokens=256,
    norm="rms", act="swiglu",
)

llama32_11b_v = ArchConfig(
    name="llama3.2-11b-v", family="vlm",
    n_layers=40, d_model=4096, n_heads=32, n_kv_heads=8,
    d_ff=14336, vocab=128256,
    frontend="vision", n_prefix_tokens=256,
    norm="rms", act="swiglu", rope_theta=500000.0,
)

# Embedding models (encoder-only; served for embeddings, no decode)
nomic_embed_text = ArchConfig(
    name="nomic-embed-text", family="embed",
    n_layers=12, d_model=768, n_heads=12, n_kv_heads=12,
    d_ff=3072, vocab=30528, tie_embeddings=True,
    norm="rms", act="gelu",
)

mxbai_embed_large = ArchConfig(
    name="mxbai-embed-large", family="embed",
    n_layers=24, d_model=1024, n_heads=16, n_kv_heads=16,
    d_ff=4096, vocab=30522, tie_embeddings=True,
    norm="rms", act="gelu",
)

ZOO = {c.name: c for c in [
    llama32_1b, llama32_3b, gemma3_1b, gemma3_4b,
    deepseek_r1_1_5b, deepseek_r1_7b, deepseek_r1_8b,
    qwen3_1_7b, qwen3_4b, qwen3_8b, qwen25vl_3b, llama32_11b_v,
    nomic_embed_text, mxbai_embed_large,
]}

# Paper Table 1: models per node class (node ids 1..6)
PAPER_NODE_MODELS = {
    1: ["deepseek-r1-1.5b", "deepseek-r1-7b", "deepseek-r1-8b",
        "qwen2.5vl-3b", "nomic-embed-text", "gemma3-1b", "gemma3-4b",
        "qwen3-1.7b", "qwen3-4b", "qwen3-8b", "llama3.2-1b", "llama3.2-3b",
        "mxbai-embed-large"],
    2: ["deepseek-r1-1.5b", "deepseek-r1-7b", "deepseek-r1-8b",
        "qwen2.5vl-3b", "nomic-embed-text", "gemma3-1b", "gemma3-4b",
        "qwen3-1.7b", "qwen3-4b", "qwen3-8b", "llama3.2-1b", "llama3.2-3b",
        "mxbai-embed-large"],
    3: ["deepseek-r1-1.5b", "deepseek-r1-7b", "llama3.2-1b", "llama3.2-3b",
        "mxbai-embed-large", "gemma3-1b", "qwen3-1.7b", "qwen3-4b",
        "nomic-embed-text"],
    4: ["deepseek-r1-1.5b", "deepseek-r1-7b", "deepseek-r1-8b",
        "qwen2.5vl-3b", "nomic-embed-text", "gemma3-1b", "gemma3-4b",
        "qwen3-1.7b", "qwen3-4b", "qwen3-8b", "llama3.2-1b", "llama3.2-3b",
        "mxbai-embed-large"],
    5: ["deepseek-r1-1.5b", "deepseek-r1-7b", "llama3.2-1b", "llama3.2-3b",
        "mxbai-embed-large", "gemma3-1b", "qwen3-1.7b", "qwen3-4b",
        "nomic-embed-text"],
    6: ["deepseek-r1-1.5b", "deepseek-r1-7b", "deepseek-r1-8b",
        "llama3.2-1b", "llama3.2-3b", "llama3.2-11b-v", "nomic-embed-text",
        "gemma3-1b", "gemma3-4b", "qwen3-1.7b", "qwen3-4b", "qwen3-8b",
        "qwen2.5vl-3b", "mxbai-embed-large"],
}
