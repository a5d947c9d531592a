"""Architecture & shape configuration system.

Every assigned architecture is expressed as an :class:`ArchConfig`.  The config
carries enough analytic structure (param counts, KV/state bytes) for the SDAI
controller's VRAM-aware placement (the paper's core mechanism) to reason about
memory *without* materializing weights.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

BYTES = {"bf16": 2, "f32": 4, "int8": 1, "int4": 0.5}


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    capacity_factor: float = 1.25
    # d_ff of each expert lives in ArchConfig.d_ff


@dataclasses.dataclass(frozen=True)
class EncDecConfig:
    """Encoder-decoder split (Seamless backbone).  n_layers is the *decoder*
    depth; the encoder takes enc_layers with the same width."""
    enc_layers: int
    # encoder input = precomputed frame embeddings (modality stub per spec)
    src_len_ratio: float = 1.0  # src_len = seq_len * ratio for shape specs


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                      # dense | moe | vlm | audio | ssm | hybrid
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0                # 0 -> d_model // n_heads
    moe: Optional[MoEConfig] = None
    encdec: Optional[EncDecConfig] = None
    swa_window: int = 0              # >0 -> sliding-window attention
    # hybrid/ssm
    block: str = "transformer"       # transformer | xlstm | hymba
    ssm_state: int = 0
    n_meta_tokens: int = 0           # hymba meta tokens
    global_attn_layers: Tuple[int, ...] = ()   # hymba: full-attn layer ids
    # frontend stubs ([vlm]/[audio]): number of prefix embedding positions
    frontend: str = ""               # "" | vision | audio
    n_prefix_tokens: int = 0
    # misc
    norm: str = "rms"                # rms | nonparam_ln
    act: str = "swiglu"              # swiglu | gelu
    rope_theta: float = 10000.0
    tie_embeddings: bool = False
    dtype: str = "bf16"

    # ------------------------------------------------------------------ #
    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)

    @property
    def subquadratic(self) -> bool:
        """Eligible for long_500k (sub-quadratic context scaling)."""
        return self.swa_window > 0 or self.block in ("xlstm", "hymba")

    @property
    def is_encdec(self) -> bool:
        return self.encdec is not None

    # ----------------------- analytic memory model -------------------- #
    def attn_params(self) -> int:
        hd = self.head_dim
        return self.d_model * hd * (self.n_heads + 2 * self.n_kv_heads) \
            + self.n_heads * hd * self.d_model

    def ffn_params(self) -> int:
        mult = 2 if self.act == "swiglu" else 1
        if self.moe:
            router = self.d_model * self.moe.num_experts
            return router + self.moe.num_experts * (
                mult * self.d_model * self.d_ff + self.d_ff * self.d_model)
        if self.d_ff == 0:
            return 0
        return mult * self.d_model * self.d_ff + self.d_ff * self.d_model

    def layer_params(self) -> int:
        if self.block == "xlstm":
            # mLSTM block (up 2x, qkv on inner, gates, down) + sLSTM block
            inner = 2 * self.d_model
            mlstm = self.d_model * inner * 2 + inner * 3 * inner // 2 \
                + inner * self.d_model
            slstm = 4 * self.d_model * self.d_model \
                + int(2 * (4 / 3) * self.d_model * self.d_model)
            return (mlstm + slstm) // 2 + 2 * self.d_model  # per layer avg
        p = self.attn_params() + self.ffn_params() + 2 * self.d_model
        if self.block == "hymba":
            inner = self.n_heads * self.head_dim
            p += self.d_model * inner * 2 + inner * self.ssm_state * 2 \
                + inner  # ssm branch in/out + B,C proj + dt
        return p

    def num_params(self) -> int:
        """Total parameters (both stacks for enc-dec; embeddings counted)."""
        emb = self.vocab * self.d_model
        head = 0 if self.tie_embeddings else self.vocab * self.d_model
        layers = self.n_layers
        cross = 0
        if self.encdec:
            layers += self.encdec.enc_layers
            cross = self.n_layers * (self.attn_params() + self.d_model)
        return emb + head + layers * self.layer_params() + cross \
            + self.d_model

    def active_params(self) -> int:
        """Active params per token (MoE: only top-k experts count)."""
        if not self.moe:
            return self.num_params()
        mult = 2 if self.act == "swiglu" else 1
        per_expert = mult * self.d_model * self.d_ff + self.d_ff * self.d_model
        inactive = (self.moe.num_experts - self.moe.top_k) * per_expert
        return self.num_params() - self.n_layers * inactive

    def param_bytes(self, dtype: str = "") -> int:
        return int(self.num_params() * BYTES[dtype or self.dtype])

    def kv_bytes_per_token(self, dtype: str = "") -> float:
        """KV-cache (or recurrent state amortization) bytes per cached token
        per sequence — what placement charges for a serving slot."""
        b = BYTES[dtype or self.dtype]
        if self.block == "xlstm":
            return 0.0  # O(1) state, charged via state_bytes()
        per_layer = 2 * self.n_kv_heads * self.head_dim * b
        n_attn_layers = self.n_layers
        return per_layer * n_attn_layers

    def state_bytes(self, batch: int = 1, dtype: str = "") -> int:
        """O(1) recurrent state bytes (ssm / hybrid branches)."""
        b = BYTES[dtype or self.dtype]
        if self.block == "xlstm":
            inner = 2 * self.d_model
            hd = inner // self.n_heads
            per = self.n_heads * (hd * hd + 2 * hd) + 4 * self.d_model
            return int(batch * (self.n_layers // 2 + 1) * 2 * per * b)
        if self.block == "hymba":
            inner = self.n_heads * self.head_dim
            return int(batch * self.n_layers * inner * self.ssm_state * b)
        return 0

    def cache_bytes(self, batch: int, seq_len: int, dtype: str = "") -> int:
        """Total serving-cache bytes for `batch` sequences of `seq_len`."""
        eff = seq_len if self.swa_window == 0 else min(seq_len, self.swa_window)
        total = batch * eff * self.kv_bytes_per_token(dtype)
        if self.encdec:  # cross-attn KV over encoder output
            src = int(seq_len * self.encdec.src_len_ratio)
            total += batch * src * 2 * self.n_kv_heads * self.head_dim \
                * BYTES[dtype or self.dtype] * self.n_layers
        return int(total + self.state_bytes(batch, dtype))

    def flops_per_token(self, seq_len: int = 0) -> float:
        """~6*N_active per trained token (+ attention term when seq given)."""
        f = 6.0 * self.active_params()
        if seq_len:
            f += 12.0 * self.n_layers * self.n_heads * self.head_dim * \
                (min(seq_len, self.swa_window) if self.swa_window else seq_len)
        return f

    # ------------------------------------------------------------------ #
    def reduced(self, **over) -> "ArchConfig":
        """Tiny same-family config for CPU smoke tests."""
        kw = dataclasses.asdict(self)
        # dataclasses.asdict recurses; rebuild nested configs
        if self.moe:
            kw["moe"] = MoEConfig(num_experts=min(self.moe.num_experts, 4),
                                  top_k=min(self.moe.top_k, 2))
        if self.encdec:
            kw["encdec"] = EncDecConfig(enc_layers=2)
        hd = 8
        n_heads = min(self.n_heads, 4)
        n_kv = max(1, min(self.n_kv_heads, n_heads))
        while n_heads % n_kv:
            n_kv -= 1
        kw.update(dict(
            name=self.name + "-reduced",
            n_layers=min(self.n_layers, 4) if self.block != "xlstm" else 2,
            d_model=n_heads * hd * 2,
            n_heads=n_heads, n_kv_heads=n_kv, head_dim=hd * 2,
            d_ff=0 if self.d_ff == 0 else 64,
            vocab=256,
            swa_window=min(self.swa_window, 16) if self.swa_window else 0,
            n_prefix_tokens=min(self.n_prefix_tokens, 4),
            n_meta_tokens=min(self.n_meta_tokens, 2),
            global_attn_layers=tuple(
                i for i in self.global_attn_layers if i < 4),
            ssm_state=min(self.ssm_state, 4) if self.ssm_state else 0,
        ))
        kw.update(over)
        return ArchConfig(**kw)


# --------------------------------------------------------------------- #
@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str        # train | prefill | decode
    seq_len: int
    batch: int

    def tokens(self) -> int:
        return self.seq_len * self.batch


SHAPES = {
    "train_4k":    ShapeSpec("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32768, 32),
    "decode_32k":  ShapeSpec("decode_32k", "decode", 32768, 128),
    "long_500k":   ShapeSpec("long_500k", "decode", 524288, 1),
}


def runnable(cfg: ArchConfig, shape: ShapeSpec) -> Tuple[bool, str]:
    """Is this (arch x shape) cell runnable?  Returns (ok, reason)."""
    if shape.name == "long_500k" and not cfg.subquadratic:
        return False, ("full-attention arch: 500k context is O(L^2) prefill / "
                       "unbounded KV; skipped per spec (see DESIGN.md)")
    return True, ""
