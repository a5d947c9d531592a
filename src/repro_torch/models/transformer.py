"""Dense causal decoder: full-sequence forward, bucketed prefill, and one
decode step straight against the paged KV pool.

The counterpart of the dense causal subset of `repro.models.transformer`,
with the same stacked `(L, ...)` params (see `repro_torch.params`) and
the same layouts at every public function.  Where JAX scans over layers,
this loops over them in Python.  Prefill attention runs the flash kernel
(`kernels.ops.flash_attention`), decode attention the paged decode
kernel (`kernels.ops.paged_decode_attention`); on CPU tensors both take
their plain versions.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ops as kernel_ops
from repro_torch.models import attention as attn_lib
from repro_torch.models import layers as L
from repro_torch.params import Params, require_dense_causal

Cache = Dict[str, torch.Tensor]


def _layer(params: Params, i: int) -> Params:
    lp = params["layers"]
    out = {"attn": {k: v[i] for k, v in lp["attn"].items()},
           "mlp": {k: v[i] for k, v in lp["mlp"].items()}}
    for name in ("ln1", "ln2"):
        if name in lp:
            out[name] = lp[name][i]
    return out


def _head(params: Params, cfg: ArchConfig) -> torch.Tensor:
    """(d, V) LM head: the tied embedding's transpose, or lm_head."""
    return params["embed"].t() if cfg.tie_embeddings else params["lm_head"]


def _project(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum("bsd,dhk->bshk") as one matmul."""
    d, h, hd = w.shape
    return (x @ w.reshape(d, h * hd)).reshape(*x.shape[:-1], h, hd)


def _out_project(a: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    """einsum("bshk,hkd->bsd") as one matmul."""
    h, hd, d = wo.shape
    return a.reshape(*a.shape[:-2], h * hd) @ wo.reshape(h * hd, d)


def _ffn(lp: Params, x: torch.Tensor) -> torch.Tensor:
    return L.mlp_apply(x, lp["mlp"]["wi"], lp["mlp"]["wo"])


def _attention_block(lp: Params, cfg: ArchConfig, x: torch.Tensor, *,
                     impl: str) -> Tuple[torch.Tensor, Tuple]:
    """Causal self-attention over a full sequence from position 0.
    Returns (out (B, S, H, hd), (k, v) each (B, S, K, hd))."""
    q = _project(x, lp["attn"]["wq"])
    k = _project(x, lp["attn"]["wk"])
    v = _project(x, lp["attn"]["wv"])
    cos, sin = L.rope_cos_sin(torch.arange(x.shape[1], device=x.device),
                              cfg.head_dim, cfg.rope_theta)
    q = L.apply_rope(q, cos, sin)
    k = L.apply_rope(k, cos, sin)
    if impl == "full":
        out = attn_lib.full_attention(q, k, v, causal=True)
    else:
        # the flash kernel takes heads-major (B, H, S, hd)
        out = kernel_ops.flash_attention(
            q.transpose(1, 2).contiguous(), k.transpose(1, 2).contiguous(),
            v.transpose(1, 2).contiguous(), causal=True).transpose(1, 2)
    return out, (k, v)


def _decoder_layer(lp: Params, cfg: ArchConfig, h: torch.Tensor, *,
                   impl: str) -> Tuple[torch.Tensor, Tuple]:
    x = L.norm(h, lp.get("ln1"), cfg.norm)
    a_out, kv = _attention_block(lp, cfg, x, impl=impl)
    h = h + _out_project(a_out, lp["attn"]["wo"])
    x = L.norm(h, lp.get("ln2"), cfg.norm)
    return h + _ffn(lp, x), kv


def _trunk(params: Params, cfg: ArchConfig, tokens: torch.Tensor, *,
           impl: str) -> Tuple[torch.Tensor, Cache]:
    """Embedding, every layer and the final norm.  Returns (h (B, S, D),
    {"k", "v": (L, B, S, K, hd)})."""
    require_dense_causal(cfg)
    if impl not in ("flash", "full"):
        raise ValueError(f"impl must be 'flash' or 'full', not {impl!r}")
    h = params["embed"][tokens]
    ks, vs = [], []
    for i in range(cfg.n_layers):
        h, (k, v) = _decoder_layer(_layer(params, i), cfg, h, impl=impl)
        ks.append(k)
        vs.append(v)
    h = L.norm(h, params.get("final_norm"), cfg.norm)
    return h, {"k": torch.stack(ks), "v": torch.stack(vs)}


def forward(params: Params, cfg: ArchConfig, tokens: torch.Tensor, *,
            impl: str = "flash") -> torch.Tensor:
    """Full-sequence logits (B, S, V).  impl="flash" runs prefill's flash
    attention; impl="full" the plain reference attention (the no-cache
    recompute oracle)."""
    h, _ = _trunk(params, cfg, tokens, impl=impl)
    return h @ _head(params, cfg)


def prefill(params: Params, cfg: ArchConfig, tokens: torch.Tensor, *,
            lengths: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, Cache, torch.Tensor]:
    """Forward a right-padded batch through the flash attention kernel and
    return (last_logits (B, V), cache {"k", "v": (L, B, S, K, hd)}, pos
    (B,) int32).

    lengths: (B,) valid token counts; each row's logits and `pos` come
    from its own last real token (padded positions sit past `pos` and
    are masked out of every later decode read).  Only the last hidden row
    of each sequence meets the LM head — the same logits as JAX's
    full-sequence head, without a (B, S, V) tensor.
    """
    h, cache = _trunk(params, cfg, tokens, impl="flash")
    b, s = tokens.shape
    if lengths is None:
        pos = torch.full((b,), s - 1, dtype=torch.int32, device=h.device)
    else:
        pos = (lengths.to(h.device) - 1).to(torch.int32)
    last = h[torch.arange(b, device=h.device), pos.long()]      # (B, D)
    return last @ _head(params, cfg), cache, pos


# --------------------------------------------------------------------- #
# paged decode

def _paged_write(pool: torch.Tensor, new_kv: torch.Tensor,
                 write_table: torch.Tensor, w_pos: torch.Tensor) -> None:
    """Write one token's KV per row into the page pool through the write
    table, in place.  pool (n_pages + 1, ps, K, hd), its last page the
    scratch page; new_kv (B, K, hd); w_pos (B,).

    Rows whose position is unmapped or cache-shared (the sentinel n_pages
    in the write table) or past the table drop, as JAX's mode="drop"
    scatter does: torch has no dropping scatter and a boolean mask would
    sync with the host, so they write into the scratch page, which no
    read ever reaches."""
    scratch, ps = pool.shape[0] - 1, pool.shape[1]
    pps = write_table.shape[1]
    flat = pool.view(-1, *pool.shape[2:])
    w_pos = w_pos.long()
    slot_page = w_pos // ps
    pid = write_table.gather(1, slot_page.clamp(max=pps - 1)[:, None])[:, 0]
    pid = torch.where(slot_page < pps, pid.long(), scratch)
    flat[pid * ps + w_pos % ps] = new_kv.to(pool.dtype)


def decode_step_paged(params: Params, cfg: ArchConfig, cache: Cache,
                      token: torch.Tensor, pos: torch.Tensor,
                      page_table: torch.Tensor, write_table: torch.Tensor
                      ) -> Tuple[torch.Tensor, Cache]:
    """One decode step against the paged pool.  token/pos: (B,) int32, pos
    the position of the new token; page_table/write_table: (B, pps) int32,
    sentinel == n_pages; cache {"k", "v": (L, n_pages + 1, ps, K, hd)},
    whose last page is the scratch page that dropped writes land in.
    Attention reads only the first n_pages.

    The new KV is written into the pools in place — the counterpart of
    JAX donating the cache buffers — and `cache` is returned as is.
    Returns (logits (B, V), cache)."""
    require_dense_causal(cfg)
    b = token.shape[0]
    nkv, hd = cfg.n_kv_heads, cfg.head_dim
    h = params["embed"][token][:, None]                         # (B,1,D)
    cos, sin = L.rope_cos_sin(pos[:, None], hd, cfg.rope_theta)
    for i in range(cfg.n_layers):
        lp = _layer(params, i)
        kc, vc = cache["k"][i], cache["v"][i]                   # (P,ps,K,hd)
        x = L.norm(h, lp.get("ln1"), cfg.norm)
        q = L.apply_rope(_project(x, lp["attn"]["wq"]), cos, sin)
        k_new = L.apply_rope(_project(x, lp["attn"]["wk"]), cos, sin)
        v_new = _project(x, lp["attn"]["wv"])
        _paged_write(kc, k_new[:, 0], write_table, pos)
        _paged_write(vc, v_new[:, 0], write_table, pos)
        qf = q[:, 0].reshape(b, nkv, q.shape[2] // nkv, hd)     # kv-major
        a_out = kernel_ops.paged_decode_attention(qf, kc[:-1], vc[:-1],
                                                  page_table, pos)
        h = h + _out_project(a_out.reshape(b, 1, q.shape[2], hd),
                             lp["attn"]["wo"])
        x = L.norm(h, lp.get("ln2"), cfg.norm)
        h = h + _ffn(lp, x)
    h = L.norm(h, params.get("final_norm"), cfg.norm)
    return (h @ _head(params, cfg))[:, 0], cache
