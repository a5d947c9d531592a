"""Causal decoder: full-sequence forward, bucketed prefill, the
prefix-cache suffix prefill, one decode step against a contiguous cache
or straight against the paged KV pool, and the speculative verify
against the paged pool.

The counterpart of the causal decoder subset of
`repro.models.transformer`, with the same stacked `(L, ...)` params (see
`repro_torch.params`) and the same layouts at every public function: a
SwiGLU or gelu FFN, dense or Mixture-of-Experts (`models.moe`, whose
capacity comes from the sequence length each entry point feeds it), a
sliding window (`cfg.swa_window`, the same in every layer, as JAX's
non-hymba path) and a vision frontend's prefix tokens (`prefix_embeds`
(B, n_prefix_tokens, D) ahead of the prompt, exempt from the window but
not from causality; RoPE positions count them).  Where JAX scans over layers,
this loops over them in Python.  Prefill attention runs the flash kernel
(`kernels.ops.flash_attention`); decode attention runs the decode kernel
over a contiguous cache (`decode_step`, `kernels.ops.decode_attention`)
or the paged decode kernel through the page table (`decode_step_paged`,
`kernels.ops.paged_decode_attention`).  On CPU tensors every kernel
takes its plain version.  The suffix prefill (`prefill_suffix`) and the
speculative verify (`spec_verify_paged`) attend in plain PyTorch on
every device, as JAX's are jnp on every backend.

Under quantize="int8" the params come from
`serving.quantization.int8_operands`: each matmul weight is a dict leaf
`{"__q__": int8 q, "col": per-column f32 scale, ...}` and every linear
layer, and the tied LM head, runs `kernels.ops.int8_matmul` on it.  The
embedding lookup dequantizes only the gathered rows, which equals JAX's
dequantize-then-take element for element.  The MoE experts' int8 leaves
(no "col") are dequantized one layer at a time where the layer runs, to
the values of JAX's per-step `dequant_tree`; their products stay
batched einsums, as in JAX.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.device import torch_dtype
from repro_torch.kernels import ops as kernel_ops
from repro_torch.models import attention as attn_lib
from repro_torch.models import layers as L
from repro_torch.models import moe as moe_lib
from repro_torch.params import Params, require_causal_decoder

Cache = Dict[str, torch.Tensor]


# A weight is a dense tensor or an int8 leaf (a dict, see the docstring);
# these three act on either.

def _index(w, i):
    if isinstance(w, dict):         # the scales are shared by all layers
        return {**w, "__q__": w["__q__"][i]}
    return w[i]


def _reshape(w, *shape):
    if isinstance(w, dict):
        return {**w, "__q__": w["__q__"].reshape(*shape)}
    return w.reshape(*shape)


def _matmul(x: torch.Tensor, w) -> torch.Tensor:
    """x (..., K) @ w (K, N)."""
    if not isinstance(w, dict):
        return x @ w
    out = kernel_ops.int8_matmul(x.reshape(-1, x.shape[-1]).contiguous(),
                                 w["__q__"], w["col"])
    return out.reshape(*x.shape[:-1], out.shape[-1])


def _dense(w) -> torch.Tensor:
    """A weight as a dense tensor: an int8 leaf of one layer (its `q`
    indexed along L, its scale still the stacked leaf's) dequantized to
    what `quantization.dequantize_array` gives that layer."""
    if not isinstance(w, dict):
        return w
    return (w["__q__"] * w["scale"][0]).to(w["dtype"])


def _layer(params: Params, i: int) -> Params:
    lp = params["layers"]
    ffn = "moe" if "moe" in lp else "mlp"
    out = {"attn": {k: _index(v, i) for k, v in lp["attn"].items()},
           ffn: {k: _index(v, i) for k, v in lp[ffn].items()}}
    for name in ("ln1", "ln2"):
        if name in lp:
            out[name] = lp[name][i]
    return out


def _embed(params: Params, tokens: torch.Tensor) -> torch.Tensor:
    e = params["embed"]
    if isinstance(e, dict):
        return (e["__q__"][tokens].float() * e["scale"]).to(e["dtype"])
    return e[tokens]


def _logits(params: Params, cfg: ArchConfig, h: torch.Tensor
            ) -> torch.Tensor:
    """h (..., d) through the LM head: the tied embedding's transpose, or
    lm_head.  The int8 tied head multiplies the strided (d, V) view of
    the int8 embedding with its per-d scale as a (d, 1) per-K scale: no
    transposed or dequantized copy of the embedding exists."""
    if not cfg.tie_embeddings:
        return _matmul(h, params["lm_head"])
    e = params["embed"]
    if isinstance(e, dict):
        return _matmul(h, {"__q__": e["__q__"].t(), "col": e["col"].t()})
    return h @ e.t()


def _project(x: torch.Tensor, w) -> torch.Tensor:
    """einsum("bsd,dhk->bshk") as one matmul."""
    d, h, hd = (w["__q__"] if isinstance(w, dict) else w).shape
    return _matmul(x, _reshape(w, d, h * hd)).reshape(*x.shape[:-1], h, hd)


def _out_project(a: torch.Tensor, wo) -> torch.Tensor:
    """einsum("bshk,hkd->bsd") as one matmul."""
    h, hd, d = (wo["__q__"] if isinstance(wo, dict) else wo).shape
    return _matmul(a.reshape(*a.shape[:-2], h * hd),
                   _reshape(wo, h * hd, d))


def _ffn(lp: Params, cfg: ArchConfig, x: torch.Tensor) -> torch.Tensor:
    """The FFN: SwiGLU (wi (2, d, f)) or gelu (wi (d, f)), or the MoE
    FFN over x's own sequence length (its aux loss dropped, as on JAX's
    serving paths)."""
    if cfg.moe is not None:
        mp = lp["moe"]
        return moe_lib.moe_ffn(x, mp["router"], _dense(mp["wi"]),
                               _dense(mp["wo"]), cfg.moe, cfg.act)[0]
    wi, wo = lp["mlp"]["wi"], lp["mlp"]["wo"]
    if not isinstance(wi, dict):
        return L.mlp_apply(x, wi, wo, cfg.act)
    if cfg.act == "swiglu":
        return _matmul(L.swiglu(_matmul(x, _index(wi, 0)),
                                _matmul(x, _index(wi, 1))), wo)
    return _matmul(L.gelu(_matmul(x, wi)), wo)


def zero_prefix_embeds(cfg: ArchConfig, batch: int,
                       device: torch.device) -> Optional[torch.Tensor]:
    """The prefix the engine feeds a vision model, as JAX's engine does
    (`_extra_inputs`): zeros (B, n_prefix_tokens, D) in the model dtype;
    None for a model without a frontend."""
    if cfg.frontend != "vision":
        return None
    return torch.zeros((batch, cfg.n_prefix_tokens, cfg.d_model),
                       dtype=torch_dtype(cfg.dtype), device=device)


def _embed_inputs(params: Params, tokens: torch.Tensor,
                  prefix_embeds: Optional[torch.Tensor]
                  ) -> Tuple[torch.Tensor, int]:
    """(h (B, prefix + S, D), prefix): the prefix embeddings ahead of the
    token embeddings."""
    h = _embed(params, tokens)
    if prefix_embeds is None:
        return h, 0
    return (torch.cat([prefix_embeds.to(h.dtype), h], dim=1),
            prefix_embeds.shape[1])


def _attention_block(lp: Params, cfg: ArchConfig, x: torch.Tensor, *,
                     impl: str, prefix: int) -> Tuple[torch.Tensor, Tuple]:
    """Causal self-attention over a full sequence from position 0, with
    the config's window; the first `prefix` positions are exempt from it.
    Returns (out (B, S, H, hd), (k, v) each (B, S, K, hd))."""
    q = _project(x, lp["attn"]["wq"])
    k = _project(x, lp["attn"]["wk"])
    v = _project(x, lp["attn"]["wv"])
    cos, sin = L.rope_cos_sin(torch.arange(x.shape[1], device=x.device),
                              cfg.head_dim, cfg.rope_theta)
    q = L.apply_rope(q, cos, sin)
    k = L.apply_rope(k, cos, sin)
    window = cfg.swa_window
    if impl == "full":
        out = attn_lib.full_attention(q, k, v, causal=True, window=window,
                                      prefix=prefix)
    else:
        # the flash kernel takes the heads-major (B, H, S, hd) views in
        # place and writes a (B, S, H, hd) buffer: no layout copies
        out = kernel_ops.flash_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            causal=True, window=window, prefix=prefix).transpose(1, 2)
    return out, (k, v)


def _decoder_layer(lp: Params, cfg: ArchConfig, h: torch.Tensor, *,
                   impl: str, prefix: int) -> Tuple[torch.Tensor, Tuple]:
    x = L.norm(h, lp.get("ln1"), cfg.norm)
    a_out, kv = _attention_block(lp, cfg, x, impl=impl, prefix=prefix)
    h = h + _out_project(a_out, lp["attn"]["wo"])
    x = L.norm(h, lp.get("ln2"), cfg.norm)
    return h + _ffn(lp, cfg, x), kv


def _trunk(params: Params, cfg: ArchConfig, tokens: torch.Tensor, *,
           impl: str, prefix_embeds: Optional[torch.Tensor]
           ) -> Tuple[torch.Tensor, Cache, int]:
    """Embedding (the prefix embeddings first), every layer and the final
    norm.  Returns (h (B, P + S, D), {"k", "v": (L, B, P + S, K, hd)},
    P), P the prefix length."""
    require_causal_decoder(cfg)
    if impl not in ("flash", "full"):
        raise ValueError(f"impl must be 'flash' or 'full', not {impl!r}")
    h, prefix = _embed_inputs(params, tokens, prefix_embeds)
    ks, vs = [], []
    for i in range(cfg.n_layers):
        h, (k, v) = _decoder_layer(_layer(params, i), cfg, h, impl=impl,
                                   prefix=prefix)
        ks.append(k)
        vs.append(v)
    h = L.norm(h, params.get("final_norm"), cfg.norm)
    return h, {"k": torch.stack(ks), "v": torch.stack(vs)}, prefix


def forward(params: Params, cfg: ArchConfig, tokens: torch.Tensor, *,
            impl: str = "flash",
            prefix_embeds: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Full-sequence logits (B, P + S, V), P = prefix_embeds.shape[1] (0
    without them), as JAX's forward.  impl="flash" runs prefill's flash
    attention; impl="full" the plain reference attention (the no-cache
    recompute oracle).  The engine feeds a vision model
    `zero_prefix_embeds`; a recompute that stands for the engine passes
    the same."""
    h, _, _ = _trunk(params, cfg, tokens, impl=impl,
                     prefix_embeds=prefix_embeds)
    return _logits(params, cfg, h)


def prefill(params: Params, cfg: ArchConfig, tokens: torch.Tensor, *,
            lengths: Optional[torch.Tensor] = None,
            prefix_embeds: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, Cache, torch.Tensor]:
    """Forward a right-padded batch through the flash attention kernel and
    return (last_logits (B, V), cache {"k", "v": (L, B, P + S, K, hd)},
    pos (B,) int32), P the prefix embeddings' length (0 without them).

    lengths: (B,) valid token counts; each row's logits and `pos` come
    from its own last real token, pos = P + lengths - 1 (padded positions
    sit past `pos` and are masked out of every later decode read).  Only
    the last hidden row of each sequence meets the LM head — the same
    logits as JAX's full-sequence head, without a (B, S, V) tensor.
    """
    h, cache, prefix = _trunk(params, cfg, tokens, impl="flash",
                              prefix_embeds=prefix_embeds)
    b, s_tot = h.shape[:2]
    if lengths is None:
        pos = torch.full((b,), s_tot - 1, dtype=torch.int32,
                         device=h.device)
    else:
        pos = (prefix + lengths.to(h.device) - 1).to(torch.int32)
    last = h[torch.arange(b, device=h.device), pos.long()]      # (B, D)
    return _logits(params, cfg, last), cache, pos


def _plain_causal_only(cfg: ArchConfig, name: str) -> None:
    require_causal_decoder(cfg)
    if cfg.swa_window or cfg.n_prefix_tokens:
        raise NotImplementedError(
            f"{name} supports plain causal decoders only (no window, no "
            f"prefix tokens)")


def _land_suffix(cache: torch.Tensor, new: torch.Tensor,
                 offsets: torch.Tensor) -> None:
    """Write a suffix block new (B, S_new, K, hd) into cache (B, S, K, hd)
    at each row's positions offsets[b] + j, in place; positions past S
    drop, as JAX's per-row mode="drop" scatter.  Done as a gather: each
    cache position takes the one suffix token aimed at it (or keeps its
    value), so no two writes ever meet."""
    b, s = cache.shape[:2]
    j = torch.arange(s, device=cache.device)[None, :] \
        - offsets.long()[:, None]                               # (B, S)
    hit = (j >= 0) & (j < new.shape[1])
    src = new.gather(1, j.clamp(0, new.shape[1] - 1)[:, :, None, None]
                     .expand(-1, -1, *new.shape[2:]))
    cache.copy_(torch.where(hit[:, :, None, None], src.to(cache.dtype),
                            cache))


def prefill_suffix(params: Params, cfg: ArchConfig, cache: Cache,
                   tokens: torch.Tensor, offsets: torch.Tensor,
                   lengths: torch.Tensor
                   ) -> Tuple[torch.Tensor, Cache, torch.Tensor]:
    """Extend per-row caches with a batch of suffix tokens in one pass —
    the prefix-cache admission.  Rows arrive with `offsets` (B,) cache
    positions valid already (the shared cached prefix), `tokens` (B, S)
    right-padded suffix ids and `lengths` (B,) valid suffix counts
    (>= 1); cache {"k", "v": (L, B, S_view, K, hd)} is the rows' logical
    views, written in place at positions offsets + j (past S_view they
    drop; padding lands past `pos`, where every later read masks it).
    Attention is `attention.suffix_attention`, causal by absolute
    position, in plain PyTorch as in JAX.  Returns (last_logits (B, V),
    cache, pos (B,) = offsets + lengths - 1).  A window or prefix tokens
    change visibility the pass does not rebuild: refused, as in JAX (the
    engine turns the prefix cache off for them)."""
    _plain_causal_only(cfg, "prefill_suffix")
    b, s = tokens.shape
    offsets = offsets.to(tokens.device)
    lengths = lengths.to(tokens.device)
    q_pos = offsets.long()[:, None] + torch.arange(s, device=tokens.device)
    cos, sin = L.rope_cos_sin(q_pos, cfg.head_dim, cfg.rope_theta)
    h = _embed(params, tokens)                                  # (B,S,D)
    for i in range(cfg.n_layers):
        lp = _layer(params, i)
        kc, vc = cache["k"][i], cache["v"][i]                   # (B,S',K,hd)
        x = L.norm(h, lp.get("ln1"), cfg.norm)
        q = L.apply_rope(_project(x, lp["attn"]["wq"]), cos, sin)
        k_new = L.apply_rope(_project(x, lp["attn"]["wk"]), cos, sin)
        v_new = _project(x, lp["attn"]["wv"])
        _land_suffix(kc, k_new, offsets)
        _land_suffix(vc, v_new, offsets)
        a_out = attn_lib.suffix_attention(q, kc, vc, q_pos)
        h = h + _out_project(a_out, lp["attn"]["wo"])
        x = L.norm(h, lp.get("ln2"), cfg.norm)
        h = h + _ffn(lp, cfg, x)
    h = L.norm(h, params.get("final_norm"), cfg.norm)
    last_idx = (lengths.long() - 1).clamp(0, s - 1)
    last = h[torch.arange(b, device=h.device), last_idx]        # (B, D)
    pos = (offsets + lengths - 1).to(torch.int32)
    return _logits(params, cfg, last), cache, pos


# --------------------------------------------------------------------- #
# decode

def decode_step(params: Params, cfg: ArchConfig, cache: Cache,
                token: torch.Tensor, pos: torch.Tensor
                ) -> Tuple[torch.Tensor, Cache]:
    """One decode step against a contiguous cache {"k", "v": (L, B, S, K,
    hd)}: the engine's per-slot strips (`paged=False`) or the logical
    view gathered out of the page pool (the gather mode).  token/pos:
    (B,) int32, pos the position of the new token.

    The new KV is written at `pos` in place — the counterpart of JAX
    donating the cache — and `cache` is returned as is.  A write at
    pos >= S (a finished slot whose pos froze at max_len) lands at S - 1,
    as JAX's clamped dynamic_update_slice does.  Attention reads the
    (B, K, S, hd) permuted view of each layer's cache in place, with the
    config's window; the cache's first n_prefix_tokens positions are
    exempt from it.  Returns (logits (B, V), cache)."""
    require_causal_decoder(cfg)
    b = token.shape[0]
    nkv, hd = cfg.n_kv_heads, cfg.head_dim
    rows = torch.arange(b, device=token.device)
    w_pos = pos.long().clamp(0, cache["k"].shape[2] - 1)
    h = _embed(params, token)[:, None]                          # (B,1,D)
    cos, sin = L.rope_cos_sin(pos[:, None], hd, cfg.rope_theta)
    for i in range(cfg.n_layers):
        lp = _layer(params, i)
        kc, vc = cache["k"][i], cache["v"][i]                   # (B,S,K,hd)
        x = L.norm(h, lp.get("ln1"), cfg.norm)
        q = L.apply_rope(_project(x, lp["attn"]["wq"]), cos, sin)
        k_new = L.apply_rope(_project(x, lp["attn"]["wk"]), cos, sin)
        v_new = _project(x, lp["attn"]["wv"])
        kc[rows, w_pos] = k_new[:, 0].to(kc.dtype)
        vc[rows, w_pos] = v_new[:, 0].to(vc.dtype)
        qf = q[:, 0].reshape(b, nkv, q.shape[2] // nkv, hd)     # kv-major
        a_out = kernel_ops.decode_attention(
            qf, kc.permute(0, 2, 1, 3), vc.permute(0, 2, 1, 3), pos,
            window=cfg.swa_window, prefix=cfg.n_prefix_tokens)
        h = h + _out_project(a_out.reshape(b, 1, q.shape[2], hd),
                             lp["attn"]["wo"])
        x = L.norm(h, lp.get("ln2"), cfg.norm)
        h = h + _ffn(lp, cfg, x)
    h = L.norm(h, params.get("final_norm"), cfg.norm)
    return _logits(params, cfg, h)[:, 0], cache


def _paged_write(pool: torch.Tensor, new_kv: torch.Tensor,
                 write_table: torch.Tensor, w_pos: torch.Tensor) -> None:
    """Write KV per row into the page pool through the write table, in
    place.  pool (n_pages + 1, ps, K, hd), its last page the scratch
    page; new_kv (B, ..., K, hd) at absolute positions w_pos (B, ...): one
    token a row in decode, Q in the speculative verify.

    Positions that are unmapped or cache-shared (the sentinel n_pages in
    the write table) or past the table drop, as JAX's mode="drop" scatter
    does: torch has no dropping scatter and a boolean mask would sync
    with the host, so they write into the scratch page, which no read
    ever reaches."""
    scratch, ps = pool.shape[0] - 1, pool.shape[1]
    b, pps = write_table.shape
    flat = pool.view(-1, *pool.shape[2:])
    w_pos = w_pos.long()
    slot_page = w_pos // ps
    pid = write_table.gather(1, slot_page.clamp(max=pps - 1).reshape(b, -1))
    pid = torch.where(slot_page < pps, pid.reshape(slot_page.shape).long(),
                      scratch)
    flat[pid * ps + w_pos % ps] = new_kv.to(pool.dtype)


def decode_step_paged(params: Params, cfg: ArchConfig, cache: Cache,
                      token: torch.Tensor, pos: torch.Tensor,
                      page_table: torch.Tensor, write_table: torch.Tensor
                      ) -> Tuple[torch.Tensor, Cache]:
    """One decode step against the paged pool.  token/pos: (B,) int32, pos
    the position of the new token; page_table/write_table: (B, pps) int32,
    sentinel == n_pages; cache {"k", "v": (L, n_pages + 1, ps, K, hd)},
    whose last page is the scratch page that dropped writes land in.
    Attention reads only the first n_pages, with the config's window and
    prefix, as `decode_step`.

    The new KV is written into the pools in place — the counterpart of
    JAX donating the cache buffers — and `cache` is returned as is.
    Returns (logits (B, V), cache)."""
    require_causal_decoder(cfg)
    b = token.shape[0]
    nkv, hd = cfg.n_kv_heads, cfg.head_dim
    h = _embed(params, token)[:, None]                          # (B,1,D)
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
        a_out = kernel_ops.paged_decode_attention(
            qf, kc[:-1], vc[:-1], page_table, pos, window=cfg.swa_window,
            prefix=cfg.n_prefix_tokens)
        h = h + _out_project(a_out.reshape(b, 1, q.shape[2], hd),
                             lp["attn"]["wo"])
        x = L.norm(h, lp.get("ln2"), cfg.norm)
        h = h + _ffn(lp, cfg, x)
    h = L.norm(h, params.get("final_norm"), cfg.norm)
    return _logits(params, cfg, h)[:, 0], cache


def spec_verify_paged(params: Params, cfg: ArchConfig, cache: Cache,
                      tokens: torch.Tensor, pos: torch.Tensor,
                      page_table: torch.Tensor, write_table: torch.Tensor
                      ) -> Tuple[torch.Tensor, Cache]:
    """The speculative verify: Q = 1 + n_draft tokens a row in one forward
    against the paged pool, causal by absolute position — the multi-token
    form of `decode_step_paged`.  tokens (B, Q): the last accepted token
    and the draft chain; pos (B,): the position of tokens[:, 0].  KV of
    every fed position is written through the write table in place
    (rejected drafts leave KV past the accepted position, masked by
    causality and overwritten when decoding resumes there); attention is
    `kernels.ops.paged_suffix_attention`, plain PyTorch on every device as
    in JAX.  Plain causal decoders only (no window, no prefix tokens), as
    in JAX.  Returns (logits (B, Q, V), cache)."""
    _plain_causal_only(cfg, "spec_verify_paged")
    b, qn = tokens.shape
    q_pos = pos.long()[:, None] + torch.arange(qn, device=tokens.device)
    cos, sin = L.rope_cos_sin(q_pos, cfg.head_dim, cfg.rope_theta)
    h = _embed(params, tokens)                                  # (B,Q,D)
    for i in range(cfg.n_layers):
        lp = _layer(params, i)
        kc, vc = cache["k"][i], cache["v"][i]                   # (P,ps,K,hd)
        x = L.norm(h, lp.get("ln1"), cfg.norm)
        q = L.apply_rope(_project(x, lp["attn"]["wq"]), cos, sin)
        k_new = L.apply_rope(_project(x, lp["attn"]["wk"]), cos, sin)
        v_new = _project(x, lp["attn"]["wv"])
        _paged_write(kc, k_new, write_table, q_pos)
        _paged_write(vc, v_new, write_table, q_pos)
        a_out = kernel_ops.paged_suffix_attention(q, kc[:-1], vc[:-1],
                                                  page_table, q_pos)
        h = h + _out_project(a_out, lp["attn"]["wo"])
        x = L.norm(h, lp.get("ln2"), cfg.norm)
        h = h + _ffn(lp, cfg, x)
    h = L.norm(h, params.get("final_norm"), cfg.norm)
    return _logits(params, cfg, h), cache
