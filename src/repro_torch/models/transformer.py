"""The transformer family (the causal decoders, Hymba and the
encoder-decoder): full-sequence forward, bucketed prefill, the
prefix-cache suffix prefill, one decode step against a contiguous cache
or straight against the paged KV pool, and the speculative verify
against the paged pool.

The counterpart of `repro.models.transformer` (its xLSTM dispatch
aside: the model facade routes xLSTM to `models.xlstm`), with the same
stacked `(L, ...)` params (see
`repro_torch.params`) and the same layouts at every public function: a
SwiGLU or gelu FFN, dense or Mixture-of-Experts (`models.moe`, whose
capacity comes from the sequence length each entry point feeds it), a
sliding window (`cfg.swa_window`) and a vision frontend's prefix tokens
(`prefix_embeds` (B, n_prefix_tokens, D) ahead of the prompt, exempt from
the window but not from causality; RoPE positions count them).  Where
JAX scans over layers, this loops over them in Python, so each layer's
window is a static int (`_window`): the config's in every layer, or,
for Hymba, 0 in its `global_attn_layers` and the config's in the rest.

Hymba (`block="hymba"`): the learned meta tokens go ahead of everything
else (and count in the prefix the window exempts); each layer runs
attention and the selective SSM (`models.ssm`) side by side on the same
normed input, rms-norms each branch, mixes them with `beta * 0.5` and
projects through `wo_comb`.  The cache gains the slot-resident
`ssm_h` (L, B, inner, N) in f32, which the decode steps advance in
place.  `prefill` collects each layer's final state in the pass that
computes its output; JAX re-runs the stack with every layer windowed to
collect them, which departs from its own forward once a prompt and its
meta tokens outrun the window (ROADMAP.md C15).  A recurrent state
absorbs padding, so Hymba rows are prefilled at their exact length.

The encoder-decoder (`cfg.encdec`): `src_embeds` (B, S_src, D), the
audio frontend's frames, run through the encoder stack (`enc_layers`:
non-causal self-attention with RoPE, the FFN) and the decoder's
`final_norm`; each decoder layer then adds, after its self-attention, a
cross-attention from `lnx`-normed queries (no RoPE) over K/V projected
from the encoder's output by its `xattn` weights, non-causal.  The
cache gains, slot-resident beside the pools or strips, each layer's
cross K/V "ck", "cv" (L, B, S_src, K, hd), which `prefill` computes
and the decode steps read with every position valid (pos = S_src - 1).
In prefill the encoder's and the cross attention run the flash kernel
with causal=False (the cross with Sq != Skv); in decode the cross
attention runs the decode kernel over the slot's ck / cv in every mode,
the paged one included (where the self-attention reads the pools).

Prefill attention runs the flash kernel
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
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.device import torch_dtype
from repro_torch.kernels import ops as kernel_ops
from repro_torch.models import attention as attn_lib
from repro_torch.models import layers as L
from repro_torch.models import moe as moe_lib
from repro_torch.models import ssm as ssm_lib
from repro_torch.params import Params, require_supported

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


_HYMBA_LEAVES = ("branch_norm_attn", "branch_norm_ssm", "beta", "wo_comb")


def _require_transformer(cfg: ArchConfig) -> None:
    require_supported(cfg)
    if cfg.block == "xlstm":
        raise NotImplementedError("xlstm runs models.xlstm")


def _layer(params: Params, i: int, stack: str = "layers") -> Params:
    """Layer i of the decoder (or, stack="enc_layers", of the encoder)."""
    lp = params[stack]
    ffn = "moe" if "moe" in lp else "mlp"
    subs = ("attn", ffn) + tuple(sub for sub in ("ssm", "xattn")
                                 if sub in lp)
    out = {sub: {k: _index(v, i) for k, v in lp[sub].items()}
           for sub in subs}
    for name in ("ln1", "ln2", "lnx") + _HYMBA_LEAVES:
        if name in lp:
            out[name] = _index(lp[name], i)
    return out


def _window(cfg: ArchConfig, i: int) -> int:
    """Layer i's attention window: 0 (global) in a Hymba model's
    `global_attn_layers`, else the config's (0 without one)."""
    if cfg.block == "hymba" and i in cfg.global_attn_layers:
        return 0
    return cfg.swa_window


def _prefix_len(cfg: ArchConfig) -> int:
    """Cache positions ahead of every prompt: meta and vision prefix
    tokens, all exempt from the window."""
    return cfg.n_meta_tokens + cfg.n_prefix_tokens


def _embed(params: Params, tokens: torch.Tensor) -> torch.Tensor:
    """The rows of the embedding.  `F.embedding`, not indexing: its
    backward on the card sums each row's gradient in a fixed order, where
    indexing's (`index_put_` with accumulate) adds them atomically, which
    is not bit-reproducible from run to run."""
    e = params["embed"]
    if isinstance(e, dict):
        return (e["__q__"][tokens].float() * e["scale"]).to(e["dtype"])
    return F.embedding(tokens, e)


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
    return _ffn_aux(lp, cfg, x)[0]


def _ffn_aux(lp: Params, cfg: ArchConfig, x: torch.Tensor
             ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """`_ffn` and the MoE load-balancing aux loss (None for a dense
    FFN)."""
    if cfg.moe is not None:
        mp = lp["moe"]
        return moe_lib.moe_ffn(x, mp["router"], _dense(mp["wi"]),
                               _dense(mp["wo"]), cfg.moe, cfg.act)
    return _dense_ffn(lp, cfg, x), None


def _dense_ffn(lp: Params, cfg: ArchConfig, x: torch.Tensor) -> torch.Tensor:
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


def zero_src_embeds(cfg: ArchConfig, batch: int, src_len: int,
                    device: torch.device) -> Optional[torch.Tensor]:
    """The encoder input the engine feeds an encoder-decoder, as JAX's
    engine does (`_extra_inputs`): zeros (B, src_len, D) in the model
    dtype, under which the encoder's output and every cross K/V are
    exactly 0 (ROADMAP.md C17); None for any other model."""
    if not cfg.is_encdec:
        return None
    return torch.zeros((batch, src_len, cfg.d_model),
                       dtype=torch_dtype(cfg.dtype), device=device)


def _embed_inputs(params: Params, cfg: ArchConfig, tokens: torch.Tensor,
                  prefix_embeds: Optional[torch.Tensor]
                  ) -> Tuple[torch.Tensor, int]:
    """(h (B, prefix + S, D), prefix): the meta tokens, then the prefix
    embeddings, ahead of the token embeddings."""
    h = _embed(params, tokens)
    parts, prefix = [h], 0
    if prefix_embeds is not None:
        parts.insert(0, prefix_embeds.to(h.dtype))
        prefix += prefix_embeds.shape[1]
    if cfg.n_meta_tokens:
        meta = params["meta"].to(h.dtype)
        parts.insert(0, meta[None].expand(h.shape[0], *meta.shape))
        prefix += cfg.n_meta_tokens
    if len(parts) == 1:
        return h, 0
    return torch.cat(parts, dim=1), prefix


def _attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
            impl: str, causal: bool, window: int = 0,
            prefix: int = 0) -> torch.Tensor:
    """q (B, Sq, H, hd) over k, v (B, Skv, K, hd): the flash kernel;
    impl="full" the plain reference attention; impl="auto" JAX's training
    attention (`attention.attention`: full, chunked past 2048 keys), which
    autograd differentiates.  Returns (B, Sq, H, hd)."""
    if impl == "full":
        return attn_lib.full_attention(q, k, v, causal=causal,
                                       window=window, prefix=prefix)
    if impl == "auto":
        return attn_lib.attention(q, k, v, causal=causal, window=window,
                                  prefix=prefix)
    # the flash kernel takes the heads-major (B, H, S, hd) views in place
    # and writes a (B, S, H, hd) buffer: no layout copies
    return kernel_ops.flash_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        causal=causal, window=window, prefix=prefix).transpose(1, 2)


def _attention_block(lp: Params, cfg: ArchConfig, x: torch.Tensor, *,
                     impl: str, prefix: int, window: int,
                     causal: bool = True) -> Tuple[torch.Tensor, Tuple]:
    """Self-attention over a full sequence from position 0, with RoPE:
    causal with the layer's window (the first `prefix` positions exempt
    from it), or, for the encoder, non-causal.  Returns (out (B, S, H,
    hd), (k, v) each (B, S, K, hd))."""
    q = _project(x, lp["attn"]["wq"])
    k = _project(x, lp["attn"]["wk"])
    v = _project(x, lp["attn"]["wv"])
    cos, sin = L.rope_cos_sin(torch.arange(x.shape[1], device=x.device),
                              cfg.head_dim, cfg.rope_theta)
    q = L.apply_rope(q, cos, sin)
    k = L.apply_rope(k, cos, sin)
    out = _attend(q, k, v, impl=impl, causal=causal, window=window,
                  prefix=prefix)
    return out, (k, v)


# --------------------------------------------------------------------- #
# The encoder-decoder: the encoder stack and the cross-attention

def _run_encoder(params: Params, cfg: ArchConfig, src_embeds: torch.Tensor,
                 impl: str) -> torch.Tensor:
    """The encoder over src_embeds (B, S_src, D): per layer non-causal
    self-attention (RoPE from position 0) and the FFN, then the decoder's
    final norm, as JAX's `_run_encoder`.  Returns (B, S_src, D)."""
    h = src_embeds.to(torch_dtype(cfg.dtype))
    for i in range(cfg.encdec.enc_layers):
        lp = _layer(params, i, "enc_layers")
        x = L.norm(h, lp.get("ln1"), cfg.norm)
        a_out, _ = _attention_block(lp, cfg, x, impl=impl, prefix=0,
                                    window=0, causal=False)
        h = h + _out_project(a_out, lp["attn"]["wo"])
        x = L.norm(h, lp.get("ln2"), cfg.norm)
        h = h + _ffn(lp, cfg, x)
    return L.norm(h, params.get("final_norm"), cfg.norm)


def _cross_kv(lp: Params, enc_out: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """A decoder layer's cross K/V (B, S_src, K, hd) from the encoder's
    output: its xattn wk / wv, no RoPE."""
    return (_project(enc_out, lp["xattn"]["wk"]),
            _project(enc_out, lp["xattn"]["wv"]))


def _cross_query(lp: Params, cfg: ArchConfig, h: torch.Tensor
                 ) -> torch.Tensor:
    """The cross-attention's queries (B, S, H, hd) from h: lnx, then
    xattn wq, no RoPE."""
    return _project(L.norm(h, lp.get("lnx"), cfg.norm), lp["xattn"]["wq"])


# --------------------------------------------------------------------- #
# Hymba's SSM branch

def _ssm_inputs(sp: Params, x: torch.Tensor):
    """The selective SSM's inputs from x (..., D): u and the gate z in
    x's dtype, dt, A, B_t and C_t in f32, as JAX's `_hymba_ssm_seq`."""
    w_in = sp["w_in"]
    d, _, inner = (w_in["__q__"] if isinstance(w_in, dict) else w_in).shape
    proj = _matmul(x, _reshape(w_in, d, 2 * inner))
    u, z = proj[..., :inner], proj[..., inner:]
    dt = torch.nn.functional.softplus(
        (u.float() @ sp["w_dt_a"].float()) @ sp["w_dt_b"].float()
        + sp["b_dt"])
    a = -torch.exp(sp["a_log"])
    b_t = (u @ sp["w_b"]).float()
    c_t = (u @ sp["w_c"]).float()
    return u, z, dt, a, b_t, c_t


def _ssm_out(sp: Params, y: torch.Tensor, u: torch.Tensor, z: torch.Tensor,
             dtype: torch.dtype) -> torch.Tensor:
    """The skip term and the gate, in f32, cast to the activations'."""
    y = y + sp["d_skip"] * u.float()
    return (y * torch.nn.functional.silu(z.float())).to(dtype)


def _hymba_ssm_seq(sp: Params, cfg: ArchConfig, x: torch.Tensor,
                   h0: Optional[torch.Tensor] = None):
    """The SSM branch over a full sequence x (B, S, D) from state h0
    (zeros when None).  Returns (y (B, S, inner), h_final (B, inner, N)
    f32)."""
    u, z, dt, a, b_t, c_t = _ssm_inputs(sp, x)
    if h0 is None:
        h0 = torch.zeros((x.shape[0], u.shape[-1], cfg.ssm_state),
                         dtype=torch.float32, device=x.device)
    y, h_f = ssm_lib.selective_scan(u.float(), dt, a, b_t, c_t, h0)
    return _ssm_out(sp, y, u, z, x.dtype), h_f


def _hymba_ssm_step(sp: Params, x: torch.Tensor, h: torch.Tensor):
    """One decode step of the SSM branch: x (B, D), h (B, inner, N) f32.
    Returns (y (B, inner), h_new)."""
    u, z, dt, a, b_t, c_t = _ssm_inputs(sp, x)
    y, h_new = ssm_lib.selective_step(u.float(), dt, a, b_t, c_t, h)
    return _ssm_out(sp, y, u, z, x.dtype), h_new


def _hymba_mix(lp: Params, a_out: torch.Tensor, s_out: torch.Tensor,
               dtype: torch.dtype) -> torch.Tensor:
    """Both branches (..., inner) rms-normed, mixed with beta * 0.5 in
    f32 and projected through wo_comb: the layer's residual update."""
    a_n = L.rms_norm(a_out, lp["branch_norm_attn"])
    s_n = L.rms_norm(s_out, lp["branch_norm_ssm"])
    beta = lp["beta"]
    comb = (beta[0] * a_n.float() + beta[1] * s_n.float()) * 0.5
    return _matmul(comb.to(dtype), lp["wo_comb"])


def _decoder_layer(lp: Params, cfg: ArchConfig, h: torch.Tensor, *,
                   impl: str, prefix: int, window: int,
                   xkv: Optional[Tuple] = None):
    """One layer over a full sequence; an encoder-decoder's attends over
    its cross K/V `xkv` after its self-attention.  Returns (h, (k, v),
    the SSM's final state (Hymba) or None)."""
    return _layer_forward(lp, cfg, h, impl=impl, prefix=prefix,
                          window=window, xkv=xkv)[:3]


def _layer_forward(lp: Params, cfg: ArchConfig, h: torch.Tensor, *,
                   impl: str, prefix: int, window: int,
                   xkv: Optional[Tuple] = None):
    """`_decoder_layer` and the layer's MoE aux loss (None for a dense
    FFN): (h, (k, v), h_f, aux)."""
    x = L.norm(h, lp.get("ln1"), cfg.norm)
    a_out, kv = _attention_block(lp, cfg, x, impl=impl, prefix=prefix,
                                 window=window)
    h_f = None
    if cfg.block == "hymba":
        s_out, h_f = _hymba_ssm_seq(lp["ssm"], cfg, x)
        h = h + _hymba_mix(lp, a_out.reshape(*a_out.shape[:2], -1), s_out,
                           h.dtype)
    else:
        h = h + _out_project(a_out, lp["attn"]["wo"])
    if xkv is not None:
        c_out = _attend(_cross_query(lp, cfg, h), *xkv, impl=impl,
                        causal=False)
        h = h + _out_project(c_out, lp["xattn"]["wo"])
    x = L.norm(h, lp.get("ln2"), cfg.norm)
    f_out, aux = _ffn_aux(lp, cfg, x)
    return h + f_out, kv, h_f, aux


def _trunk(params: Params, cfg: ArchConfig, tokens: torch.Tensor, *,
           impl: str, prefix_embeds: Optional[torch.Tensor],
           src_embeds: Optional[torch.Tensor] = None, remat: bool = False,
           collect: bool = True
           ) -> Tuple[torch.Tensor, Cache, int, torch.Tensor]:
    """Embedding (meta tokens, then the prefix embeddings, first), the
    encoder over `src_embeds` (an encoder-decoder), every layer and the
    final norm.  Returns (h (B, P + S, D), {"k", "v": (L, B, P + S, K,
    hd)} and, for Hymba, "ssm_h": (L, B, inner, N) f32 each layer's final
    SSM state from this very pass, for an encoder-decoder "ck", "cv":
    (L, B, S_src, K, hd) each layer's cross K/V, P, aux), P the prefix
    length, aux the MoE aux loss summed over the layers (a 0-d f32 zero
    without MoE), as JAX's forward.  `collect=False` returns {} for the
    cache (a training forward keeps no K/V).  `remat=True` runs each
    decoder layer (its cross K/V included) under
    `torch.utils.checkpoint`, which keeps only the layer's input and
    recomputes the rest in the backward: JAX's
    `jax.checkpoint(nothing_saveable)` around its layer scan's body."""
    _require_transformer(cfg)
    if impl not in ("flash", "full", "auto"):
        raise ValueError(f"impl must be 'flash', 'full' or 'auto', "
                         f"not {impl!r}")
    if cfg.is_encdec and src_embeds is None:
        raise ValueError(f"{cfg.name}: an encoder-decoder needs src_embeds")
    h, prefix = _embed_inputs(params, cfg, tokens, prefix_embeds)
    enc_out = (_run_encoder(params, cfg, src_embeds, impl)
               if cfg.is_encdec else None)
    ks, vs, states, xkvs = [], [], [], []
    aux = torch.zeros((), dtype=torch.float32, device=h.device)

    def layer(lp, h, window):
        xkv = _cross_kv(lp, enc_out) if enc_out is not None else None
        return (*_layer_forward(lp, cfg, h, impl=impl, prefix=prefix,
                                window=window, xkv=xkv), xkv)

    for i in range(cfg.n_layers):
        lp = _layer(params, i)
        if remat:
            out = checkpoint(layer, lp, h, _window(cfg, i),
                             use_reentrant=False)
        else:
            out = layer(lp, h, _window(cfg, i))
        h, (k, v), h_f, layer_aux, xkv = out
        if layer_aux is not None:
            aux = aux + layer_aux
        if collect:
            ks.append(k)
            vs.append(v)
            states.append(h_f)
            xkvs.append(xkv)
    h = L.norm(h, params.get("final_norm"), cfg.norm)
    if not collect:
        return h, {}, prefix, aux
    cache = {"k": torch.stack(ks), "v": torch.stack(vs)}
    if cfg.block == "hymba":
        cache["ssm_h"] = torch.stack(states)
    if cfg.is_encdec:
        cache["ck"] = torch.stack([ck for ck, _ in xkvs])
        cache["cv"] = torch.stack([cv for _, cv in xkvs])
    return h, cache, prefix, aux


def forward(params: Params, cfg: ArchConfig, tokens: torch.Tensor, *,
            impl: str = "flash",
            prefix_embeds: Optional[torch.Tensor] = None,
            src_embeds: Optional[torch.Tensor] = None, remat: bool = False,
            return_aux: bool = False):
    """Full-sequence logits (B, P + S, V), P the meta tokens and
    prefix_embeds.shape[1] (0 without either), as JAX's forward; an
    encoder-decoder needs `src_embeds`.  impl="flash" runs prefill's
    flash attention; impl="full" the plain reference attention (the
    no-cache recompute oracle); impl="auto" training's attention (full,
    chunked past 2048 keys; plain PyTorch, differentiable).  The engine
    feeds a vision model `zero_prefix_embeds` and an encoder-decoder
    `zero_src_embeds`; a recompute that stands for the engine passes the
    same.  `remat` checkpoints each layer (see `_trunk`); `return_aux`
    returns (logits, aux), aux the MoE aux loss summed over the layers
    (0 without MoE)."""
    h, _, _, aux = _trunk(params, cfg, tokens, impl=impl,
                          prefix_embeds=prefix_embeds, src_embeds=src_embeds,
                          remat=remat, collect=False)
    logits = _logits(params, cfg, h)
    return (logits, aux) if return_aux else logits


def nll_loss(logits: torch.Tensor, labels: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The mean next-token NLL over the labels that are not -100: f32
    log_softmax of logits (B, S, V), labels (B, S).  Returns (loss, the
    count of kept labels (at least 1) as f32)."""
    mask = labels != -100
    lab = torch.where(mask, labels, 0).long()
    lp = torch.log_softmax(logits.float(), dim=-1)
    nll = -lp.gather(-1, lab[..., None])[..., 0]
    denom = mask.sum().clamp_min(1)
    loss = torch.where(mask, nll, 0.0).sum() / denom
    return loss, denom.float()


def loss_fn(params: Params, cfg: ArchConfig, batch: Dict[str, torch.Tensor],
            *, remat: bool = False, aux_weight: float = 0.01):
    """JAX's `loss_fn`: batch {"tokens", "labels" (-100 masked),
    optional "prefix_embeds" / "src_embeds"}; the logits of the token
    tail (past the meta and prefix tokens) against the labels, plus
    aux_weight times the MoE aux loss.  The forward is training's
    (impl="auto").  Returns (total, {"loss", "aux", "tokens"})."""
    logits, aux = forward(params, cfg, batch["tokens"], impl="auto",
                          prefix_embeds=batch.get("prefix_embeds"),
                          src_embeds=batch.get("src_embeds"), remat=remat,
                          return_aux=True)
    labels = batch["labels"]
    loss, denom = nll_loss(logits[:, -labels.shape[1]:], labels)
    return loss + aux_weight * aux, {"loss": loss, "aux": aux,
                                     "tokens": denom}


# --------------------------------------------------------------------- #
# the int8 KV cache

def kv_quantize(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-(position, head) absmax int8: x (..., hd) -> (q int8 (...,
    hd), scale f32 (...)), as JAX's `kv_quantize` (round half to
    even)."""
    xf = x.float()
    scale = xf.abs().amax(-1, keepdim=True).clamp_min(1e-8) / 127.0
    q = torch.round(xf / scale).clamp(-127, 127).to(torch.int8)
    return q, scale[..., 0]


def kv_dequant(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """q (..., hd) int8, scale (...) -> f32 (..., hd)."""
    return q.float() * scale[..., None]


def init_cache(cfg: ArchConfig, batch: int, max_len: int,
               device: torch.device, src_len: int = 0, dtype=None,
               kv_quant: bool = False) -> Cache:
    """A zero contiguous cache, as JAX's `init_cache`: "k", "v" (L, batch,
    max_len, K, hd) in the model dtype, or int8 with "k_scale",
    "v_scale" (L, batch, max_len, K) f32 under kv_quant; Hymba's "ssm_h"
    (L, batch, inner, N) f32; an encoder-decoder's "ck", "cv" (L, batch,
    src_len, K, hd).  max_len counts the meta and prefix tokens."""
    _require_transformer(cfg)
    dt = dtype or torch_dtype(cfg.dtype)
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    zeros = lambda shape, dt: torch.zeros(shape, dtype=dt,  # noqa: E731
                                          device=device)
    if kv_quant:
        cache = {"k": zeros(shape, torch.int8), "v": zeros(shape, torch.int8),
                 "k_scale": zeros(shape[:-1], torch.float32),
                 "v_scale": zeros(shape[:-1], torch.float32)}
    else:
        cache = {"k": zeros(shape, dt), "v": zeros(shape, dt)}
    if cfg.block == "hymba":
        cache["ssm_h"] = zeros((cfg.n_layers, batch,
                                cfg.n_heads * cfg.head_dim, cfg.ssm_state),
                               torch.float32)
    if cfg.is_encdec:
        xshape = (cfg.n_layers, batch, src_len, cfg.n_kv_heads,
                  cfg.head_dim)
        cache["ck"], cache["cv"] = zeros(xshape, dt), zeros(xshape, dt)
    return cache


def prefill(params: Params, cfg: ArchConfig, tokens: torch.Tensor, *,
            lengths: Optional[torch.Tensor] = None,
            prefix_embeds: Optional[torch.Tensor] = None,
            src_embeds: Optional[torch.Tensor] = None, cache_len: int = 0,
            kv_quant: bool = False
            ) -> Tuple[torch.Tensor, Cache, torch.Tensor]:
    """Forward a right-padded batch through the flash attention kernel and
    return (last_logits (B, V), cache {"k", "v": (L, B, P + S, K, hd)},
    pos (B,) int32), P the meta and prefix tokens (0 without them); a
    Hymba cache also holds "ssm_h" (L, B, inner, N), collected in the same
    pass, and an encoder-decoder's "ck", "cv" (L, B, S_src, K, hd), the
    cross K/V of the encoder's output over `src_embeds` (B, S_src, D).

    lengths: (B,) valid token counts; each row's logits and `pos` come
    from its own last real token, pos = P + lengths - 1 (padded positions
    sit past `pos` and are masked out of every later decode read).  An
    SSM state absorbs padding, so Hymba rows come at their exact length
    and without `lengths`, as JAX's engine prefills them.  Only the last
    hidden row of each sequence meets the LM head — the same logits as
    JAX's full-sequence head, without a (B, S, V) tensor.

    cache_len: the cache's length when it exceeds P + S (the K/V at the
    front, zeros behind, as JAX's); kv_quant: the int8 cache of
    `init_cache(kv_quant=True)`, K/V quantized per position and head.
    """
    h, cache, prefix, _ = _trunk(params, cfg, tokens, impl="flash",
                                 prefix_embeds=prefix_embeds,
                                 src_embeds=src_embeds)
    b, s_tot = h.shape[:2]
    if kv_quant or cache_len > s_tot:
        full = init_cache(cfg, b, max(cache_len, s_tot), h.device,
                          kv_quant=kv_quant)
        for name in ("k", "v"):
            kv = cache[name]
            if kv_quant:
                kv, scale = kv_quantize(kv)
                full[f"{name}_scale"][:, :, :s_tot] = scale
                cache[f"{name}_scale"] = full[f"{name}_scale"]
            full[name][:, :, :s_tot] = kv
            cache[name] = full[name]
    if lengths is None:
        pos = torch.full((b,), s_tot - 1, dtype=torch.int32,
                         device=h.device)
    else:
        pos = (prefix + lengths.to(h.device) - 1).to(torch.int32)
    last = h[torch.arange(b, device=h.device), pos.long()]      # (B, D)
    return _logits(params, cfg, last), cache, pos


def _plain_causal_only(cfg: ArchConfig, name: str) -> None:
    require_supported(cfg)
    if cfg.block != "transformer" or cfg.swa_window or _prefix_len(cfg) \
            or cfg.is_encdec:
        raise NotImplementedError(
            f"{name} supports plain causal decoders only (no recurrent "
            f"state, no window, no meta or prefix tokens, no encoder)")


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
    layer's window; the cache's first meta and prefix positions are
    exempt from it.  A Hymba cache's "ssm_h" (L, B, inner, N) advances
    in place, every row, as JAX's scan steps every slot; an
    encoder-decoder's "ck", "cv" (L, B, S_src, K, hd) are read
    (`_cross_update`).

    An int8 cache (`init_cache(kv_quant=True)`: "k_scale" in it) takes
    JAX's quantized branch: the new K/V quantized and written with their
    scales at `pos`, then each layer's whole cache dequantized to f32 (B,
    S, K, hd) and attended by the decode kernel on its f32 route, the
    query cast up to f32 and the output back to the model dtype.  Returns
    (logits (B, V), cache)."""
    _require_transformer(cfg)
    b = token.shape[0]
    nkv, hd = cfg.n_kv_heads, cfg.head_dim
    prefix = _prefix_len(cfg)
    quant = "k_scale" in cache
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
        qf = q[:, 0].reshape(b, nkv, q.shape[2] // nkv, hd)     # kv-major
        if quant:
            k_at, v_at = (_write_quantized(cache, name, i, new[:, 0], rows,
                                           w_pos)
                          for name, new in (("k", k_new), ("v", v_new)))
            qf = qf.float()
        else:
            kc[rows, w_pos] = k_new[:, 0].to(kc.dtype)
            vc[rows, w_pos] = v_new[:, 0].to(vc.dtype)
            k_at, v_at = kc, vc
        a_out = kernel_ops.decode_attention(
            qf, k_at.permute(0, 2, 1, 3), v_at.permute(0, 2, 1, 3), pos,
            window=_window(cfg, i), prefix=prefix).to(q.dtype)
        h = h + _attn_update(lp, cfg, cache, i, x,
                             a_out.reshape(b, 1, q.shape[2], hd))
        if cfg.is_encdec:
            h = h + _cross_update(lp, cfg, cache, i, h)
        x = L.norm(h, lp.get("ln2"), cfg.norm)
        h = h + _ffn(lp, cfg, x)
    h = L.norm(h, params.get("final_norm"), cfg.norm)
    return _logits(params, cfg, h)[:, 0], cache


def _write_quantized(cache: Cache, name: str, i: int, new: torch.Tensor,
                     rows: torch.Tensor, w_pos: torch.Tensor) -> torch.Tensor:
    """Quantize one token's new (B, K, hd) K or V (`name`), write it and
    its scales at w_pos into layer i of an int8 cache, in place, and
    return the layer's whole cache dequantized, (B, S, K, hd) f32."""
    q, scale = kv_quantize(new)
    cache[name][i][rows, w_pos] = q
    cache[f"{name}_scale"][i][rows, w_pos] = scale
    return kv_dequant(cache[name][i], cache[f"{name}_scale"][i])


def _cross_update(lp: Params, cfg: ArchConfig, cache: Cache, i: int,
                  h: torch.Tensor):
    """An encoder-decoder's decode-step cross-attention residual: the
    token's query h (B, 1, D) over layer i's slot-resident cross K/V,
    every position of the source valid, through the decode kernel."""
    ck, cv = cache["ck"][i], cache["cv"][i]                     # (B,Ss,K,hd)
    b, nkv, hd = h.shape[0], cfg.n_kv_heads, cfg.head_dim
    q = _cross_query(lp, cfg, h)[:, 0]                          # (B,H,hd)
    src_pos = torch.full((b,), ck.shape[1] - 1, dtype=torch.int32,
                         device=h.device)
    out = kernel_ops.decode_attention(
        q.reshape(b, nkv, q.shape[1] // nkv, hd), ck.permute(0, 2, 1, 3),
        cv.permute(0, 2, 1, 3), src_pos)
    return _out_project(out.reshape(b, 1, q.shape[1], hd),
                        lp["xattn"]["wo"])


def _attn_update(lp: Params, cfg: ArchConfig, cache: Cache, i: int,
                 x: torch.Tensor, a_out: torch.Tensor) -> torch.Tensor:
    """A decode step's residual update from layer i's attention output
    a_out (B, 1, H, hd): the output projection, or, for Hymba, the SSM
    step on the layer's normed input x (B, 1, D) from cache["ssm_h"][i]
    (advanced in place) mixed with it."""
    if cfg.block != "hymba":
        return _out_project(a_out, lp["attn"]["wo"])
    s_out, cache["ssm_h"][i] = _hymba_ssm_step(lp["ssm"], x[:, 0],
                                                cache["ssm_h"][i])
    return _hymba_mix(lp, a_out.reshape(a_out.shape[0], 1, -1),
                      s_out[:, None], x.dtype)


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
    whose last page is the scratch page that dropped writes land in, and
    a Hymba model's slot-resident "ssm_h" (L, n_slots, inner, N) or an
    encoder-decoder's slot-resident cross K/V "ck", "cv" (L, n_slots,
    S_src, K, hd), which the cross-attention reads through the decode
    kernel.
    Attention reads only the first n_pages, with the layer's window and
    the prefix, as `decode_step`.

    The new KV is written into the pools in place — the counterpart of
    JAX donating the cache buffers — and `cache` is returned as is.
    Returns (logits (B, V), cache)."""
    _require_transformer(cfg)
    b = token.shape[0]
    nkv, hd = cfg.n_kv_heads, cfg.head_dim
    prefix = _prefix_len(cfg)
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
            qf, kc[:-1], vc[:-1], page_table, pos, window=_window(cfg, i),
            prefix=prefix)
        h = h + _attn_update(lp, cfg, cache, i, x,
                             a_out.reshape(b, 1, q.shape[2], hd))
        if cfg.is_encdec:
            h = h + _cross_update(lp, cfg, cache, i, h)
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
