"""Parameters of every family the port serves: the decoder (dense or MoE
FFN, Hymba's hybrid attention + SSM layer, the encoder-decoder's
cross-attention and encoder stack) and xLSTM: seeded init and JAX
import.

The layout is the JAX package's, stacked over layers with a leading `L`
dim, as a nested dict of tensors:

    embed (V, d)                         tied LM head when cfg.tie_embeddings
    layers.attn.wq (L, d, h, hd)   wk, wv (L, d, K, hd)   wo (L, h, hd, d)
    layers.mlp.wi  (L, 2, d, f)          index 0 = gate, 1 = up (swiglu)
                   (L, d, f)             gelu
    layers.mlp.wo  (L, f, d)
    layers.moe.router (L, d, E) f32      MoE configs, in place of mlp
    layers.moe.wi  (L, E, 2, d, f) swiglu / (L, E, d, f) gelu
    layers.moe.wo  (L, E, f, d)
    layers.ln1 / ln2 (L, d), final_norm (d,)      rms-norm configs only
    lm_head (d, V)                                untied configs only

Hymba (`block="hymba"`, inner = n_heads * head_dim, r = max(8, inner //
64), N = ssm_state) has no `attn.wo`; in its place:

    meta (n_meta_tokens, d)                       ahead of every prompt
    layers.ssm.w_in (L, d, 2, inner)              index 0 = u, 1 = gate z
    layers.ssm.w_dt_a (L, inner, r)  w_dt_b (L, r, inner)
    layers.ssm.b_dt (L, inner) f32 = -4   a_log (L, inner, N) f32 = log(1..N)
    layers.ssm.w_b / w_c (L, inner, N)    d_skip (L, inner) f32 = 1
    layers.branch_norm_attn / branch_norm_ssm (L, inner) = 0
    layers.beta (L, 2) f32 = 1            layers.wo_comb (L, inner, d)

The encoder-decoder (`cfg.encdec`, L the decoder's depth, E its
encoder's) adds to each decoder layer a cross-attention and its norm,
and an encoder stack of plain layers (attention, FFN, ln1 / ln2):

    layers.xattn.wq (L, d, h, hd)  wk, wv (L, d, K, hd)  wo (L, h, hd, d)
    layers.lnx (L, d)                             rms-norm configs only
    enc_layers.{attn, mlp, ln1, ln2}              as layers, stacked (E, ...)

xLSTM (`block="xlstm"`, P = n_layers // 2 pairs, inner = 2 d, H heads,
hd_m = inner / H, hd_s = d / H, f the sLSTM FFN's width;
`models.xlstm.dims`):

    embed (V, d) tied                     final_norm (d,)
    pairs.mlstm.ln (P, d)  w_up (P, d, 2, inner)  index 0 = u, 1 = gate z
    pairs.mlstm.wq / wk / wv (P, inner, H, hd_m)  w_down (P, inner, d)
    pairs.mlstm.w_i / w_f (P, inner, H) f32   b_i (P, H) f32 = 0
    pairs.mlstm.b_f (P, H) f32 = 3            gn (P, inner)
    pairs.slstm.ln (P, d)  w_x (P, d, 4, H, hd_s) f32  (z, i, f, o)
    pairs.slstm.r (P, 4, H, hd_s, hd_s) f32   b (P, 4, H, hd_s) f32 = 0
    pairs.slstm.gn (P, d)  ffn_wi (P, d, f)  ffn_wo (P, f, d)

`init_params` draws every leaf from the same distribution as the JAX
init (truncated normal at +-2 sigma; 0.02 for embeddings, 1/sqrt(d_in)
for dense layers; zeros for rms scales).  The numbers differ from
`jax.random`'s; tests that compare the two packages carry JAX's params
across with `from_jax`.
"""
from __future__ import annotations

import math
from typing import Any, Callable, Dict, Iterable, Optional

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.device import (DeviceLike, generator_for, resolve_device,
                                torch_dtype)

Params = Dict[str, Any]


def require_supported(cfg: ArchConfig) -> None:
    """Refuse a config the port cannot run.  It runs every family of the
    zoo: the decoder (a SwiGLU or gelu FFN, dense or Mixture-of-Experts,
    an optional sliding window, an optional vision frontend's prefix
    tokens, Hymba's hybrid layer with its meta tokens and per-layer
    global or windowed attention, the encoder-decoder, whose audio
    frontend's frames come in as the encoder's input) and xLSTM.  It
    refuses configs that none of them builds: another block, Hymba
    without an SSM state, meta tokens outside Hymba, prefix tokens on a
    frontend other than vision, an audio frontend without an encoder, an
    FFN it has no form for."""
    unsupported = []
    if cfg.block not in ("transformer", "hymba", "xlstm"):
        unsupported.append(f"block={cfg.block}")
    if cfg.block == "hymba" and cfg.ssm_state <= 0:
        unsupported.append(f"hymba with ssm_state={cfg.ssm_state}")
    if cfg.encdec is not None and cfg.block != "transformer":
        unsupported.append(f"an encoder-decoder of block={cfg.block}")
    if cfg.n_meta_tokens and cfg.block != "hymba":
        unsupported.append("meta tokens outside hymba")
    if cfg.frontend not in ("", "vision", "audio") \
            or (cfg.n_prefix_tokens and cfg.frontend != "vision") \
            or (cfg.frontend == "audio" and cfg.encdec is None):
        unsupported.append(f"frontend={cfg.frontend!r} with "
                           f"{cfg.n_prefix_tokens} prefix tokens")
    if cfg.block != "xlstm" and (cfg.d_ff <= 0
                                 or cfg.act not in ("swiglu", "gelu")):
        unsupported.append(f"ffn act={cfg.act} d_ff={cfg.d_ff}")
    if unsupported:
        raise NotImplementedError(
            f"{cfg.name}: {', '.join(unsupported)} is not supported; "
            f"repro_torch runs the zoo's families")


# --------------------------------------------------------------------- #
# init

_LO, _HI = -2.0, 2.0


def _trunc_normal(shape, scale: float, dtype, gen: torch.Generator,
                  device: torch.device) -> torch.Tensor:
    """Standard normal truncated to [-2, 2] (as jax.random.truncated_normal),
    times `scale`, by inverse CDF in f32, in place in one f32 buffer (a
    full-width expert leaf is billions of values).  On the meta device,
    the shape alone."""
    if device.type == "meta":
        return torch.empty(shape, dtype=dtype, device=device)
    cdf = lambda x: 0.5 * (1.0 + math.erf(x / math.sqrt(2.0)))  # noqa: E731
    lo, hi = cdf(_LO), cdf(_HI)
    u = torch.rand(shape, generator=gen, device=device, dtype=torch.float32)
    x = torch.special.ndtri(u.mul_(hi - lo).add_(lo), out=u)
    return x.clamp_(_LO, _HI).mul_(scale).to(dtype)


def init_params(cfg: ArchConfig, generator: torch.Generator,
                device: DeviceLike = None) -> Params:
    """Random params for `cfg` on `device` ("cuda" unless given), drawn
    from `generator`, which must live on that device.  On the meta device
    (no generator) the tree's shapes and dtypes alone, which is how
    placement counts an instance's bytes (`cluster.node`)."""
    require_supported(cfg)
    dev = resolve_device(device)
    if dev.type != "meta" and generator.device.type != dev.type:
        raise ValueError(f"generator on {generator.device}, params on {dev}")
    dt = torch_dtype(cfg.dtype)

    def dense(d_in, *shape, dtype=dt):
        return _trunc_normal(shape, (1.0 / d_in) ** 0.5, dtype, generator,
                             dev)

    if cfg.block == "xlstm":
        return _xlstm_params(cfg, dense, generator, dev)
    layers = _layers(cfg, cfg.n_layers, dense, dev, cross=cfg.is_encdec)
    params: Params = {
        "embed": _trunc_normal((cfg.vocab, cfg.d_model), 0.02, dt,
                               generator, dev),
        "layers": layers}
    if cfg.is_encdec:
        params["enc_layers"] = _layers(cfg, cfg.encdec.enc_layers, dense,
                                       dev)
    if cfg.n_meta_tokens:
        params["meta"] = _trunc_normal((cfg.n_meta_tokens, cfg.d_model),
                                       0.02, dt, generator, dev)
    if cfg.norm == "rms":
        params["final_norm"] = torch.zeros((cfg.d_model,), dtype=dt,
                                           device=dev)
    if not cfg.tie_embeddings:
        params["lm_head"] = _trunc_normal((cfg.d_model, cfg.vocab), 0.02, dt,
                                          generator, dev)
    return params


def _layers(cfg: ArchConfig, n: int, dense, dev: torch.device,
            cross: bool = False) -> Params:
    """n stacked decoder layers (with the cross-attention and its norm
    when `cross`), or, called without it for an encoder-decoder, its
    encoder stack."""
    d, hd = cfg.d_model, cfg.head_dim
    h, kv, f = cfg.n_heads, cfg.n_kv_heads, cfg.d_ff
    dt = torch_dtype(cfg.dtype)
    layers: Params = {
        "attn": {"wq": dense(d, n, d, h, hd), "wk": dense(d, n, d, kv, hd),
                 "wv": dense(d, n, d, kv, hd)},
    }
    if cfg.block != "hymba":
        layers["attn"]["wo"] = dense(h * hd, n, h, hd, d)
    if cross:
        layers["xattn"] = {"wq": dense(d, n, d, h, hd),
                           "wk": dense(d, n, d, kv, hd),
                           "wv": dense(d, n, d, kv, hd),
                           "wo": dense(h * hd, n, h, hd, d)}
    if cfg.moe is not None:
        e = cfg.moe.num_experts
        layers["moe"] = {
            "router": dense(d, n, d, e, dtype=torch.float32),
            "wi": (dense(d, n, e, 2, d, f) if cfg.act == "swiglu"
                   else dense(d, n, e, d, f)),
            "wo": dense(f, n, e, f, d)}
    else:
        layers["mlp"] = {"wi": (dense(d, n, 2, d, f) if cfg.act == "swiglu"
                                else dense(d, n, d, f)),
                         "wo": dense(f, n, f, d)}
    if cfg.block == "hymba":
        layers.update(_hymba_layers(cfg, dense, dev))
    if cfg.norm == "rms":
        for name in ("ln1", "ln2") + (("lnx",) if cross else ()):
            layers[name] = torch.zeros((n, d), dtype=dt, device=dev)
    return layers


def _xlstm_params(cfg: ArchConfig, dense, generator: torch.Generator,
                  dev: torch.device) -> Params:
    """xLSTM's tree, drawn and filled as `repro.models.xlstm.init_params`
    does: the gates' weights and biases in f32, the rest in the model
    dtype, the forget gates' bias at 3 (open)."""
    from repro_torch.models.xlstm import dims, n_pairs
    p = n_pairs(cfg)
    d, inner, h, hd_m, hd_s, ff = dims(cfg)
    dt = torch_dtype(cfg.dtype)
    f32 = torch.float32
    zeros = lambda *shape, dtype=dt: torch.zeros(  # noqa: E731
        shape, dtype=dtype, device=dev)
    return {
        "embed": _trunc_normal((cfg.vocab, d), 0.02, dt, generator, dev),
        "pairs": {
            "mlstm": {
                "ln": zeros(p, d),
                "w_up": dense(d, p, d, 2, inner),
                "wq": dense(inner, p, inner, h, hd_m),
                "wk": dense(inner, p, inner, h, hd_m),
                "wv": dense(inner, p, inner, h, hd_m),
                "w_i": dense(inner, p, inner, h, dtype=f32),
                "b_i": zeros(p, h, dtype=f32),
                "w_f": dense(inner, p, inner, h, dtype=f32),
                "b_f": torch.full((p, h), 3.0, dtype=f32, device=dev),
                "gn": zeros(p, inner),
                "w_down": dense(inner, p, inner, d)},
            "slstm": {
                "ln": zeros(p, d),
                "w_x": dense(d, p, d, 4, h, hd_s, dtype=f32),
                "r": dense(hd_s, p, 4, h, hd_s, hd_s, dtype=f32),
                "b": zeros(p, 4, h, hd_s, dtype=f32),
                "gn": zeros(p, d),
                "ffn_wi": dense(d, p, d, ff),
                "ffn_wo": dense(ff, p, ff, d)}},
        "final_norm": zeros(d),
    }


def _hymba_layers(cfg: ArchConfig, dense, dev: torch.device) -> Params:
    """Hymba's SSM branch, branch norms, mixing weights and output
    projection, drawn and filled as `repro.models.transformer._layer_init`
    does."""
    n, d, ns = cfg.n_layers, cfg.d_model, cfg.ssm_state
    inner = cfg.n_heads * cfg.head_dim
    r = max(8, inner // 64)
    dt = torch_dtype(cfg.dtype)
    f32 = dict(dtype=torch.float32, device=dev)
    a_log = torch.log(torch.arange(1, ns + 1, **f32))
    return {
        "ssm": {"w_in": dense(d, n, d, 2, inner),
                "w_dt_a": dense(inner, n, inner, r),
                "w_dt_b": dense(r, n, r, inner),
                "b_dt": torch.full((n, inner), -4.0, **f32),
                "a_log": a_log.expand(n, inner, ns).contiguous(),
                "w_b": dense(inner, n, inner, ns),
                "w_c": dense(inner, n, inner, ns),
                "d_skip": torch.ones((n, inner), **f32)},
        "branch_norm_attn": torch.zeros((n, inner), dtype=dt, device=dev),
        "branch_norm_ssm": torch.zeros((n, inner), dtype=dt, device=dev),
        "beta": torch.ones((n, 2), **f32),
        "wo_comb": dense(inner, n, inner, d)}


def seeded_store(device: DeviceLike = None,
                 names: Optional[Iterable[str]] = None
                 ) -> Callable[[ArchConfig], Optional[Params]]:
    """A `param_store` for the control plane's nodes: seeded weights on
    `device` ("cuda" unless given), drawn once per model and shared by
    every replica, for the models in `names` (default: every model the
    port runs).  Any other model gets None, and a node deploys its
    replicas in accounted mode (exact bytes, synthetic tokens, no
    engine)."""
    dev = resolve_device(device)
    names = None if names is None else set(names)
    trees: Dict[str, Params] = {}

    def store(cfg: ArchConfig) -> Optional[Params]:
        if names is not None and cfg.name not in names:
            return None
        if cfg.name not in trees:
            try:
                require_supported(cfg)
            except NotImplementedError:
                return None
            trees[cfg.name] = init_params(cfg, generator_for(dev, 0), dev)
        return trees[cfg.name]
    return store


# --------------------------------------------------------------------- #
# JAX import (numpy leaves in, tensors out)

def _leaf(a: np.ndarray, device: torch.device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        # numpy has no bf16: move the raw bits through a 16-bit view
        bits = np.ascontiguousarray(a).view(np.uint16).view(np.int16)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def from_jax(tree: Params, cfg: ArchConfig, device: DeviceLike = None
             ) -> Params:
    """Carry a JAX param pytree (leaves already `np.asarray`'d) across,
    leaf by leaf, keeping the stacked layout.  Takes numpy arrays only;
    it imports nothing of JAX."""
    require_supported(cfg)
    dev = resolve_device(device)

    def conv(node):
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        return _leaf(node, dev)
    return conv(tree)

