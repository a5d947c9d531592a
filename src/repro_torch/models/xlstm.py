"""xLSTM LM: alternating mLSTM / sLSTM block pairs (arXiv:2405.04517) —
the counterpart of `repro.models.xlstm`, in plain PyTorch with the same
stacked `(P, ...)` params (see `repro_torch.params`).

Layers come in pairs (an mLSTM block, then an sLSTM block); where JAX
scans over the stacked pairs, this loops over them in Python.  The full
forward runs the mLSTM's parallel form (its chunkwise form past 4096
tokens, as JAX); `prefill` runs the chunkwise form, which also yields
each pair's final state; `decode_step` runs the recurrent forms (O(1)
state a slot).  The sLSTM is strictly sequential (`ssm.slstm_scan`), its
input projections hoisted out of the time loop as JAX hoists them.

Numerics as JAX's: the gates' weights (`w_i`, `w_f`, `w_x`, `r`, the
biases) and every state are f32 at any model dtype; the projections run
in the model dtype; `group_norm(...) * (1 + gn)` and `rms_norm`'s
`(1 + scale)`; the LM head is the tied embedding.  Under quantize="int8"
the block's matrix products (`w_up`, `wq`, `wk`, `wv`, `w_down`,
`ffn_wi`, `ffn_wo`) and the tied head run `kernels.ops.int8_matmul`, as
the transformer's do (`transformer._matmul`): 7 a pair and the head,
each model call.

The cache is seven f32 leaves over the pairs, `(P, B, ...)`, with no
sequence axis: mC (H, hd_m, hd_m), mn (H, hd_m), mm (H), and sc, sn, sm,
sh (H, hd_s); mm and sm start at -1e30.  `decode_step` advances every
row in place, as JAX's scan steps every slot.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.distributed.sharding import (embed_rows, rows_map,
                                              rows_placements, store_block,
                                              wrap)
from repro_torch.models import layers as L
from repro_torch.models import ssm as ssm_lib
from repro_torch.models.transformer import (_embed, _index, _logits,
                                            _matmul, _project, _reshape,
                                            lookup_tables, sharded_head,
                                            sharded_last_logits,
                                            sharded_logits)
from repro_torch.params import Params

Cache = Dict[str, torch.Tensor]

# past this length the full forward runs the chunkwise mLSTM (JAX's rule)
PARALLEL_MAX = 4096
# the cache's leaves: the mLSTM's (C, n, m), then the sLSTM's (c, n, m, h)
CACHE_LEAVES = ("mC", "mn", "mm", "sc", "sn", "sm", "sh")


def dims(cfg: ArchConfig) -> Tuple[int, int, int, int, int, int]:
    """(d, inner, heads, mLSTM head dim, sLSTM head dim, sLSTM FFN
    width): the mLSTM up-projects by 2, the sLSTM's post-FFN is ~4/3 of
    2 d rounded up to 64."""
    d = cfg.d_model
    inner = 2 * d
    h = cfg.n_heads
    ff = int(8 * d / 3 / 64 + 1) * 64
    return d, inner, h, inner // h, d // h, ff


def n_pairs(cfg: ArchConfig) -> int:
    return max(1, cfg.n_layers // 2)


def _pair(params: Params, i: int) -> Tuple[Params, Params]:
    """Pair i's (mLSTM block, sLSTM block) params."""
    return tuple({k: _index(v, i) for k, v in params["pairs"][blk].items()}
                 for blk in ("mlstm", "slstm"))


def _pair_axes() -> Dict:
    """One pair's logical axes, as JAX's `_pair_axes`."""
    return {
        "mlstm": {"ln": ("embed",),
                  "w_up": ("embed", "stack", "inner"),
                  "wq": ("inner", "heads", "head_dim"),
                  "wk": ("inner", "heads", "head_dim"),
                  "wv": ("inner", "heads", "head_dim"),
                  "w_i": ("inner", "heads"), "b_i": ("heads",),
                  "w_f": ("inner", "heads"), "b_f": ("heads",),
                  "gn": ("inner",), "w_down": ("inner", "embed")},
        "slstm": {"ln": ("embed",),
                  "w_x": ("embed", "stack", "heads", "head_dim"),
                  "r": ("stack", "heads", "head_dim", "head_dim2"),
                  "b": ("stack", "heads", "head_dim"),
                  "gn": ("embed",),
                  "ffn_wi": ("embed", "mlp"), "ffn_wo": ("mlp", "embed")},
    }


def param_axes(cfg: ArchConfig) -> Dict:
    """The params' logical axes, key for key JAX's `param_axes`."""
    pairs = {blk: {k: ("layers",) + ax for k, ax in leaves.items()}
             for blk, leaves in _pair_axes().items()}
    return {"embed": ("vocab", "embed"), "pairs": pairs,
            "final_norm": ("embed",)}


def cache_axes(cfg: ArchConfig) -> Dict:
    """The seven state leaves' logical axes, as JAX's `cache_axes`."""
    vec = ("layers", "batch", "heads", "head_dim")
    return {"mC": ("layers", "batch", "heads", "head_dim", "head_dim2"),
            "mn": vec, "mm": ("layers", "batch", "heads"),
            "sc": vec, "sn": vec, "sm": vec, "sh": vec}


# --------------------------------------------------------------------- #
# the two blocks, shared by the full-sequence and the one-token paths

def _mlstm_in(mp: Params, cfg: ArchConfig, x: torch.Tensor):
    """From the normed input x (..., d): u and the gate z (..., inner),
    q, k, v (..., H, hd_m) in x's dtype, and the f32 gate inputs i_raw,
    f_raw (..., H)."""
    d, inner, _, _, _, _ = dims(cfg)
    up = _matmul(x, _reshape(mp["w_up"], d, 2 * inner))
    u, z = up[..., :inner], up[..., inner:]
    q, k, v = (_project(u, mp[w]) for w in ("wq", "wk", "wv"))
    uf = u.float()
    i_raw = uf @ mp["w_i"] + mp["b_i"]
    f_raw = uf @ mp["w_f"] + mp["b_f"]
    return z, q, k, v, i_raw, f_raw


def _mlstm_out(mp: Params, cfg: ArchConfig, core: torch.Tensor,
               z: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """The block's residual: the cell's output (..., H, hd_m) group-normed
    per head, scaled by (1 + gn), gated by silu(z), projected down."""
    _, inner, nh, _, _, _ = dims(cfg)
    y = L.group_norm(core.reshape(*core.shape[:-2], inner), nh) \
        * (1.0 + mp["gn"].float())
    y = y.to(h.dtype) * F.silu(z.float()).to(h.dtype)
    return h + _matmul(y, mp["w_down"])


def _slstm_in(sp: Params, cfg: ArchConfig, h: torch.Tensor) -> torch.Tensor:
    """The cell's input projections (..., 4, H, hd_s) in f32, bias
    included (z, i, f, o)."""
    d, _, nh, _, hd_s, _ = dims(cfg)
    x = L.rms_norm(h, sp["ln"])
    xw = x.float() @ sp["w_x"].reshape(d, 4 * nh * hd_s)
    return xw.reshape(*h.shape[:-1], 4, nh, hd_s) + sp["b"]


def _slstm_out(sp: Params, cfg: ArchConfig, hs: torch.Tensor,
               h: torch.Tensor) -> torch.Tensor:
    """The block's residual from the cell's h (..., H, hd_s) f32: group
    norm per head, (1 + gn), the gelu post-FFN."""
    d, _, nh, _, _, _ = dims(cfg)
    y = hs.reshape(*hs.shape[:-2], d).to(h.dtype)
    y = (L.group_norm(y, nh) * (1.0 + sp["gn"].float())).to(h.dtype)
    return h + _matmul(L.gelu(_matmul(y, sp["ffn_wi"])), sp["ffn_wo"])


# --------------------------------------------------------------------- #
# full sequence

def _trunk(params: Params, cfg: ArchConfig, tokens: torch.Tensor, *,
           chunked: bool, remat: bool = False, sh=None,
           shw=None) -> Tuple[torch.Tensor, Cache]:
    """Every pair from the init state, then the final norm.  Returns (h
    (B, S, d), the pairs' final states stacked as the cache when
    `chunked`, else {}).  `remat` runs each pair under
    `torch.utils.checkpoint` (its input kept, the rest recomputed in the
    backward), as JAX's `jax.checkpoint(nothing_saveable)` around its
    pair scan's body.  `sh` / `shw` (`distributed.sharding`) lay out
    the activations as JAX's forward does and move each pair's weights
    to their compute layout; each pair runs on each rank's rows."""
    b, s = tokens.shape
    res = ("batch", "seq", "embed")
    if sh is not None:
        h = sh(_embed(lookup_tables(params), tokens), res)
    else:
        h = _embed(params, tokens)
    chunked = chunked or s > PARALLEL_MAX
    finals = []
    for i in range(n_pairs(cfg)):
        mp, sp = _pair(params, i)
        if shw is not None:
            pp = shw({"mlstm": mp, "slstm": sp}, _pair_axes())
            mp, sp = pp["mlstm"], pp["slstm"]
        if remat:
            h, fin = checkpoint(_pair_seq, mp, sp, cfg, h, chunked, sh,
                                use_reentrant=False)
        else:
            h, fin = _pair_seq(mp, sp, cfg, h, chunked, sh)
        if sh is not None:
            h = sh(h, res)
        if chunked:
            finals.append(fin)
    final = params["final_norm"]
    if shw is not None:
        final = shw(final, ("embed",))      # its compute layout
    h = L.rms_norm(h, final)
    if not finals:
        return h, {}
    return h, {name: torch.stack([f[j] for f in finals])
               for j, name in enumerate(CACHE_LEAVES)}


def _pair_seq(mp: Params, sp: Params, cfg: ArchConfig, h: torch.Tensor,
              chunked: bool, sh=None):
    """One pair over a full sequence from the init state: returns (h, its
    final states (the mLSTM's C, n, m, then the sLSTM's c, n, m, h) when
    `chunked`, else None).  Under a sharder the pair runs on each rank's
    rows with its weights whole (`rows_map`): its products' layouts
    (the residual's sequence, the weights' inner and heads, all on
    "model") would clash in DTensor's ops, which would move them with
    its functional all-gather."""
    if sh is not None:
        return rows_map(lambda h, w: _pair_seq(w["mlstm"], w["slstm"], cfg,
                                               h, chunked),
                        {"mlstm": mp, "slstm": sp}, h)
    _, _, nh, hd_m, hd_s, _ = dims(cfg)
    z, q, k, v, i_raw, f_raw = _mlstm_in(mp, cfg, L.rms_norm(h, mp["ln"]))
    m_fin = ()
    if chunked:
        core, m_fin = ssm_lib.mlstm_chunkwise(
            q, k, v, i_raw, f_raw,
            ssm_lib.mlstm_init_state(q.shape[0], nh, hd_m, q.device))
    else:
        core = ssm_lib.mlstm_parallel(q, k, v, i_raw, f_raw)
    h = _mlstm_out(mp, cfg, core, z, h)
    xw = _slstm_in(sp, cfg, h)
    hs, s_fin = ssm_lib.slstm_scan(
        xw, sp["r"], ssm_lib.slstm_init_state(xw.shape[0], nh, hd_s,
                                              xw.device))
    h = _slstm_out(sp, cfg, hs, h)
    return h, ((*m_fin, *s_fin) if chunked else None)


def forward(params: Params, cfg: ArchConfig, tokens: torch.Tensor, *,
            remat: bool = False, sh=None, shw=None) -> torch.Tensor:
    """Full-sequence logits (B, S, V), as JAX's forward; `remat`
    checkpoints each pair, `sh` / `shw` are the sharded step's hooks (see
    `_trunk`).  Differentiable: training's forward."""
    h, _ = _trunk(params, cfg, tokens, chunked=False, remat=remat, sh=sh,
                  shw=shw)
    if sh is not None:
        return sharded_logits(params, cfg, h, sh, shw)
    return _logits(params, cfg, h)


def prefill(params: Params, cfg: ArchConfig, tokens: torch.Tensor, *,
            sh=None, shw=None) -> Tuple[torch.Tensor, Cache, torch.Tensor]:
    """Rows of one exact length (a state absorbs padding): returns
    (last_logits (B, V), the cache of each pair's final state (P, B, ...),
    pos (B,) int32 = S - 1).  The states come from the chunkwise mLSTM
    form; only the last hidden row meets the LM head.  `sh` / `shw`: a
    sharded serving step's hooks (see `_trunk`); the last rows are taken
    where their block of positions lies, pos and the logits come back
    laid out by rows (the logits also by vocabulary), the states as the
    cells leave them."""
    h, cache = _trunk(params, cfg, tokens, chunked=True, sh=sh, shw=shw)
    b, s = tokens.shape
    if sh is None:
        pos = torch.full((b,), s - 1, dtype=torch.int32, device=h.device)
        return _logits(params, cfg, h[:, -1]), cache, pos
    pos = wrap(torch.full((h.to_local().shape[0],), s - 1,
                          dtype=torch.int32, device=h.to_local().device),
               h.device_mesh, rows_placements(h))
    return sharded_last_logits(params, cfg, h, pos, sh, shw), cache, pos


# --------------------------------------------------------------------- #
# decode


def init_cache(cfg: ArchConfig, batch: int, device: torch.device) -> Cache:
    """The seven f32 state leaves (P, batch, ...), mm and sm at -1e30."""
    _, _, nh, hd_m, hd_s, _ = dims(cfg)
    p = n_pairs(cfg)
    m = ssm_lib.mlstm_init_state(batch, nh, hd_m, device)
    s = ssm_lib.slstm_init_state(batch, nh, hd_s, device)
    return {name: leaf[None].expand(p, *leaf.shape).clone()
            for name, leaf in zip(CACHE_LEAVES, (*m, *s))}


def decode_step(params: Params, cfg: ArchConfig, cache: Cache,
                token: torch.Tensor, *, sh=None, shw=None
                ) -> Tuple[torch.Tensor, Cache]:
    """One token a row: token (B,) int32 against cache {mC, ...: (P, B,
    ...)}, every leaf advanced in place (every row).  Returns (logits (B,
    V), cache).  `sh` / `shw`: a sharded serving step's hooks (params,
    cache and token DTensors): the token's rows come from each rank's
    block of the vocabulary (`embed_rows`), the pairs run as DTensor ops
    with the residual laid out ("batch", "embed"), each new state is
    written into its leaf's local block, and the logits come back laid
    out ("batch", "vocab")."""
    if sh is None:
        h = _embed(params, token)                               # (B, d)
    else:
        h = sh(embed_rows(params["embed"], token), ("batch", "embed"))
    for i in range(n_pairs(cfg)):
        mp, sp = _pair(params, i)
        if shw is not None:
            pp = shw({"mlstm": mp, "slstm": sp}, _pair_axes())
            mp, sp = pp["mlstm"], pp["slstm"]
        h = pair_step(mp, sp, cfg, cache, i, h)
        if sh is not None:
            h = sh(h, ("batch", "embed"))
    h = L.rms_norm(h, params["final_norm"])
    if sh is None:
        return _logits(params, cfg, h), cache
    return sh(h @ sharded_head(params, cfg, shw), ("batch", "vocab")), cache


def pair_step(mp: Params, sp: Params, cfg: ArchConfig, cache: Cache,
              i: int, h: torch.Tensor) -> torch.Tensor:
    """Pair i's decode step: h (B, d) through its mLSTM block (mp) and
    sLSTM block (sp), the recurrent forms, pair i's state leaves in
    `cache` advanced in place.  Returns h."""
    z, q, k, v, i_raw, f_raw = _mlstm_in(mp, cfg, L.rms_norm(h, mp["ln"]))
    out, m_new = ssm_lib.mlstm_recurrent(
        q, k, v, i_raw, f_raw,
        ssm_lib.MLSTMState(*(cache[n][i] for n in CACHE_LEAVES[:3])))
    h = _mlstm_out(mp, cfg, out, z, h)
    s_new = ssm_lib.slstm_step(
        _slstm_in(sp, cfg, h), sp["r"],
        ssm_lib.SLSTMState(*(cache[n][i] for n in CACHE_LEAVES[3:])))
    for name, leaf in zip(CACHE_LEAVES, (*m_new, *s_new)):
        store_block(cache[name], i, leaf)
    return _slstm_out(sp, cfg, s_new.h, h)
