"""Core layers: norms, RoPE, the SwiGLU and gelu MLPs — plain PyTorch, the
JAX layouts.

Activations are `(batch, seq, d_model)`; attention heads stay explicit
dims `(batch, seq, heads, head_dim)`.  Every function reproduces the
rounding order of its counterpart in `repro.models.layers`: statistics
and rotations in f32, cast back to the activation dtype at the same
points.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.distributed.sharding import (from_local, is_dtensor,
                                              redistribute)


# --------------------------------------------------------------------- #
# Norms

def rms_norm(x: torch.Tensor, scale=None, eps: float = 1e-6) -> torch.Tensor:
    if is_dtensor(x) and (scale is None or (is_dtensor(scale)
                                            and scale.dim() == 1)):
        from torch.distributed.tensor import Shard
        if any(p == Shard(x.ndim - 1) for p in x.placements):
            return _rms_norm_blocks(x, scale, eps)
    dt = x.dtype
    xf = x.float()
    xf = xf * torch.rsqrt(xf.square().mean(-1, keepdim=True) + eps)
    if scale is not None:
        xf = xf * (1.0 + scale.float()) if scale.dim() == 1 else xf * scale
    return xf.to(dt)


def _rms_norm_blocks(x, scale, eps: float):
    """`rms_norm` of a DTensor x whose last dim is sharded, on its local
    blocks: each rank's sum of squares summed over the mesh dims that
    split the last dim (one all-reduce each, `redistribute`), the scale
    (a 1-D DTensor) taken as its slice of the last dim.  DTensor's own
    ops would gather the statistic's operands with the functional
    collectives."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    mesh, d = x.device_mesh, x.ndim - 1
    split = tuple(Partial() if p == Shard(d) else p for p in x.placements)
    xf = x.to_local().float()
    ss = from_local(xf.square().sum(-1, keepdim=True), mesh, split)
    whole = tuple(Replicate() if isinstance(p, Partial) else p
                  for p in split)
    ms = redistribute(ss, whole).to_local(grad_placements=split) \
        / x.shape[-1]
    xf = xf * torch.rsqrt(ms + eps)
    if scale is not None:
        # its slice of the last dim; its block gradient is Partial over
        # the mesh dims that split the rows
        pl = tuple(Shard(0) if p == Shard(d) else Replicate()
                   for p in x.placements)
        grad_pl = tuple(Shard(0) if p == Shard(d) else Partial()
                        if isinstance(p, Shard) else Replicate()
                        for p in x.placements)
        scale = redistribute(scale, pl).to_local(grad_placements=grad_pl)
        xf = xf * (1.0 + scale.float())
    return from_local(xf.to(x.dtype), mesh, x.placements)


def nonparam_ln(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """OLMo's non-parametric LayerNorm: no scale, no bias.  The variance
    is the population variance (`jnp.var`), hence `correction=0`."""
    dt = x.dtype
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = xf.var(-1, keepdim=True, correction=0)
    return ((xf - mu) * torch.rsqrt(var + eps)).to(dt)


def norm(x: torch.Tensor, scale, kind: str) -> torch.Tensor:
    if kind == "nonparam_ln":
        return nonparam_ln(x)
    return rms_norm(x, scale)


def group_norm(x: torch.Tensor, n_groups: int, eps: float = 1e-6
               ) -> torch.Tensor:
    """Per-head group norm (xLSTM's cells): x (..., inner) in n_groups
    groups, each normalised on its own in f32 (population variance), no
    scale, cast back to x's dtype."""
    dt = x.dtype
    g = x.float().reshape(*x.shape[:-1], n_groups, x.shape[-1] // n_groups)
    mu = g.mean(-1, keepdim=True)
    var = g.var(-1, keepdim=True, correction=0)
    return ((g - mu) * torch.rsqrt(var + eps)).reshape(x.shape).to(dt)


# --------------------------------------------------------------------- #
# RoPE (half-split, not interleaved)

def rope_cos_sin(positions: torch.Tensor, head_dim: int, theta: float):
    """positions: (...,) int -> cos/sin (..., head_dim // 2) in f32."""
    half = head_dim // 2
    exps = torch.arange(half, dtype=torch.float32,
                        device=positions.device) / half
    # theta as a Python scalar: a tensor made of it on the card would be
    # a blocking upload every model call (ROADMAP C19); pow casts it to
    # f32, the same value bit for bit
    freqs = 1.0 / torch.pow(theta, exps)
    ang = positions.float()[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
               ) -> torch.Tensor:
    """x: (B, S, H, hd); cos/sin: (S, hd//2) or (B, S, hd//2)."""
    half = x.shape[-1] // 2
    if cos.dim() == 2:          # (S, half) -> broadcast over B, H
        cos, sin = cos[None, :, None, :], sin[None, :, None, :]
    else:                       # (B, S, half)
        cos, sin = cos[:, :, None, :], sin[:, :, None, :]
    xf = x.float()
    x1, x2 = xf[..., :half], xf[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# --------------------------------------------------------------------- #
# The sharded projections (`distributed.sharding`'s Megatron helpers)

def row_project(sh, x, w, eq, x_axes, w_axes, out_axes, scatter_axis=1):
    """Row-parallel (Megatron) out-projection: the explicit
    reduce-scatter when the sharder carries a tp_project hook
    (`distributed.sharding.make_tp_projector`) whose preconditions hold,
    else einsum + layout (`_fallback`)."""
    proj = getattr(sh, "tp_project", None)
    out = None if proj is None else proj(x, w, eq, x_axes, w_axes, out_axes,
                                         scatter_axis)
    return _fallback(sh, x, w, eq, out_axes) if out is None else out


def col_project(sh, x, w, eq, x_axes, w_axes, out_axes, gather_axis=1):
    """Column-parallel (Megatron f) projection: all_gather(x_seq) + the
    einsum on the local blocks, so the backward is one reduce-scatter
    (else einsum + layout, `_fallback`)."""
    proj = getattr(sh, "tp_col_project", None)
    out = None if proj is None else proj(x, w, eq, x_axes, w_axes, out_axes,
                                         gather_axis)
    return _fallback(sh, x, w, eq, out_axes) if out is None else out


def sharded_einsum(sh):
    """The sharder's einsum (`sh.einsum`, torch.einsum by default)."""
    return getattr(sh, "einsum", torch.einsum)


def _fallback(sh, x, w, eq, out_axes):
    """A projection no Megatron helper takes: the sharder's einsum and its
    layout."""
    return sh(sharded_einsum(sh)(eq, x, w), out_axes)


def seq_gather(sh, x, axes, axis: int = 1):
    """Megatron-SP f-operator: gather the seq-sharded residual once per
    block (an all-gather whose backward is a reduce-scatter).  Falls back
    to a layout constraint when no tp_gather hook is attached."""
    g = getattr(sh, "tp_gather", None)
    if g is not None:
        return g(x, axes, axis)
    fallback = tuple("seq_attn" if a == "seq" else a for a in axes)
    return sh(x, fallback)


# --------------------------------------------------------------------- #
# MLP

def swiglu(gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    """silu in f32, cast to the activation dtype, then times `up` in that
    dtype (the JAX rounding order)."""
    return F.silu(gate.float()).to(up.dtype) * up


def gelu(h: torch.Tensor) -> torch.Tensor:
    """`jax.nn.gelu` as the JAX FFN calls it: the tanh approximation (its
    default, approximate=True; torch's default is the exact erf form), in
    f32, cast back to the activation dtype."""
    return F.gelu(h.float(), approximate="tanh").to(h.dtype)


def mlp_apply(x: torch.Tensor, wi: torch.Tensor, wo: torch.Tensor,
              act: str = "swiglu", sh=None) -> torch.Tensor:
    """Dense FFN.  x: (B, S, D); wi: (2, D, F) for swiglu, (D, F) for
    gelu; wo: (F, D).  With a sharder the down-projection is
    row-parallel (`row_project`)."""
    h = swiglu(x @ wi[0], x @ wi[1]) if act == "swiglu" else gelu(x @ wi)
    if sh is not None:
        return row_project(sh, h, wo, "bsf,fd->bsd",
                           ("batch", "seq_attn", "mlp"),
                           ("mlp", "embed"), ("batch", "seq", "embed"))
    return h @ wo
