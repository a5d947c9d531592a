"""Token sampling: greedy / temperature / top-k / top-p, batched.

The counterpart of `repro.serving.sampler.sample_batched`, step for step:
the same sorted top-k threshold, the same top-p cutoff and clip, greedy
where the temperature is <= 0.  The draw is Gumbel-max (as
`jax.random.categorical`) on exponential noise from the caller's
`torch.Generator`, so sampled tokens follow the same distribution as
JAX's but not its bits.  Nothing here synchronises with the host.
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    temperature: float = 0.0          # 0 => greedy
    top_k: int = 0                    # 0 => off
    top_p: float = 1.0                # 1 => off
    max_tokens: int = 64
    eos_id: int = -1                  # -1 => never stops on token


_NEG = -1e30


def sample_batched(logits: torch.Tensor, generator: torch.Generator,
                   temps: torch.Tensor, top_ks: torch.Tensor,
                   top_ps: torch.Tensor, *, use_top_k: bool = True,
                   use_top_p: bool = True) -> torch.Tensor:
    """logits (B, V); temps (B,) f32; top_ks (B,) int32 (0 => off); top_ps
    (B,) f32 (1 => off).  Returns (B,) int32.  use_top_k / use_top_p are
    host-known switches that leave the full-vocabulary sorts out when no
    row filters."""
    v = logits.shape[-1]
    greedy = logits.argmax(-1).to(torch.int32)
    lg = logits.float() / temps[:, None].clamp_min(1e-6)
    neg = torch.full_like(lg, _NEG)
    if use_top_k:
        sorted_lg = lg.sort(-1, descending=True).values
        kth_idx = (top_ks.long() - 1).clamp(0, v - 1)
        kth = sorted_lg.gather(-1, kth_idx[:, None])
        lg = torch.where((top_ks[:, None] > 0) & (lg < kth), neg, lg)
    if use_top_p:
        sorted2 = lg.sort(-1, descending=True).values
        cum = torch.softmax(sorted2, -1).cumsum(-1)
        cut_idx = (cum < top_ps[:, None]).sum(-1, keepdim=True)
        cutoff = sorted2.gather(-1, cut_idx.clamp(0, v - 1))
        lg = torch.where((top_ps[:, None] < 1.0) & (lg < cutoff), neg, lg)
    # -log(Exp(1)) is a standard Gumbel; a zero draw would lift a masked
    # logit to +inf, so the noise is floored at the smallest normal f32
    noise = torch.empty_like(lg).exponential_(generator=generator)
    noise.clamp_min_(torch.finfo(torch.float32).tiny)
    sampled = (lg - noise.log()).argmax(-1).to(torch.int32)
    return torch.where(temps > 0.0, sampled, greedy)
