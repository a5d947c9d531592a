"""Two-term roofline step time, the part of `repro.roofline.analysis` that
the perf model (`core.perfmodel`) needs.

This file differs from the reference on purpose: it keeps only
`roofline_step_s` and `model_flops_for` (the 6 N D of a train step,
which `chip_smoke.py` states a train step's FLOP rate with), with the
defaults set to one H100 SXM's data-sheet
peaks (dense BF16 on the tensor cores, and HBM3 bandwidth, at the full
700 W limit), the constants `chip_smoke.py` bounds the kernels with.  The
reference's HLO cost parsing has no counterpart here yet.
"""
from __future__ import annotations

PEAK_FLOPS = 989e12          # bf16 FLOP/s, one H100 SXM
HBM_BW = 3.35e12             # bytes/s, one H100 SXM


def roofline_step_s(flops: float, hbm_bytes: float,
                    peak_flops: float = PEAK_FLOPS,
                    hbm_bw: float = HBM_BW) -> float:
    """Idealized step time under a two-term roofline: compute and memory
    perfectly overlap, so the step takes the *max* of the two terms.

    Parameterized over the capability vector (peak FLOP/s, memory
    bytes/s) so the per-GPU-class perf model (`core.perfmodel`) prices
    every node class with it."""
    if peak_flops <= 0 or hbm_bw <= 0:
        return float("inf")
    return max(flops / peak_flops, hbm_bytes / hbm_bw)


def model_flops_for(cfg, shape) -> float:
    """MODEL_FLOPS = 6 N_active D for a train step (D the tokens it
    processes), 2 N_active D for a prefill, 2 N_active a sequence for a
    decode step, as `repro.roofline.analysis.model_flops_for`."""
    n = cfg.active_params()
    if shape.kind == "train":
        return 6.0 * n * shape.tokens()
    if shape.kind == "prefill":
        return 2.0 * n * shape.tokens()      # forward only
    return 2.0 * n * shape.batch             # decode: one token per seq
