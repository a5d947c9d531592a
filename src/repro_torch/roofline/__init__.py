"""Roofline step time for the perf model (`analysis.roofline_step_s`)
and a step's model FLOPs (`analysis.model_flops_for`)."""
from repro_torch.roofline.analysis import (HBM_BW, PEAK_FLOPS,
                                           model_flops_for, roofline_step_s)

__all__ = ["roofline_step_s", "model_flops_for", "PEAK_FLOPS", "HBM_BW"]
