"""Roofline step time for the perf model (`analysis.roofline_step_s`)."""
from repro_torch.roofline.analysis import HBM_BW, PEAK_FLOPS, roofline_step_s

__all__ = ["roofline_step_s", "PEAK_FLOPS", "HBM_BW"]
