"""The roofline of a step from the counts of its run
(`roofline.op_profile`, `analysis.analyze`), the dry run's tables
(`roofline.report`) and its hot spots (`roofline.inspect`); the perf
model's step time (`analysis.roofline_step_s`) and a step's model FLOPs
(`analysis.model_flops_for`)."""
from repro_torch.roofline.analysis import (HBM_BW, LINK_BW, PEAK_FLOPS,
                                           Roofline, analyze,
                                           collective_bytes, model_flops_for,
                                           roofline_step_s)

__all__ = ["Roofline", "analyze", "collective_bytes", "model_flops_for",
           "roofline_step_s", "PEAK_FLOPS", "HBM_BW", "LINK_BW"]
