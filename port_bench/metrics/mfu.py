"""The whole step's share of the card's bf16 peak: useful model FLOPs
(`flops.prefill_flops` for the prompts admitted and `flops.decode_flops`
for each token decoded) over (seconds x
989 TFLOP/s), in %, over the window up to the traced slice (the
profiler slows the host inside it)."""
from port_bench import flops


def read(rec):
    if rec["counted_s"] <= 0:
        return None
    return 100.0 * rec["useful_flops"] / (rec["counted_s"]
                                          * flops.PEAK_BF16_FLOPS)
