"""The flash kernel's share of its roofline in the traced slice, in %:
the sum over its launches of max(operations / 989 TFLOP/s, bytes / 3.35
TB/s) (`flops.flash_bound_s`: the pairs the causal mask leaves visible;
Q, K, V read once, O written once; shapes recorded by a wrapper on
`ops.flash_attention`) over the device time of its kernels."""


def read(rec):
    t = rec.get("trace")
    if not t or t["flash_device_s"] <= 0 or t["flash_bound_s"] <= 0:
        return None
    return 100.0 * t["flash_bound_s"] / t["flash_device_s"]
