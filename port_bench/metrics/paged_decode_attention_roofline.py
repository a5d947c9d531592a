"""The paged decode kernel's share of its roofline in the traced slice,
in %: the sum over its launches of the bound (`flops.paged_decode_bound_s`:
the visible K/V rows of each slot that emitted, q and out of every slot,
the rows' page ids; positions worked out on the host from the requests'
lengths) over the device time of its kernels."""


def read(rec):
    t = rec.get("trace")
    if not t:
        return None
    dev = t["family_s"].get("paged_decode_attention", 0.0)
    if dev <= 0 or t["decode_bound_s"] <= 0:
        return None
    return 100.0 * t["decode_bound_s"] / dev
