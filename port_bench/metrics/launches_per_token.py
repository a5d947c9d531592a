"""CUDA kernel launches in the traced slice (the runtime's launch calls
that the profiler records, as tools/profile_serve.py counts them; the
kernels themselves where it records none) over the output tokens
delivered in it."""


def read(rec):
    t = rec.get("trace")
    if not t or not t["tokens"]:
        return None
    return (t["runtime_launches"] or t["kernels"]) / t["tokens"]
