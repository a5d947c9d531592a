"""1 - device busy time / the traced slice's length (torch.profiler; one
stream), as tools/profile_serve.py computes it."""


def read(rec):
    t = rec.get("trace")
    if not t or t["window_s"] <= 0:
        return None
    return 1.0 - t["busy_s"] / t["window_s"]
