"""Output tokens delivered to the callbacks inside the window, over the
window's seconds (host clock)."""


def read(rec):
    return rec["window_tokens"] / rec["seconds"]
