"""Seconds from process start to the window's opening: weights made on
the card, the engine and its KV pool, the warm-up of every shape the
traffic uses (and on a checkout's first run the kernels' build), and the
traffic's ramp (host clock)."""


def read(rec):
    return rec["setup_s"]
