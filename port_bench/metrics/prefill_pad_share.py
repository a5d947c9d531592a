"""1 - (prompt tokens the window's admissions had to compute, from the
benchmark's lengths) / (the change of perf_stats()["prefill_dispatch_tokens"]
over the window): the share of prefill rows x positions spent on padding
(power-of-two buckets and row counts)."""


def read(rec):
    c = rec["counters"]
    dispatched = (c["close"]["prefill_dispatch_tokens"]
                  - c["open"]["prefill_dispatch_tokens"])
    if dispatched <= 0:
        return None
    return 1.0 - rec["admitted_prompt_tokens"] / dispatched
