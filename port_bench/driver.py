"""The window: one thread drives `InferenceEngine.submit` and `.step` and
keeps the clock.

Before each `step()` it submits every request whose time has come: an
open loop's at their due times, a closed loop's when its client's
previous request finished (and, for the first, when the traffic
starts).  Host times come from each request's `on_token` and
`on_finish` callbacks.  The traffic starts `ramp_s` before the window
opens; requests sent inside the window are followed to completion after
it closes, with traffic still flowing, for at most `DRAIN_S` seconds.
"""
from __future__ import annotations

import dataclasses
import heapq
import time
from typing import Dict, List, Optional

from port_bench import flops

DRAIN_S = 60.0


@dataclasses.dataclass
class Rec:
    """What the benchmark keeps of one request."""
    index: int
    tenant: int
    prompt: List[int]
    budget: int
    due: float
    client: int = -1
    first: Optional[float] = None
    last: Optional[float] = None
    first_step: int = -1
    done: Optional[float] = None
    error: str = ""
    output: List[int] = dataclasses.field(default_factory=list)


class Driver:
    def __init__(self, engine, traffic, model: Dict, clock=time.perf_counter,
                 tracer=None, trace_s: float = 0.0):
        self.engine = engine
        self.traffic = traffic
        self.model = model
        self.clock = clock
        self.tracer = tracer
        self.trace_s = trace_s
        self.recs: List[Rec] = []
        self.finished: List[Rec] = []
        self._done_now: List[Rec] = []
        self.step_no = 0
        self.w0 = self.w1 = float("inf")
        # tallies kept by the callbacks: output tokens inside the window,
        # and each step's decode work
        self.window_tokens = 0
        self.decode_flops: Dict[int, float] = {}
        self.traced_tokens = 0
        self._rows: Dict[int, list] = {}       # traced step: slot rows

    # ---- callbacks ---------------------------------------------- #
    def _on_token(self, rec: Rec, req, tok: int) -> None:
        t = self.clock()
        i = len(req.output) - 1
        if rec.first is None:
            rec.first, rec.first_step = t, self.step_no
        rec.last = t
        if self.w0 <= t < self.w1:
            self.window_tokens += 1
        if i >= 1:
            self.decode_flops[self.step_no] = self.decode_flops.get(
                self.step_no, 0.0) + flops.decode_flops(
                    self.model, len(rec.prompt) + i)
        if self.tracer is not None and self.tracer.active:
            self.traced_tokens += 1
            if i >= 1:
                row = self._rows.setdefault(rec.index,
                                            [len(rec.prompt) + i, 0])
                row[1] += 1

    def _on_finish(self, rec: Rec, req) -> None:
        rec.done = self.clock()
        rec.error = req.error
        rec.output = req.output
        self._done_now.append(rec)

    def _submit(self, i: int, tenant: int, due: float, client: int = -1):
        from repro_torch.serving import Request, SamplingParams
        shape = self.traffic.request(i, tenant)
        rec = Rec(i, shape.tenant, shape.prompt, shape.max_tokens, due,
                  client)
        self.recs.append(rec)
        req = Request(model=self.model["name"], prompt=shape.prompt,
                      sampling=SamplingParams(max_tokens=shape.max_tokens,
                                              temperature=0.0, eos_id=-1),
                      tenant=f"t{shape.tenant}",
                      on_token=lambda r, tok, rec=rec: self._on_token(
                          rec, r, tok),
                      on_finish=lambda r, rec=rec: self._on_finish(rec, r))
        self.engine.submit(req)

    # ---- the loop ---------------------------------------------- #
    def run(self, ramp_s: float, seconds: float) -> Dict:
        tr = self.traffic
        eng = self.engine
        rng = self.tracer.range if self.tracer is not None else _null
        t0 = self.clock()
        self.w0, self.w1 = t0 + ramp_s, t0 + ramp_s + seconds
        closed = tr.loop == "closed"
        heap = ([(t0, c) for c in range(tr.clients)]
                if closed else [])
        heapq.heapify(heap)
        n_sent = 0
        next_due = t0 + tr.arrival(0) if not closed else None
        snaps: Dict[str, Dict] = {}
        traced: Dict = {}
        # a traced run profiles trace_s seconds from the window's last
        # trace_s
        trace_from = max(self.w1 - self.trace_s, self.w0)
        decode_bound = 0.0
        backlog: List[tuple] = []
        while True:
            now = self.clock()
            if "open" not in snaps and now >= self.w0:
                snaps["open"] = self._snapshot(now)
            if self.tracer is not None and not traced and now >= trace_from:
                snaps["trace"] = self._snapshot(now)
                self.tracer.start()
                traced["t0"] = self.clock()
            if self.tracer is not None and self.tracer.active \
                    and now >= traced["t0"] + self.trace_s:
                traced["t1"] = self.tracer.stop(self.clock)
            if "close" not in snaps and now >= self.w1:
                snaps["close"] = self._snapshot(now)
            if now >= self.w1 and all(r.done is not None for r in self.recs
                                      if r.due < self.w1):
                break
            if now >= self.w1 + DRAIN_S:
                break
            with rng("bench.submit"):
                if closed:
                    while heap and heap[0][0] <= now:
                        _, c = heapq.heappop(heap)
                        self._submit(n_sent, tr.client_tenant(c), now, c)
                        n_sent += 1
                else:
                    while next_due <= now:
                        self._submit(n_sent, None, next_due)
                        n_sent += 1
                        next_due = t0 + tr.arrival(n_sent)
            if eng.slot_req or eng.scheduler.depth:
                decodes = eng.decode_dispatches
                traced_step = self.tracer is not None and self.tracer.active
                with rng("engine.step"):
                    eng.step()
                self.step_no += 1
                if traced_step and eng.decode_dispatches > decodes:
                    # the paged kernel's bound over this step's block,
                    # from the lengths alone
                    decode_bound += flops.decode_block_bound_s(
                        self.model, eng.ecfg.n_slots,
                        [tuple(v) for v in self._rows.values()],
                        eng.ecfg.decode_block, eng.ecfg.page_size,
                        2 if self.model["dtype"] == "bf16" else 4)
                self._rows = {}
            else:
                wake = min(heap[0][0] if heap else self.w1,
                           next_due if next_due is not None else self.w1,
                           self.w0 if now < self.w0 else self.w1)
                with rng("bench.wait"):
                    time.sleep(min(max(wake - now, 0.0), 0.05))
            with rng("bench.callbacks"):
                for rec in self._done_now:
                    self.finished.append(rec)
                    if closed and rec.client >= 0 and now < self.w1 + DRAIN_S:
                        heapq.heappush(heap, (rec.done, rec.client))
                self._done_now = []
                if self.w0 <= now < self.w1:
                    backlog.append((now, n_sent - len(self.finished)))
        if self.tracer is not None and self.tracer.active:
            traced["t1"] = self.tracer.stop(self.clock)
        snaps.setdefault("close", self._snapshot(self.clock()))
        return {"snaps": snaps, "traced": traced,
                "decode_bound_s": decode_bound, "backlog": backlog,
                "sent": n_sent}

    def _snapshot(self, now: float) -> Dict:
        st = self.engine.perf_stats()
        return {"t": now, "step": self.step_no,
                "prefill_dispatch_tokens": st["prefill_dispatch_tokens"]}


class _NullRange:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def _null(name: str) -> _NullRange:
    return _NullRange()
