"""Two-level request scheduler for the continuous-batching engine.

Level 1 — **tenant fairness**: every tenant gets its own FCFS queue, and
admission order across tenants is weighted fair queuing in the
deficit/virtual-time family (start-time fair queuing): every tenant
carries a *virtual service* clock that advances by
`projected_served_tokens / weight` on each admission, and each round
serves the backlogged tenant with the smallest clock whose head fits the
engine's free *page* budget.  Under contention, served-token shares
converge to the configured `TenantQuota.weight`s even across mixed
prompt lengths and budgets; a tenant joining (or returning from idle)
starts at the current system virtual time, so idling never banks
credit and a newcomer cannot monopolize the engine.  The engine reads
each tenant's `deficit` (the negated clock) to pick preemption victims:
the lowest deficit is the most recently over-served tenant.

Level 2 — **continuous batching admission**: at every decode-block
boundary the engine asks for one prefill bucket; the scheduler hands back
the chosen tenant's head plus later same-bucket requests from that tenant
(one jitted prefill serves the whole batch), bounded by free slots, the
per-step prefill cap, and the free *page* budget.  Preempted requests
re-enter at the front of their tenant queue via `requeue` (they already
waited once).

Page accounting: when the engine wires `pages_for`, every queued request
reserves its projected page need in `pending_pages` (an autoscale
pressure signal); reservations drop on dequeue, cancel, and close.

The queue is guarded by a lock: with the `ServingRuntime` started,
callers submit from arbitrary threads while each node's pump thread
dequeues.  Tracks queue metrics (depth, total enqueued, head wait) the
SDAI controller's load-feedback tick uses for rebalancing decisions.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from collections import OrderedDict, deque
from typing import Callable, Deque, Dict, List, Optional

from repro_torch.serving.request import (CODE_ENGINE_FAILED, CODE_OVERLOADED,
                                   Request, RequestState)


@dataclasses.dataclass
class SchedulerConfig:
    max_prefill_per_step: int = 4
    max_queue: int = 256              # across all tenant queues


class Scheduler:
    def __init__(self, cfg: Optional[SchedulerConfig] = None,
                 weight_of: Optional[Callable[[str], float]] = None):
        self.cfg = cfg if cfg is not None else SchedulerConfig()
        # tenant -> FCFS queue; OrderedDict keeps a stable visit order
        self._queues: "OrderedDict[str, Deque[Request]]" = OrderedDict()
        # weighted virtual-service clocks (tokens / weight); the smallest
        # backlogged clock is served next.  `_vclock` is the monotonic
        # *system* virtual time (start tag of the last admission): the
        # floor a joining tenant starts at, so a newcomer can neither
        # bank credit nor leapfrog an incumbent whose queue happened to
        # be momentarily empty.
        self._vtime: Dict[str, float] = {}
        self._vclock = 0.0
        # installed by the controller at deploy time; defaults to equal
        # weights so standalone engines behave like plain FCFS+DWRR(1)
        self.weight_of: Callable[[str], float] = weight_of or (lambda t: 1.0)
        # installed by the engine: projected page cost of a request; when
        # absent, costs fall back to 1 (request-count fairness)
        self.pages_for: Optional[Callable[[Request], int]] = None
        self.rejected = 0
        self.enqueued_total = 0
        self.dequeued_total = 0
        self.requeued_total = 0
        self._depth = 0            # plain int: read lock-free by pumps
        self.pending_pages = 0
        self._pending: Dict[int, int] = {}    # request_id -> reserved pages
        self.closed = False
        self._lock = threading.Lock()

    # ---------------------------------------------------------------- #
    def _weight(self, tenant: str) -> float:
        try:
            w = float(self.weight_of(tenant))
        except Exception:
            w = 1.0
        return max(w, 1e-3)        # zero/negative weights cannot starve

    def _cost(self, req: Request) -> float:
        """DWRR debit, in *projected served tokens* (the remaining
        generation budget): what a tenant's weight buys is output
        tokens, so served-token shares converge to the weights even
        when tenants mix prompt lengths and budgets."""
        return float(max(req.sampling.max_tokens - len(req.output), 1))

    def _charge(self, req: Request) -> float:
        """Exactly-once admission debit.  The projected lifetime service
        (tokens already generated + remaining budget) is billed net of
        what this request already paid, so a preempted-then-resumed
        request — whose first admission billed its full budget — adds
        ~nothing on re-admission instead of re-billing the remainder
        and drifting its tenant's virtual clock ahead of the tokens
        actually served."""
        projected = float(len(req.output)) + self._cost(req)
        delta = max(projected - req.wfq_charged, 0.0)
        req.wfq_charged += delta
        return delta

    def _pages(self, req: Request) -> float:
        if self.pages_for is None:
            return 0.0
        return float(max(self.pages_for(req), 0))

    def _reserve(self, req: Request):
        pages = int(self.pages_for(req)) if self.pages_for else 0
        self._pending[req.request_id] = pages
        self.pending_pages += pages

    def _unreserve(self, req: Request):
        self.pending_pages -= self._pending.pop(req.request_id, 0)

    def _enqueue(self, req: Request, front: bool = False):
        q = self._queues.get(req.tenant)
        if q is None:
            q = self._queues[req.tenant] = deque()
        if not q:
            # (re)joining the backlog: start no earlier than the system
            # virtual time — idling banks no credit, and a newcomer
            # cannot starve an incumbent whose clock ran ahead
            self._vtime[req.tenant] = max(
                self._vtime.get(req.tenant, 0.0), self._vclock)
        if front:
            q.appendleft(req)
        else:
            q.append(req)
        self._depth += 1
        self._reserve(req)

    # ---------------------------------------------------------------- #
    def submit(self, req: Request) -> bool:
        with self._lock:
            # closed is checked under the same lock close()+drain() hold,
            # so a submit racing an engine failure either lands in the
            # queue before the drain (and is finished by it) or is
            # rejected here — never stranded in a dead engine's queue
            if self.closed:
                error, code = "engine closed", CODE_ENGINE_FAILED
            elif self.depth >= self.cfg.max_queue:
                self.rejected += 1
                error, code = "queue full", CODE_OVERLOADED
            else:
                req.state = RequestState.QUEUED
                self._enqueue(req)
                self.enqueued_total += 1
                error = code = ""
        if error:
            # finish outside the lock: callbacks may re-route the request
            req.finish(error=error, code=code)
            return False
        return True

    def requeue(self, req: Request) -> None:
        """Preemption path: a request evicted from its slot re-enters at
        the *front* of its tenant queue (it already waited its turn) and
        bypasses the queue cap — a preempted request is never dropped."""
        with self._lock:
            if self.closed:
                pass               # drained by close(); finish below
            else:
                req.state = RequestState.QUEUED
                self._enqueue(req, front=True)
                self.requeued_total += 1
                return
        req.finish(error="engine closed", code=CODE_ENGINE_FAILED)

    def cancel(self, request_id: int) -> bool:
        """Drop a still-queued request, releasing its pending-pages
        reservation (the charge the page-aware admission planner holds
        for it)."""
        with self._lock:
            for tenant, q in self._queues.items():
                for req in q:
                    if req.request_id == request_id:
                        q.remove(req)
                        self._depth -= 1
                        self._unreserve(req)
                        return True
        return False

    def close(self) -> List[Request]:
        """Engine failure path: atomically stop accepting submits and
        hand back everything queued so the caller can fail it."""
        with self._lock:
            self.closed = True
            out = [r for q in self._queues.values() for r in q]
            self._queues.clear()
            self._vtime.clear()
            self._vclock = 0.0
            self._pending.clear()
            self.pending_pages = 0
            self._depth = 0
        return out

    # ---------------------------------------------------------------- #
    def next_prefill_bucket(self, free_slots: int,
                            bucket_of: Callable[[int], int],
                            free_pages: Optional[int] = None
                            ) -> List[Request]:
        """One WFQ admission round.  Dequeue the winning tenant's head
        plus up to `max_prefill_per_step - 1` later requests from the
        *same tenant* whose effective prompts fall in the same length
        bucket, so the engine prefills them together in one jitted call.
        The winner is the backlogged tenant with the smallest weighted
        virtual-service clock; every admission advances the clock by
        `projected_tokens / weight`.  `free_pages` (None =>
        unconstrained) bounds admissions by the engine's free page
        budget; when no backlogged tenant's head fits, nothing is
        admitted this round (pages free up at the next decode block, or
        the engine preempts)."""
        with self._lock:
            n = min(free_slots, self.cfg.max_prefill_per_step, self.depth)
            if n <= 0:
                return []
            for tenant in list(self._queues):     # drop drained queues
                if not self._queues[tenant]:
                    del self._queues[tenant]
            # smallest backlogged clock wins; page-blocked tenants sit
            # the round out (their clock stands still, so they win as
            # soon as pages free up)
            best, best_key = None, None
            for tenant, q in self._queues.items():
                if free_pages is not None \
                        and self._pages(q[0]) > free_pages:
                    continue
                key = (self._vtime.get(tenant, 0.0), q[0].created_at)
                if best_key is None or key < best_key:
                    best, best_key = tenant, key
            if best is None:
                return []
            w = self._weight(best)
            # system virtual time advances to the winner's start tag
            self._vclock = max(self._vclock,
                               self._vtime.get(best, 0.0))
            q = self._queues[best]
            head = q.popleft()
            self._depth -= 1
            self._unreserve(head)
            budget = (free_pages - self._pages(head)
                      if free_pages is not None else None)
            self._vtime[best] = self._vtime.get(best, 0.0) \
                + self._charge(head) / w
            out = [head]
            if n > 1:
                hb = bucket_of(self._eff_len(head))
                rest: List[Request] = []
                for req in q:
                    fits = (budget is None
                            or self._pages(req) <= budget)
                    if len(out) < n and fits \
                            and bucket_of(self._eff_len(req)) == hb:
                        out.append(req)
                        self._depth -= 1
                        self._unreserve(req)
                        self._vtime[best] += self._charge(req) / w
                        if budget is not None:
                            budget -= self._pages(req)
                    else:
                        rest.append(req)
                self._queues[best] = deque(rest)
            self.dequeued_total += len(out)
            return out

    @staticmethod
    def _eff_len(req: Request) -> int:
        """Effective prompt length: original prompt plus any tokens
        already generated before a preemption (a resumed request
        re-prefills its full context)."""
        return len(req.prompt) + len(req.output)

    # ---------------------------------------------------------------- #
    def deficit(self, tenant: str) -> float:
        """The tenant's fair-queuing deficit: the negated weighted
        virtual-service clock — the engine's eviction-victim signal
        (lowest deficit == most service consumed per unit weight ==
        most recently over-served)."""
        with self._lock:
            return -self._vtime.get(tenant, 0.0)

    def tenant_backlog(self) -> Dict[str, int]:
        with self._lock:
            return {t: len(q) for t, q in self._queues.items() if q}

    @property
    def depth(self) -> int:
        return self._depth

    def head_wait_s(self, now: Optional[float] = None) -> float:
        """Age of the oldest queued request — the controller's pressure
        signal (a deep-but-draining queue is fine; a stale head is not)."""
        with self._lock:
            heads = [q[0].created_at for q in self._queues.values() if q]
            if not heads:
                return 0.0
            t = time.monotonic() if now is None else now
            return max(0.0, t - min(heads))
