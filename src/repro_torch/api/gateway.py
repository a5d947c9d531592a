"""Gateway API v1 — the unified serving facade.

One `Gateway` fronts the whole fleet (the paper's "single logical unit"):

* `generate()`        — blocking call, returns a frozen `GenerationResponse`
* `submit()`          — returns a `GenerationHandle` (async future) with
                        `.result()`, `.cancel()` and `.stream()` (a true
                        incremental token iterator driven by per-token
                        engine callbacks, surviving failover retries)
* `generate_batch()`  — submit many, block until all settle
* admission control   — per-model in-flight and backend queue-depth caps
                        return structured 429-style `OVERLOADED` rejections;
                        per-tenant token buckets return `RATE_LIMITED`
* `.admin`            — the typed control plane (`repro.api.admin.AdminAPI`)
* `start()`/`stop()`  — the continuous serving runtime: background pump
                        threads drive every node and a tick loop feeds
                        load into the SDAI controller, so `submit()` is
                        fire-and-forget and blocking calls wait on events

Without `start()` the fleet is hand-pumped exactly as before: handles
advance engines lazily via `Gateway._pump()` whenever a caller blocks.
Either way blocking calls honor a *wall-clock* deadline
(`GatewayConfig.default_timeout_s`, overridable per call) and surface
`ErrorCode.TIMEOUT` — never a spurious pump-count failure.  Tokens surface
in K-token quanta (`EngineConfig.decode_block`); `cancel()` takes effect at
the next dispatch boundary.

This file differs from `repro.api.gateway` in one place: with the runtime
started, `result()` waits on the handle's condition until the request is
done.  The reference returns from its wait whenever a token event is
queued, and `result()` never consumes those events, so after the first
token its caller spins holding the interpreter lock.  The reference's
engine steps in a few long calls that release the lock; the port's step
is many short torch calls, each of which must win the lock back
from the spinning caller, which slowed a CPU step of the reduced model
from milliseconds to seconds.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from collections import deque
from typing import Deque, Dict, Iterator, List, Optional, Sequence, Union

from repro_torch.api.admin import AdminAPI
from repro_torch.api.runtime import RuntimeConfig, ServingRuntime
from repro_torch.api.types import (APIError, ErrorCode, GenerationRequest,
                             GenerationResponse, StreamEvent,
                             StreamEventType, response_from_internal)
from repro_torch.core.controller import SDAIController
from repro_torch.core.events import REQUEST_MIGRATED
from repro_torch.serving.request import (CODE_CANCELLED, CODE_ENGINE_FAILED,
                                   CODE_TIMEOUT, Request, RequestState)
from repro_torch.serving.sampler import SamplingParams


@dataclasses.dataclass
class GatewayConfig:
    # admission control (None => unlimited, the seed behaviour)
    max_inflight_per_model: Optional[int] = None
    max_queue_depth_per_model: Optional[int] = None
    # liveness: wall-clock budget for blocking waits (result / stream /
    # generate_batch); per-call `timeout_s` overrides
    default_timeout_s: float = 60.0
    # transparent recovery budget for a request whose backend died:
    # before the first token the request is re-routed fresh; after it,
    # the emitted-token journal migrates to a surviving replica and the
    # stream resumes where it left off — tokens are never re-emitted.
    # Only when no healthy replica remains (or the budget is spent) does
    # the failure surface as a structured ERROR event.
    max_stream_retries: int = 2


@dataclasses.dataclass
class GatewayStats:
    submitted: int = 0
    completed: int = 0
    rejected_overloaded: int = 0
    rejected_draining: int = 0
    rejected_rate_limited: int = 0
    cancelled: int = 0
    stream_retries: int = 0    # pre-token re-routes (fresh request)
    migrations: int = 0        # mid-stream journal migrations
    timeouts: int = 0
    caller_pumps: int = 0      # hand-pump fallback iterations; stays 0
                               # while the runtime drives the fleet


class GenerationHandle:
    """Future for one in-flight generation.  Created by `Gateway.submit`;
    never constructed directly.  Thread-safe: pump threads append events
    and signal `_cv`; the owning caller blocks on it."""

    def __init__(self, gateway: "Gateway", request: GenerationRequest):
        self._gw = gateway
        self.request = request
        self.internal: Optional[Request] = None   # current routing attempt
        self._events: Deque[StreamEvent] = deque()
        self._cv = threading.Condition()
        self._emitted = 0          # tokens delivered to this handle
        self._retries_left = gateway.cfg.max_stream_retries
        self._admitted = False
        self._done = False
        self._response: Optional[GenerationResponse] = None

    # ------------------------------------------------------------- #
    @property
    def done(self) -> bool:
        return self._done

    @property
    def response(self) -> Optional[GenerationResponse]:
        return self._response

    # ---- wiring: callbacks installed on the internal request ------ #
    def _on_token(self, req: Request, tok: int):
        if req is not self.internal or self._done:
            return
        with self._cv:
            self._events.append(StreamEvent(StreamEventType.TOKEN,
                                            token=tok,
                                            index=self._emitted))
            self._emitted += 1
            self._cv.notify_all()

    def _on_finish(self, req: Request):
        if req is not self.internal or self._done:
            return
        with self._cv:                 # _on_token writes under _cv
            emitted = self._emitted
        if (req.error_code == CODE_ENGINE_FAILED and not req.cancelled
                and emitted > 0
                and len(req.output) >= req.sampling.max_tokens):
            # the journal is already complete: the backend died between
            # its last token and the finish bookkeeping — every token
            # was delivered, so this is a success, not a failure
            req.error, req.error_code = "", ""
            req.state = RequestState.FINISHED
            self._finalize(req)
            return
        if (req.error_code == CODE_ENGINE_FAILED and not req.cancelled
                and self._retries_left > 0):
            if emitted == 0:
                # backend died before the stream produced anything:
                # re-route transparently on a fresh internal request
                self._retries_left -= 1
                with self._gw._stats_lock:
                    self._gw.stats.stream_retries += 1
                retry = self._gw._make_internal(self.request, self)
                retry.retries = req.retries + 1
                self.internal = retry
                if self._gw.c.frontend.submit(retry):
                    return      # re-routed; stream continues seamlessly
                if not retry._finish_fired and retry.finished_at is None:
                    # defensive: frontend always finishes on failure
                    retry.finish(error=req.error, code=req.error_code)
                return          # retry's own on_finish finalized us
            if self._gw.c.frontend.healthy_replicas(req.model):
                # mid-stream migration: the emitted-token journal on the
                # SAME internal request is authoritative.  The surviving
                # engine re-admits it as prompt + output (through the
                # prefix cache, suffix-only prefill on a shared prefix)
                # with the remaining budget, and emits only *new* tokens
                # — the handle's stream resumes with no duplicated,
                # lost, or reordered tokens.  `reset_for_retry` floors
                # `wfq_charged` at the served tokens so the new
                # replica's WFQ clock bills only the remainder, and the
                # tenant token bucket (charged once at admission) is
                # never touched again.
                self._retries_left -= 1
                with self._gw._stats_lock:
                    self._gw.stats.migrations += 1
                src, err, code = req.node, req.error, req.error_code
                n_resumed = len(req.output)
                req.reset_for_retry()
                if self._gw.c.frontend.submit(req):
                    self._gw.c.bus.emit(
                        REQUEST_MIGRATED, request_id=req.request_id,
                        tenant=req.tenant, model=req.model,
                        from_node=src, to_node=req.node,
                        tokens_resumed=n_resumed)
                    return      # resumed; stream continues seamlessly
                if not req._finish_fired and req.finished_at is None:
                    # defensive: frontend always finishes on failure
                    req.finish(error=err, code=code)
                return          # the failure finish re-entered _on_finish
                                # and finalized us
        self._finalize(req)

    def _finalize(self, req: Request):
        with self._cv:
            if self._done:
                return
            self._response = resp = response_from_internal(req)
            if self._admitted:
                self._gw._release(self.request.model)
                self._admitted = False
                with self._gw._stats_lock:      # settled admitted
                    self._gw.stats.completed += 1   # requests only,
                                                    # not rejections
            if resp.error is not None:
                self._events.append(StreamEvent(StreamEventType.ERROR,
                                                response=resp,
                                                error=resp.error))
            else:
                self._events.append(StreamEvent(StreamEventType.FINISH,
                                                response=resp))
            # `_done` goes last: result()/stream() read it without the
            # lock, so everything they may touch afterwards (_response,
            # the terminal event) must already be in place
            self._done = True
            self._cv.notify_all()

    def _reject(self, error: APIError):
        """Admission rejection: finish immediately, never routed."""
        req = self.internal
        req.finish(error=error.message, code=error.code.value)

    # ------------------------------------------------------------- #
    def _deadline(self, timeout_s: Optional[float]) -> float:
        t = timeout_s if timeout_s is not None \
            else self._gw.cfg.default_timeout_s
        return time.monotonic() + t

    def _wait_for_progress(self, deadline: float,
                           until_done: bool = False):
        """Block until an event may be available (`until_done`: until the
        request may be done).  Runtime mode: wait on the handle condition
        (pump threads signal it).  Hand-pump mode: advance the fleet one
        iteration."""
        if self._gw.runtime_active:
            with self._cv:
                if self._done or (self._events and not until_done):
                    return
                self._cv.wait(min(0.05,
                                  max(1e-4, deadline - time.monotonic())))
        else:
            self._gw._pump()

    def stream(self, timeout_s: Optional[float] = None
               ) -> Iterator[StreamEvent]:
        """Yield `StreamEvent`s incrementally; blocks between deltas (on
        pump-thread signals with the runtime started, hand-pumping
        otherwise).  Always ends with exactly one terminal FINISH/ERROR.
        The wall-clock deadline spans the whole stream; on expiry the
        request finishes with `ErrorCode.TIMEOUT`."""
        deadline = self._deadline(timeout_s)
        while True:
            while True:
                with self._cv:
                    if not self._events:
                        break
                    ev = self._events.popleft()
                yield ev
                if ev.terminal:
                    return
            if self._done:
                return
            if time.monotonic() >= deadline:
                self._timeout()
                continue
            self._wait_for_progress(deadline)

    def result(self, timeout_s: Optional[float] = None
               ) -> GenerationResponse:
        """Block until this request completes (or the wall-clock deadline
        expires -> `ErrorCode.TIMEOUT`)."""
        deadline = self._deadline(timeout_s)
        while not self._done:
            if time.monotonic() >= deadline:
                self._timeout()
                break
            self._wait_for_progress(deadline, until_done=True)
        return self._response

    def _cancel_backend(self, req: Request):
        """Abort `req` on its backend.  When it was still *queued* (not
        occupying a slot), refund the tenant token-bucket charge for the
        tokens it will now never generate — the bucket was debited the
        full `max_tokens` at submit.  Tokens already generated (a
        preempted-then-requeued request carries its output) stay
        charged: that engine work was consumed and delivered."""
        if not (req.node and req.replica):
            return
        node = self._gw.c.fleet.nodes.get(req.node)
        if node is None:
            return
        verdict = node.cancel(int(req.replica), req.request_id)
        if verdict == "queued":
            unserved = req.sampling.max_tokens - len(req.output)
            if unserved > 0:
                self._gw.c.frontend.tenants.refund(req.tenant, unserved)

    def cancel(self) -> bool:
        """Abort the request, freeing its engine slot and pages.  Returns
        False if already finished.  Cancelling a request that was still
        queued refunds the unconsumed part of its tenant token-bucket
        charge."""
        if self._done:
            return False
        req = self.internal
        self._cancel_backend(req)
        req.cancelled = True
        with self._gw._stats_lock:
            self._gw.stats.cancelled += 1
        if req.finished_at is None:
            req.finish(error="cancelled by client", code=CODE_CANCELLED)
        else:                       # finished while suppressed? finalize
            self._finalize(req)
        return True

    def _timeout(self):
        req = self.internal
        if self._done:
            return
        with self._gw._stats_lock:
            self._gw.stats.timeouts += 1
        # same refund semantics as cancel(): a request that timed out
        # while still queued never consumed the capacity it was charged
        self._cancel_backend(req)
        if req.finished_at is None:
            req.finish(error="wall-clock deadline exceeded",
                       code=CODE_TIMEOUT)
        elif not self._done:
            self._finalize(req)


class Gateway:
    """The single public entry point over `SDAIController` + frontend."""

    def __init__(self, controller: SDAIController,
                 cfg: Optional[GatewayConfig] = None):
        self.c = controller
        self.cfg = cfg if cfg is not None else GatewayConfig()
        self.stats = GatewayStats()
        self.admin = AdminAPI(controller, gateway=self)
        self.runtime: Optional[ServingRuntime] = None
        self._inflight: Dict[str, int] = {}
        self._inflight_lock = threading.Lock()
        self._stats_lock = threading.Lock()
        self._draining: set = set()

    # ---- continuous runtime lifecycle ----------------------------- #
    @property
    def runtime_active(self) -> bool:
        return self.runtime is not None and self.runtime.running

    def start(self, cfg: Optional[RuntimeConfig] = None) -> ServingRuntime:
        """Start the continuous serving runtime: one pump thread per
        node plus the controller tick loop.  Idempotent."""
        if self.runtime_active:
            return self.runtime
        self.runtime = ServingRuntime(self, cfg)
        return self.runtime.start()

    def stop(self, drain: bool = True,
             timeout_s: Optional[float] = None) -> bool:
        """Stop the runtime, draining in-flight work by default.
        Returns True when every runtime thread joined."""
        if self.runtime is None:
            return True
        return self.runtime.stop(drain=drain, timeout_s=timeout_s)

    # ------------------------------------------------------------- #
    def models(self) -> List[str]:
        """Every model currently served behind the unified endpoint."""
        return self.c.replicas.models()

    def inflight(self, model: str) -> int:
        with self._inflight_lock:
            return self._inflight.get(model, 0)

    # ------------------------------------------------------------- #
    def _pump(self):
        """Hand-pump fallback (runtime not started): advance the whole
        fleet one iteration from the calling thread."""
        with self._stats_lock:
            self.stats.caller_pumps += 1
        self.c.fleet.pump()

    def _release(self, model: str):
        with self._inflight_lock:
            n = self._inflight.get(model, 0)
            if n > 0:
                self._inflight[model] = n - 1

    def _queue_depth(self, model: str) -> int:
        """Aggregate scheduler backlog across the model's live replicas."""
        depth = 0
        for info in self.c.replicas.for_model(model):
            node = self.c.fleet.nodes.get(info.key.node_id)
            if node is None or not node.alive:
                continue
            inst = node.instances.get(info.key.instance_id)
            if inst is not None and inst.engine is not None:
                depth += inst.engine.scheduler.depth
        return depth

    def _max_prompt_len(self, model: str) -> Optional[int]:
        """Largest prompt any live replica of `model` can hold — replica
        context minus the model's prefix (meta/vision) tokens, which
        occupy cache slots ahead of the prompt.  None when nothing serves
        the model (NO_BACKEND handles that case)."""
        lens = [info.max_len for info in self.c.replicas.for_model(model)]
        if not lens:
            return None
        prefix = 0
        if model in self.c.catalog:
            cfg = self.c.catalog.get(model)
            prefix = (getattr(cfg, "n_meta_tokens", 0)
                      + getattr(cfg, "n_prefix_tokens", 0))
        return max(lens) - prefix

    def _validation_error(self,
                          greq: GenerationRequest) -> Optional[APIError]:
        if not greq.prompt:
            return APIError(ErrorCode.INVALID_REQUEST,
                            "prompt must contain at least one token")
        if greq.sampling.max_tokens < 1:
            return APIError(ErrorCode.INVALID_REQUEST,
                            "sampling.max_tokens must be >= 1")
        ctx = self._max_prompt_len(greq.model)
        if ctx is not None and len(greq.prompt) > ctx:
            # a prompt no replica can ever hold is malformed input (400),
            # not a transient capacity problem (429): reject at submit
            # time, before it ever reaches a backend queue
            return APIError(
                ErrorCode.INVALID_REQUEST,
                f"prompt length {len(greq.prompt)} exceeds the maximum "
                f"context {ctx} of model {greq.model!r}")
        return None

    def _try_admit(self, greq: GenerationRequest) -> Optional[APIError]:
        """Atomically run every admission gate and, on success, claim the
        in-flight slot.  Capacity checks come first so a fleet-rejected
        request never drains the tenant's token bucket; the bucket charge
        is last because it is the one check with a side effect."""
        model = greq.model
        with self._inflight_lock:
            if model in self._draining:
                return APIError(ErrorCode.DRAINING,
                                f"model {model!r} is draining")
            lim = self.cfg.max_inflight_per_model
            if lim is not None and self._inflight.get(model, 0) >= lim:
                return APIError(
                    ErrorCode.OVERLOADED,
                    f"model {model!r} at max in-flight ({lim})")
            qlim = self.cfg.max_queue_depth_per_model
            if qlim is not None and self._queue_depth(model) >= qlim:
                return APIError(
                    ErrorCode.OVERLOADED,
                    f"model {model!r} backend queue depth >= {qlim}")
            # per-tenant token buckets (frontend-owned, AdminAPI-config)
            reason = self.c.frontend.tenants.admit(
                greq.tenant, greq.sampling.max_tokens)
            if reason is not None:
                return APIError(ErrorCode.RATE_LIMITED, reason)
            self._inflight[model] = self._inflight.get(model, 0) + 1
            return None

    def _make_internal(self, greq: GenerationRequest,
                       handle: GenerationHandle) -> Request:
        return Request(model=greq.model, prompt=list(greq.prompt),
                       sampling=greq.sampling, tenant=greq.tenant,
                       on_token=handle._on_token,
                       on_finish=handle._on_finish)

    # ------------------------------------------------------------- #
    def submit(self, model: Union[str, GenerationRequest],
               prompt: Optional[Sequence[int]] = None,
               sampling: Optional[SamplingParams] = None,
               tenant: str = "") -> GenerationHandle:
        """Route one request; returns immediately with an async handle.
        Admission-control rejections come back as an already-finished
        handle whose response carries `ErrorCode.OVERLOADED`/`DRAINING`/
        `RATE_LIMITED`."""
        if isinstance(model, GenerationRequest):
            greq = model
        else:
            greq = GenerationRequest(model=model, prompt=tuple(prompt),
                                     sampling=sampling or SamplingParams(),
                                     tenant=tenant)
        handle = GenerationHandle(self, greq)
        handle.internal = self._make_internal(greq, handle)
        with self._stats_lock:
            self.stats.submitted += 1
        err = self._validation_error(greq)
        if err is not None:
            handle._reject(err)
            return handle
        err = self._try_admit(greq)    # claims the in-flight slot on None
        if err is not None:
            with self._stats_lock:
                if err.code is ErrorCode.DRAINING:
                    self.stats.rejected_draining += 1
                elif err.code is ErrorCode.RATE_LIMITED:
                    self.stats.rejected_rate_limited += 1
                else:
                    self.stats.rejected_overloaded += 1
            handle._reject(err)
            return handle
        handle._admitted = True
        self.c.frontend.submit(handle.internal)
        return handle

    def generate(self, model: Union[str, GenerationRequest],
                 prompt: Optional[Sequence[int]] = None,
                 sampling: Optional[SamplingParams] = None,
                 tenant: str = "",
                 timeout_s: Optional[float] = None) -> GenerationResponse:
        """Blocking generate: submit and wait for completion (pump
        threads drive the fleet when the runtime is started; otherwise
        this call hand-pumps)."""
        return self.submit(model, prompt, sampling,
                           tenant=tenant).result(timeout_s)

    def generate_batch(self, requests: Sequence[GenerationRequest],
                       timeout_s: Optional[float] = None
                       ) -> List[GenerationResponse]:
        """Submit a batch, then block until every request settles —
        replicas decode concurrently (continuous batching across the
        fleet).  One wall-clock deadline covers the whole batch."""
        handles = [self.submit(r) for r in requests]
        deadline = time.monotonic() + (
            timeout_s if timeout_s is not None
            else self.cfg.default_timeout_s)
        for h in handles:
            while not h.done:
                if time.monotonic() >= deadline:
                    for lh in handles:
                        if not lh.done:
                            lh._timeout()
                    break
                h._wait_for_progress(deadline)
        return [h.response for h in handles]

    def stream(self, model: Union[str, GenerationRequest],
               prompt: Optional[Sequence[int]] = None,
               sampling: Optional[SamplingParams] = None,
               tenant: str = "",
               timeout_s: Optional[float] = None) -> Iterator[StreamEvent]:
        """Convenience: submit + stream in one call."""
        return self.submit(model, prompt, sampling,
                           tenant=tenant).stream(timeout_s)
