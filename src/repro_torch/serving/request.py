"""Serving request/response types shared by engine, frontend, and client.

`Request` is the *internal, mutable* unit of work that flows through the
frontend, nodes, and engines.  Public callers should use the frozen types
in `repro.api` (`GenerationRequest` / `GenerationResponse` /
`StreamEvent`); the Gateway translates between the two.

Streaming contract: engines (and accounted-mode nodes) deliver every
generated token through `Request.emit`, which invokes the `on_token`
callback, and report completion through `Request.finish`, which invokes
`on_finish` exactly once.  The frontend suppresses `on_finish` while it is
still retrying across replicas so a handle never observes a transient
attempt failure as the final outcome.
"""
from __future__ import annotations

import dataclasses
import enum
import itertools
import time
from typing import Callable, List, Optional

from repro_torch.serving.sampler import SamplingParams

_ids = itertools.count()


class RequestState(enum.Enum):
    QUEUED = "queued"
    PREFILLING = "prefilling"
    DECODING = "decoding"
    FINISHED = "finished"
    FAILED = "failed"


# Internal error-code strings; mirrored 1:1 by `repro.api.types.ErrorCode`
# so the gateway never has to parse human-readable error messages.
CODE_NO_BACKEND = "no_backend"
CODE_OVERLOADED = "overloaded"
CODE_ENGINE_FAILED = "engine_failed"
CODE_CANCELLED = "cancelled"
CODE_TIMEOUT = "timeout"
CODE_INVALID_REQUEST = "invalid_request"
CODE_RATE_LIMITED = "rate_limited"


@dataclasses.dataclass
class Request:
    model: str
    prompt: List[int]                         # token ids
    sampling: SamplingParams = dataclasses.field(
        default_factory=SamplingParams)
    tenant: str = ""                          # multi-tenant accounting key
    request_id: int = dataclasses.field(default_factory=lambda: next(_ids))
    state: RequestState = RequestState.QUEUED
    output: List[int] = dataclasses.field(default_factory=list)
    created_at: float = dataclasses.field(default_factory=time.monotonic)
    first_token_at: Optional[float] = None
    finished_at: Optional[float] = None
    error: str = ""
    error_code: str = ""
    cancelled: bool = False
    # routing metadata (filled by frontend)
    node: str = ""
    replica: str = ""
    retries: int = 0
    # cumulative WFQ virtual-clock debit this request has paid on its
    # current replica — lets the scheduler charge served tokens exactly
    # once across preempt/resume cycles instead of re-billing the
    # remaining budget at every re-admission
    wfq_charged: float = 0.0
    # streaming hooks (set by the Gateway; None => no-op)
    on_token: Optional[Callable[["Request", int], None]] = \
        dataclasses.field(default=None, repr=False)
    on_finish: Optional[Callable[["Request"], None]] = \
        dataclasses.field(default=None, repr=False)
    # routing-in-progress: the frontend holds finish callbacks until the
    # retry loop settles on a final outcome
    _suppress_finish: bool = dataclasses.field(
        default=False, init=False, repr=False)
    _finish_fired: bool = dataclasses.field(
        default=False, init=False, repr=False)

    @property
    def ttft(self) -> Optional[float]:
        if self.first_token_at is None:
            return None
        return self.first_token_at - self.created_at

    @property
    def latency(self) -> Optional[float]:
        if self.finished_at is None:
            return None
        return self.finished_at - self.created_at

    # ------------------------------------------------------------- #
    def emit(self, tok: int):
        """Deliver one generated token (engine -> stream callback)."""
        if self.first_token_at is None:
            self.first_token_at = time.monotonic()
        self.output.append(tok)
        if self.on_token is not None:
            self.on_token(self, tok)

    def emit_many(self, toks):
        """Deliver a block of tokens (one fused K-step engine dispatch).
        Drives the per-token `emit` path in order, so the streaming
        contract is byte-identical to K sequential `emit`s."""
        for tok in toks:
            self.emit(tok)

    def finish(self, error: str = "", code: str = ""):
        self.finished_at = time.monotonic()
        self.error = error
        self.error_code = code or (CODE_ENGINE_FAILED if error else "")
        self.state = RequestState.FAILED if error else RequestState.FINISHED
        self._fire_finish()

    def _fire_finish(self):
        if self._suppress_finish or self._finish_fired:
            return
        self._finish_fired = True
        if self.on_finish is not None:
            self.on_finish(self)

    def reset_for_retry(self):
        """Failover/migration reset: clear a failed attempt so the request
        can be resubmitted to the next-best replica.  The emitted-token
        journal (`output`) is authoritative and survives untouched — a
        mid-stream migration resumes from `prompt + output` with the
        remaining budget, never replaying or dropping tokens."""
        self.retries += 1
        self.state = RequestState.QUEUED
        self.error = ""
        self.error_code = ""
        self.finished_at = None
        self._finish_fired = False
        # exactly-once billing across replicas: floor the WFQ debit at
        # the tokens already served, so the next replica's clock bills
        # only the remaining budget (zero served => starts over, the old
        # pre-token failover behaviour)
        self.wfq_charged = float(len(self.output))
