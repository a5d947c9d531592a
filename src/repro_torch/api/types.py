"""Gateway API v1 — versioned, frozen request/response types.

These are the system's *public* wire types, decoupled from the internal
mutable `repro.serving.request.Request`.  Everything here is immutable so
responses can be cached, logged, and shared across threads safely; the
`Gateway` is the only component that translates between the two worlds.

Error taxonomy (`ErrorCode`) mirrors the internal code strings set at each
failure site (frontend, scheduler, engine, node), so classification never
depends on parsing human-readable messages.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Optional, Tuple

from repro_torch.serving.request import Request
from repro_torch.serving.sampler import SamplingParams

API_VERSION = "v1"


class ErrorCode(enum.Enum):
    """Structured failure classes — the HTTP-status analogue."""
    NO_BACKEND = "no_backend"          # 503: no healthy replica serves model
    OVERLOADED = "overloaded"          # 429: admission/queue limit hit
    ENGINE_FAILED = "engine_failed"    # 500: backend crashed mid-request
    CANCELLED = "cancelled"            # 499: caller aborted the request
    TIMEOUT = "timeout"                # 504: wall-clock deadline exceeded
    DRAINING = "draining"              # 503: model is being drained
    INVALID_REQUEST = "invalid_request"  # 400: malformed request
    RATE_LIMITED = "rate_limited"      # 429: tenant token bucket empty

    @property
    def retryable(self) -> bool:
        return self in (ErrorCode.NO_BACKEND, ErrorCode.OVERLOADED,
                        ErrorCode.TIMEOUT, ErrorCode.DRAINING,
                        ErrorCode.RATE_LIMITED)


@dataclasses.dataclass(frozen=True)
class APIError:
    code: ErrorCode
    message: str

    @property
    def retryable(self) -> bool:
        return self.code.retryable


class GatewayError(RuntimeError):
    """Raised by strict API entry points; carries the structured error."""

    def __init__(self, error: APIError) -> None:
        super().__init__(f"[{error.code.value}] {error.message}")
        self.error = error


@dataclasses.dataclass(frozen=True)
class GenerationRequest:
    """One immutable generation call against the unified endpoint.
    `tenant` identifies the caller for per-tenant rate limiting and
    accounting; "" is the unlimited anonymous tenant."""
    model: str
    prompt: Tuple[int, ...]
    sampling: SamplingParams = SamplingParams()   # frozen -> safe default
    tenant: str = ""

    def __post_init__(self) -> None:
        object.__setattr__(self, "prompt", tuple(self.prompt))


@dataclasses.dataclass(frozen=True)
class GenerationResponse:
    request_id: int
    model: str
    tokens: Tuple[int, ...]
    finish_reason: str                  # "stop" | "length" | "error" |
    error: Optional[APIError] = None    # "cancelled"
    ttft: Optional[float] = None        # seconds to first token
    latency: Optional[float] = None     # seconds to completion
    node: str = ""                      # routing trace
    replica: str = ""
    retries: int = 0

    @property
    def ok(self) -> bool:
        return self.error is None


class StreamEventType(enum.Enum):
    TOKEN = "token"      # one incremental output token
    FINISH = "finish"    # terminal: successful completion
    ERROR = "error"      # terminal: structured failure / cancellation


@dataclasses.dataclass(frozen=True)
class StreamEvent:
    """One delta on a `GenerationHandle.stream()` iterator.  TOKEN events
    carry (token, index); FINISH and ERROR carry the final response (and,
    for ERROR, the structured `APIError`)."""
    type: StreamEventType
    token: Optional[int] = None
    index: int = -1
    response: Optional[GenerationResponse] = None
    error: Optional[APIError] = None

    @property
    def terminal(self) -> bool:
        return self.type is not StreamEventType.TOKEN


# --------------------------------------------------------------------- #
def error_from_internal(req: Request) -> Optional[APIError]:
    """Map an internal request's failure onto the public taxonomy."""
    if not req.error and not req.cancelled:
        return None
    try:
        code = ErrorCode(req.error_code) if req.error_code \
            else ErrorCode.ENGINE_FAILED
    except ValueError:
        code = ErrorCode.ENGINE_FAILED
    if req.cancelled:
        code = ErrorCode.CANCELLED
    return APIError(code, req.error or code.value)


def response_from_internal(req: Request) -> GenerationResponse:
    """Freeze an internal request's terminal state into a response."""
    err = error_from_internal(req)
    if req.cancelled:
        reason = "cancelled"
    elif err is not None:
        reason = "error"
    elif (req.sampling.eos_id >= 0 and req.output
          and req.output[-1] == req.sampling.eos_id):
        reason = "stop"
    else:
        reason = "length"
    return GenerationResponse(
        request_id=req.request_id, model=req.model,
        tokens=tuple(req.output), finish_reason=reason, error=err,
        ttft=req.ttft, latency=req.latency, node=req.node,
        replica=req.replica, retries=req.retries)
