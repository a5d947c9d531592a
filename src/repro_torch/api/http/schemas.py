"""Wire protocol v1 — JSON schemas, strict validation, error mapping.

One place defines how the frozen Gateway types cross the network:

* `HTTP_STATUS` — THE `ErrorCode -> HTTP status` table.  Every structured
  failure the Gateway can produce becomes a typed JSON error body with a
  documented status; nothing is ever classified by parsing messages.
* `parse_completion_request` / `parse_chat_request` — strict validators
  from untrusted JSON to typed calls (`WireError` carries the status and
  body for anything malformed).
* response/chunk builders — OpenAI-compatible `text_completion` /
  `chat.completion` bodies and their `*.chunk` SSE deltas, extended with
  `token_ids` per choice and a `metadata` routing trace (node, replica,
  retries, ttft) that the paper's dashboard surfaces.
* SSE framing — `sse_event()` renders one `data:` frame; streams always
  terminate with `SSE_DONE` (`data: [DONE]`), including after a
  mid-stream structured error frame.
"""
from __future__ import annotations

import dataclasses
import json
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

from repro_torch.api.http.chat import ChatMessage
from repro_torch.api.types import APIError, ErrorCode, GenerationResponse
from repro_torch.serving.sampler import SamplingParams

WIRE_VERSION = "v1"

# ------------------------------------------------------------------ #
# The ErrorCode -> HTTP status table (mirrored in README).  499 is the
# de-facto "client closed request" status (nginx); everything else is
# standard.
HTTP_STATUS: Dict[ErrorCode, int] = {
    ErrorCode.NO_BACKEND: 503,
    ErrorCode.OVERLOADED: 429,
    ErrorCode.ENGINE_FAILED: 500,
    ErrorCode.CANCELLED: 499,
    ErrorCode.TIMEOUT: 504,
    ErrorCode.DRAINING: 503,
    ErrorCode.INVALID_REQUEST: 400,
    ErrorCode.RATE_LIMITED: 429,
}


def status_for(code: ErrorCode) -> int:
    return HTTP_STATUS[code]


def error_body(err: APIError) -> Dict[str, Any]:
    """The typed JSON error envelope (OpenAI-style ``{"error": ...}``)."""
    return {"error": {
        "message": err.message,
        "type": err.code.value,
        "code": HTTP_STATUS[err.code],
        "retryable": err.retryable,
    }}


class WireError(Exception):
    """A request that must be answered with a structured HTTP error."""

    def __init__(self, code: ErrorCode, message: str) -> None:
        super().__init__(f"[{code.value}] {message}")
        self.error = APIError(code, message)

    @property
    def status(self) -> int:
        return HTTP_STATUS[self.error.code]

    def body(self) -> Dict[str, Any]:
        return error_body(self.error)


# ------------------------------------------------------------------ #
def _invalid(msg: str) -> WireError:
    return WireError(ErrorCode.INVALID_REQUEST, msg)


def _field(body: Dict, name: str,
           types: Union[type, Tuple[type, ...]],
           default: Any = None, required: bool = False) -> Any:
    if name not in body or body[name] is None:
        if required:
            raise _invalid(f"missing required field {name!r}")
        return default
    val = body[name]
    # bool is an int subclass; never silently accept it for numbers
    if isinstance(val, bool) and bool not in (
            types if isinstance(types, tuple) else (types,)):
        raise _invalid(f"field {name!r} must be {types}, got bool")
    if not isinstance(val, types):
        raise _invalid(f"field {name!r} has wrong type "
                       f"{type(val).__name__}")
    return val


def _parse_sampling(body: Dict) -> SamplingParams:
    max_tokens = _field(body, "max_tokens", int, default=16)
    if max_tokens < 1:
        raise _invalid("max_tokens must be >= 1")
    temperature = float(_field(body, "temperature", (int, float),
                               default=0.0))
    if temperature < 0.0:
        raise _invalid("temperature must be >= 0")
    top_p = float(_field(body, "top_p", (int, float), default=1.0))
    if not 0.0 < top_p <= 1.0:
        raise _invalid("top_p must be in (0, 1]")
    top_k = _field(body, "top_k", int, default=0)
    if top_k < 0:
        raise _invalid("top_k must be >= 0")
    eos_id = _field(body, "eos_id", int, default=-1)
    return SamplingParams(temperature=temperature, top_k=top_k,
                          top_p=top_p, max_tokens=max_tokens,
                          eos_id=eos_id)


def _parse_common(body: Dict) -> Tuple[str, SamplingParams, bool,
                                       Optional[float]]:
    if not isinstance(body, dict):
        raise _invalid("request body must be a JSON object")
    model = _field(body, "model", str, required=True)
    n = _field(body, "n", int, default=1)
    if n != 1:
        raise _invalid("only n=1 is supported")
    stream = _field(body, "stream", bool, default=False)
    timeout_s = _field(body, "timeout_s", (int, float), default=None)
    if timeout_s is not None and float(timeout_s) <= 0.0:
        raise _invalid("timeout_s must be > 0")
    return (model, _parse_sampling(body), stream,
            None if timeout_s is None else float(timeout_s))


@dataclasses.dataclass(frozen=True)
class CompletionCall:
    """A validated /v1/completions request.  `prompt` is either raw text
    (encoded by the service with the model's vocab) or token ids."""
    model: str
    prompt: Union[str, Tuple[int, ...]]
    sampling: SamplingParams
    stream: bool
    timeout_s: Optional[float]


@dataclasses.dataclass(frozen=True)
class ChatCall:
    """A validated /v1/chat/completions request."""
    model: str
    messages: Tuple[ChatMessage, ...]
    sampling: SamplingParams
    stream: bool
    timeout_s: Optional[float]


def parse_completion_request(body: Dict) -> CompletionCall:
    model, sampling, stream, timeout_s = _parse_common(body)
    prompt = _field(body, "prompt", (str, list), required=True)
    if isinstance(prompt, list):
        if not all(isinstance(t, int) and not isinstance(t, bool)
                   and t >= 0 for t in prompt):
            raise _invalid("prompt token list must contain only "
                           "non-negative integers")
        prompt = tuple(prompt)
    return CompletionCall(model=model, prompt=prompt, sampling=sampling,
                          stream=stream, timeout_s=timeout_s)


def parse_chat_request(body: Dict) -> ChatCall:
    model, sampling, stream, timeout_s = _parse_common(body)
    raw = _field(body, "messages", list, required=True)
    if not raw:
        raise _invalid("messages must contain at least one message")
    messages: List[ChatMessage] = []
    for i, m in enumerate(raw):
        if not isinstance(m, dict):
            raise _invalid(f"messages[{i}] must be an object")
        role = _field(m, "role", str, required=True)
        content = _field(m, "content", str, required=True)
        try:
            messages.append(ChatMessage(role=role, content=content))
        except ValueError as e:
            raise _invalid(f"messages[{i}]: {e}") from None
    return ChatCall(model=model, messages=tuple(messages),
                    sampling=sampling, stream=stream, timeout_s=timeout_s)


# ------------------------------------------------------------------ #
def _usage(prompt_tokens: int, completion_tokens: int) -> Dict[str, int]:
    return {"prompt_tokens": prompt_tokens,
            "completion_tokens": completion_tokens,
            "total_tokens": prompt_tokens + completion_tokens}


def _metadata(resp: GenerationResponse) -> Dict[str, Any]:
    """Routing trace extension — the per-request dashboard row."""
    return {"node": resp.node, "replica": resp.replica,
            "retries": resp.retries, "ttft_s": resp.ttft,
            "latency_s": resp.latency}


def models_body(entries: Sequence[Dict[str, Any]]) -> Dict[str, Any]:
    return {"object": "list", "data": list(entries)}


def model_entry(name: str, *, family: str = "", replicas: int = 0,
                context: int = 0) -> Dict[str, Any]:
    return {"id": name, "object": "model", "owned_by": "repro",
            "family": family, "replicas": replicas,
            "max_context": context}


def completion_body(req_id: int, model: str, *, text: str,
                    resp: GenerationResponse,
                    prompt_tokens: int) -> Dict[str, Any]:
    return {
        "id": f"cmpl-{req_id}",
        "object": "text_completion",
        "created": int(time.time()),
        "model": model,
        "choices": [{
            "index": 0,
            "text": text,
            "token_ids": list(resp.tokens),
            "finish_reason": resp.finish_reason,
        }],
        "usage": _usage(prompt_tokens, len(resp.tokens)),
        "metadata": _metadata(resp),
    }


def chat_body(req_id: int, model: str, *, text: str,
              resp: GenerationResponse,
              prompt_tokens: int) -> Dict[str, Any]:
    return {
        "id": f"chatcmpl-{req_id}",
        "object": "chat.completion",
        "created": int(time.time()),
        "model": model,
        "choices": [{
            "index": 0,
            "message": {"role": "assistant", "content": text},
            "token_ids": list(resp.tokens),
            "finish_reason": resp.finish_reason,
        }],
        "usage": _usage(prompt_tokens, len(resp.tokens)),
        "metadata": _metadata(resp),
    }


# ---- SSE framing -------------------------------------------------- #
SSE_DONE = b"data: [DONE]\n\n"


def sse_event(data: Union[Dict, str]) -> bytes:
    if not isinstance(data, str):
        data = json.dumps(data, separators=(",", ":"))
    return f"data: {data}\n\n".encode("utf-8")


def completion_chunk(req_id: int, model: str, *, text: str = "",
                     token: Optional[int] = None, index: int = 0,
                     finish_reason: Optional[str] = None,
                     usage: Optional[Dict[str, int]] = None
                     ) -> Dict[str, Any]:
    choice: Dict[str, Any] = {"index": 0, "text": text,
                              "finish_reason": finish_reason}
    if token is not None:
        choice["token"] = token
        choice["token_index"] = index
    body = {"id": f"cmpl-{req_id}", "object": "text_completion.chunk",
            "created": int(time.time()), "model": model,
            "choices": [choice]}
    if usage is not None:            # OpenAI parity: final chunk only
        body["usage"] = usage
    return body


def chat_chunk(req_id: int, model: str, *, role: Optional[str] = None,
               text: Optional[str] = None, token: Optional[int] = None,
               index: int = 0, finish_reason: Optional[str] = None,
               usage: Optional[Dict[str, int]] = None
               ) -> Dict[str, Any]:
    delta: Dict[str, Any] = {}
    if role is not None:
        delta["role"] = role
    if text is not None:
        delta["content"] = text
    if token is not None:
        delta["token"] = token
        delta["token_index"] = index
    choice = {"index": 0, "delta": delta, "finish_reason": finish_reason}
    body = {"id": f"chatcmpl-{req_id}",
            "object": "chat.completion.chunk",
            "created": int(time.time()), "model": model,
            "choices": [choice]}
    if usage is not None:            # OpenAI parity: final chunk only
        body["usage"] = usage
    return body


def stream_error_chunk(err: APIError) -> Dict[str, Any]:
    """Terminal SSE frame for a mid-stream structured failure.  Streams
    still end with `[DONE]` after this frame."""
    return error_body(err)
