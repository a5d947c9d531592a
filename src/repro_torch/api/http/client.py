"""Wire protocol v1 — stdlib network client + tiny CLI.

`HTTPClient` speaks the OpenAI-compatible protocol over a plain socket
(`http.client`, keep-alive reused across calls): model listing,
completions, chat completions (both with SSE streaming), remote cancel,
and the admin plane.  Tenant identity rides on every request as
``Authorization: Bearer <tenant>`` and lands in the server-side token
buckets.  Structured HTTP failures raise `HTTPClientError`, which maps
the wire body back onto the `ErrorCode` taxonomy.

CLI::

    python -m repro.api.http.client [--url ...] [--tenant t] models
    python -m repro.api.http.client complete MODEL "some text" --stream
    python -m repro.api.http.client chat MODEL "hi there" --max-tokens 16
    python -m repro.api.http.client health | snapshot

One client instance serializes its calls over one connection — share a
client across threads only with external locking, or give each thread
its own (connections are cheap).
"""
from __future__ import annotations

import http.client
import json
import random
import sys
import time
from typing import Any, Dict, Iterator, List, Optional, Sequence, Union
from urllib.parse import urlparse

from repro_torch.api.http.chat import ChatMessage
from repro_torch.api.types import APIError, ErrorCode


class HTTPClientError(RuntimeError):
    """A non-2xx wire response, mapped back onto the error taxonomy."""

    def __init__(self, status: int, body: Dict[str, Any],
                 retry_after: Optional[float] = None):
        err = body.get("error", {}) if isinstance(body, dict) else {}
        self.status = status
        self.message = err.get("message", f"HTTP {status}")
        self.type = err.get("type", "")
        self.retryable = bool(err.get("retryable", False))
        # the server's Retry-After header (seconds), when it sent one
        self.retry_after = retry_after
        try:
            self.code: Optional[ErrorCode] = ErrorCode(self.type)
        except ValueError:
            self.code = None
        super().__init__(f"HTTP {status} [{self.type}] {self.message}")

    @property
    def error(self) -> Optional[APIError]:
        return (APIError(self.code, self.message)
                if self.code is not None else None)


class _CountingSocket:
    """Transparent socket proxy that counts bytes handed to `sendall` —
    the client's witness for whether any request bytes could have
    reached the server before a send error."""

    def __init__(self, sock):
        self._sock = sock
        self.sent = 0

    def sendall(self, data):
        # count *before* the write: a failed sendall may still have
        # pushed a prefix onto the wire, so any attempted byte counts
        try:
            self.sent += memoryview(data).nbytes
        except TypeError:
            self.sent += len(data)
        return self._sock.sendall(data)

    def __getattr__(self, name):
        return getattr(self._sock, name)


# structured rejections that are safe AND useful to retry: the server
# definitively answered (nothing is in flight), and the condition is
# transient — overload, rate limit, or a routing gap during failover
_RETRYABLE_CODES = (ErrorCode.OVERLOADED, ErrorCode.RATE_LIMITED,
                    ErrorCode.NO_BACKEND)


class HTTPClient:
    def __init__(self, base_url: str = "http://127.0.0.1:8000", *,
                 tenant: str = "", timeout_s: float = 130.0,
                 keepalive_guard_s: float = 4.0, retries: int = 0,
                 backoff_base_s: float = 0.05, backoff_cap_s: float = 2.0,
                 backoff_seed: Optional[int] = None):
        u = urlparse(base_url)
        if u.scheme not in ("http", ""):
            raise ValueError(f"unsupported scheme {u.scheme!r}")
        self.host = u.hostname or "127.0.0.1"
        self.port = u.port or 8000
        self.tenant = tenant
        self.timeout_s = timeout_s
        # a connection idle longer than this is reopened instead of
        # reused — keep it below the server's keepalive_idle_s (5 s
        # default) so generation POSTs never race the server's idle
        # close (a retry there could double-submit)
        self.keepalive_guard_s = keepalive_guard_s
        # automatic backoff-retry budget for *structured* retryable
        # rejections (429/503 with OVERLOADED / RATE_LIMITED /
        # NO_BACKEND).  Default OFF: retrying is a policy decision.
        # Distinct from the transport-level resend in `_request`, which
        # only fires when zero request bytes could have reached the
        # server (the `_CountingSocket` witness) — these retries fire
        # only after the server definitively *answered*, so they can
        # never double-submit a generation
        self.retries = max(0, retries)
        self.backoff_base_s = backoff_base_s
        self.backoff_cap_s = backoff_cap_s
        self._rng = random.Random(backoff_seed)
        self._conn: Optional[http.client.HTTPConnection] = None
        self._last_used = 0.0
        # set by streaming calls from the X-Request-Id response header,
        # before the first chunk arrives — feed it to `cancel()` *on a
        # separate HTTPClient* (this one's connection is busy carrying
        # the stream until it is fully consumed)
        self.last_request_id: Optional[int] = None

    # ---- transport ----------------------------------------------- #
    def _connection(self) -> http.client.HTTPConnection:
        if self._conn is not None and (time.monotonic() - self._last_used
                                       > self.keepalive_guard_s):
            self.close()        # the server has likely idled this out
        if self._conn is None:
            self._conn = http.client.HTTPConnection(
                self.host, self.port, timeout=self.timeout_s)
        return self._conn

    def close(self):
        if self._conn is not None:
            self._conn.close()
            self._conn = None

    def __enter__(self) -> "HTTPClient":
        return self

    def __exit__(self, *exc):
        self.close()

    def _request(self, method: str, path: str,
                 body: Optional[Dict] = None) -> http.client.HTTPResponse:
        """One logical request with the optional structured-rejection
        retry budget (exponential backoff, full jitter, honors the
        server's Retry-After)."""
        attempt = 0
        while True:
            try:
                return self._request_once(method, path, body)
            except HTTPClientError as e:
                if attempt >= self.retries \
                        or e.code not in _RETRYABLE_CODES:
                    raise
                delay = min(self.backoff_base_s * (2 ** attempt),
                            self.backoff_cap_s)
                delay *= self._rng.random()          # full jitter
                if e.retry_after is not None:
                    delay = max(delay, min(e.retry_after,
                                           self.backoff_cap_s))
                time.sleep(delay)
                attempt += 1

    def _request_once(self, method: str, path: str,
                      body: Optional[Dict] = None
                      ) -> http.client.HTTPResponse:
        headers = {"Accept": "application/json"}
        if self.tenant:
            headers["Authorization"] = f"Bearer {self.tenant}"
        payload = None
        if body is not None:
            payload = json.dumps(body).encode("utf-8")
            headers["Content-Type"] = "application/json"
        for attempt in (0, 1):
            conn = self._connection()
            sent = 0
            try:
                if conn.sock is None:
                    conn.connect()
                if isinstance(conn.sock, _CountingSocket):
                    conn.sock.sent = 0          # reused keep-alive conn
                else:
                    conn.sock = _CountingSocket(conn.sock)
                try:
                    conn.request(method, path, body=payload,
                                 headers=headers)
                finally:
                    sent = conn.sock.sent if conn.sock is not None else 0
            except (http.client.CannotSendRequest,
                    http.client.ResponseNotReady):
                raise RuntimeError(
                    "this HTTPClient is carrying an unconsumed streaming "
                    "response; finish iterating it, or use a separate "
                    "HTTPClient (e.g. to cancel() a live stream)"
                ) from None
            except OSError:
                # send failed.  Resending on a fresh connection is safe
                # only when the server cannot have acted on the request:
                # the method is idempotent, or *zero* request bytes were
                # handed to the socket (a partial send on a stale
                # keep-alive connection may still have delivered the
                # whole request — blind-retrying a generation POST there
                # could double-submit and double-charge it)
                self.close()
                if attempt or (method != "GET" and sent > 0):
                    raise
                continue
            try:
                resp = conn.getresponse()
                self._last_used = time.monotonic()
                break
            except (http.client.RemoteDisconnected, BrokenPipeError,
                    ConnectionResetError):
                # the request reached the server but the response never
                # came back.  Only idempotent methods are safe to retry
                # — a generation POST may have been admitted and charged
                self.close()
                if method != "GET" or attempt:
                    raise
        if resp.status >= 400:
            raw = resp.read()
            try:
                parsed = json.loads(raw)
            except ValueError:
                parsed = {"error": {"message": raw.decode("utf-8",
                                                          "replace")}}
            after = resp.headers.get("Retry-After")
            try:
                retry_after = float(after) if after is not None else None
            except ValueError:
                retry_after = None
            raise HTTPClientError(resp.status, parsed,
                                  retry_after=retry_after)
        return resp

    def _json(self, method: str, path: str,
              body: Optional[Dict] = None) -> Dict[str, Any]:
        resp = self._request(method, path, body)
        return json.loads(resp.read() or b"{}")

    def _stream(self, path: str,
                body: Dict[str, Any]) -> Iterator[Dict[str, Any]]:
        resp = self._request("POST", path, body)
        rid = resp.headers.get("X-Request-Id")
        self.last_request_id = int(rid) if rid is not None else None
        return self._sse(resp)

    def _sse(self, resp: http.client.HTTPResponse
             ) -> Iterator[Dict[str, Any]]:
        """Parse `data:` frames until `[DONE]`; drains the response so
        the keep-alive connection stays reusable."""
        try:
            while True:
                line = resp.readline()
                if not line:
                    return
                line = line.strip()
                if not line.startswith(b"data:"):
                    continue
                payload = line[len(b"data:"):].strip()
                if payload == b"[DONE]":
                    return
                yield json.loads(payload)
        finally:
            resp.read()

    # ---- service surface ----------------------------------------- #
    def healthz(self) -> Dict[str, Any]:
        return self._json("GET", "/healthz")

    def models(self) -> List[str]:
        return [m["id"] for m in self._json("GET", "/v1/models")["data"]]

    def models_full(self) -> List[Dict[str, Any]]:
        return self._json("GET", "/v1/models")["data"]

    @staticmethod
    def _gen_body(model: str, *, max_tokens: int, temperature: float,
                  top_k: int, top_p: float, stream: bool,
                  timeout_s: Optional[float],
                  extra: Optional[Dict]) -> Dict[str, Any]:
        body: Dict[str, Any] = {
            "model": model, "max_tokens": max_tokens,
            "temperature": temperature, "top_k": top_k, "top_p": top_p,
            "stream": stream}
        if timeout_s is not None:
            body["timeout_s"] = timeout_s
        if extra:
            body.update(extra)
        return body

    def complete(self, model: str,
                 prompt: Union[str, Sequence[int]], *,
                 max_tokens: int = 16, temperature: float = 0.0,
                 top_k: int = 0, top_p: float = 1.0, stream: bool = False,
                 timeout_s: Optional[float] = None,
                 extra: Optional[Dict] = None
                 ) -> Union[Dict[str, Any], Iterator[Dict[str, Any]]]:
        """POST /v1/completions.  Returns the response body, or an
        iterator of chunk dicts when `stream=True`."""
        body = self._gen_body(model, max_tokens=max_tokens,
                              temperature=temperature, top_k=top_k,
                              top_p=top_p, stream=stream,
                              timeout_s=timeout_s, extra=extra)
        body["prompt"] = (prompt if isinstance(prompt, str)
                          else list(prompt))
        if stream:
            return self._stream("/v1/completions", body)
        return self._json("POST", "/v1/completions", body)

    def chat(self, model: str,
             messages: Sequence[Union[ChatMessage, Dict[str, str], str]],
             *, max_tokens: int = 16, temperature: float = 0.0,
             top_k: int = 0, top_p: float = 1.0, stream: bool = False,
             timeout_s: Optional[float] = None,
             extra: Optional[Dict] = None
             ) -> Union[Dict[str, Any], Iterator[Dict[str, Any]]]:
        """POST /v1/chat/completions.  Messages may be `ChatMessage`s,
        ``{"role","content"}`` dicts, or bare strings (treated as user
        turns)."""
        wire = []
        for m in messages:
            if isinstance(m, ChatMessage):
                wire.append({"role": m.role, "content": m.content})
            elif isinstance(m, dict):
                wire.append({"role": m.get("role", "user"),
                             "content": m.get("content", "")})
            else:
                wire.append({"role": "user", "content": str(m)})
        body = self._gen_body(model, max_tokens=max_tokens,
                              temperature=temperature, top_k=top_k,
                              top_p=top_p, stream=stream,
                              timeout_s=timeout_s, extra=extra)
        body["messages"] = wire
        if stream:
            return self._stream("/v1/chat/completions", body)
        return self._json("POST", "/v1/chat/completions", body)

    def cancel(self, request_id: int) -> bool:
        out = self._json("POST", f"/v1/requests/{request_id}/cancel", {})
        return bool(out.get("cancelled"))

    # ---- admin surface ------------------------------------------- #
    def admin_snapshot(self) -> Dict[str, Any]:
        return self._json("GET", "/v1/admin/snapshot")

    def admin_classes(self) -> Dict[str, Any]:
        """Per-GPU-class rollup (cost weights, per-bucket routed traffic
        and modeled cost-per-token) from the fleet snapshot."""
        return self.admin_snapshot().get("classes", {})

    def admin_deploy(self, model: str, *, min_replicas: int = 1,
                     max_replicas: int = 0, n_slots: int = 4,
                     max_len: int = 2048) -> Dict[str, Any]:
        return self._json("POST", "/v1/admin/deploy", {
            "model": model, "min_replicas": min_replicas,
            "max_replicas": max_replicas, "n_slots": n_slots,
            "max_len": max_len})

    def admin_undeploy(self, model: str) -> Dict[str, Any]:
        return self._json("POST", "/v1/admin/undeploy", {"model": model})

    def admin_scale(self, model: str, replicas: int) -> Dict[str, Any]:
        return self._json("POST", "/v1/admin/scale",
                          {"model": model, "replicas": replicas})

    def admin_drain(self, model: str,
                    timeout_s: float = 5.0) -> Dict[str, Any]:
        return self._json("POST", "/v1/admin/drain",
                          {"model": model, "timeout_s": timeout_s})

    def admin_resume(self, model: str) -> Dict[str, Any]:
        return self._json("POST", "/v1/admin/resume", {"model": model})

    def admin_cache_flush(self, model: str = "") -> Dict[str, Any]:
        """Drop unpinned prefix-cache entries fleet-wide (or for one
        model).  Returns `{"flushed": n, "remaining": m}`."""
        body = {"model": model} if model else {"flush": True}
        return self._json("POST", "/v1/admin/cache/flush", body)

    def set_tenant_quota(self, tenant: str, *,
                         requests_per_s: float = 0.0,
                         tokens_per_s: float = 0.0,
                         burst_requests: float = 0.0,
                         burst_tokens: float = 0.0) -> Dict[str, Any]:
        return self._json("POST", "/v1/admin/tenants", {
            "tenant": tenant, "requests_per_s": requests_per_s,
            "tokens_per_s": tokens_per_s,
            "burst_requests": burst_requests,
            "burst_tokens": burst_tokens})

    def remove_tenant_quota(self, tenant: str) -> Dict[str, Any]:
        return self._json("POST", "/v1/admin/tenants",
                          {"tenant": tenant, "remove": True})

    def tenant_quotas(self) -> Dict[str, Dict[str, float]]:
        return self._json("GET", "/v1/admin/tenants")["tenants"]


# ------------------------------------------------------------------ #
def _print_stream(chunks: Iterator[Dict[str, Any]]) -> int:
    for chunk in chunks:
        if "error" in chunk:
            print(f"\n[error] {chunk['error']['type']}: "
                  f"{chunk['error']['message']}", file=sys.stderr)
            return 1
        choice = chunk["choices"][0]
        text = choice.get("text") or choice.get("delta", {}).get(
            "content") or ""
        sys.stdout.write(text)
        sys.stdout.flush()
        if choice.get("finish_reason"):
            print(f"\n[finish] {choice['finish_reason']}")
    return 0


def _main(argv: Optional[List[str]] = None) -> int:
    import argparse
    p = argparse.ArgumentParser(
        prog="python -m repro.api.http.client",
        description="Talk to a repro Gateway HTTP service.")
    p.add_argument("--url", default="http://127.0.0.1:8000")
    p.add_argument("--tenant", default="",
                   help="sent as Authorization: Bearer <tenant>")
    p.add_argument("--retries", type=int, default=0,
                   help="backoff-retry budget for 429/503 rejections")
    sub = p.add_subparsers(dest="cmd", required=True)
    sub.add_parser("health")
    sub.add_parser("models")
    sub.add_parser("snapshot")

    def _gen_args(sp):
        sp.add_argument("--max-tokens", type=int, default=16)
        sp.add_argument("--temperature", type=float, default=0.0)
        sp.add_argument("--top-k", type=int, default=0)
        sp.add_argument("--top-p", type=float, default=1.0)
        sp.add_argument("--timeout", type=float, default=None)
        sp.add_argument("--stream", action="store_true")

    c = sub.add_parser("complete")
    c.add_argument("model")
    c.add_argument("prompt", help="text, or comma-separated token ids "
                                  "with --tokens")
    c.add_argument("--tokens", action="store_true")
    _gen_args(c)

    ch = sub.add_parser("chat")
    ch.add_argument("model")
    ch.add_argument("message", nargs="+", help="user turn(s)")
    ch.add_argument("--system", default="")
    _gen_args(ch)

    cn = sub.add_parser("cancel")
    cn.add_argument("request_id", type=int)

    args = p.parse_args(argv)
    client = HTTPClient(args.url, tenant=args.tenant,
                        retries=args.retries)
    try:
        if args.cmd == "health":
            print(json.dumps(client.healthz(), indent=2))
        elif args.cmd == "models":
            for entry in client.models_full():
                print(f"{entry['id']}  family={entry['family']} "
                      f"replicas={entry['replicas']} "
                      f"ctx={entry['max_context']}")
        elif args.cmd == "snapshot":
            print(json.dumps(client.admin_snapshot(), indent=2))
        elif args.cmd == "cancel":
            print(json.dumps({"cancelled":
                              client.cancel(args.request_id)}))
        elif args.cmd == "complete":
            prompt: Union[str, List[int]] = args.prompt
            if args.tokens:
                prompt = [int(t) for t in args.prompt.split(",")]
            out = client.complete(
                args.model, prompt, max_tokens=args.max_tokens,
                temperature=args.temperature, top_k=args.top_k,
                top_p=args.top_p, stream=args.stream,
                timeout_s=args.timeout)
            if args.stream:
                return _print_stream(out)
            print(json.dumps(out, indent=2))
        elif args.cmd == "chat":
            messages: List[ChatMessage] = []
            if args.system:
                messages.append(ChatMessage("system", args.system))
            messages.extend(ChatMessage("user", m)
                            for m in args.message)
            out = client.chat(
                args.model, messages, max_tokens=args.max_tokens,
                temperature=args.temperature, top_k=args.top_k,
                top_p=args.top_p, stream=args.stream,
                timeout_s=args.timeout)
            if args.stream:
                return _print_stream(out)
            print(json.dumps(out, indent=2))
        return 0
    except HTTPClientError as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    except OSError as e:
        print(f"error: cannot reach {args.url}: {e}", file=sys.stderr)
        return 1
    finally:
        client.close()


if __name__ == "__main__":
    sys.exit(_main())
