"""Wire protocol v1 — the stdlib threaded HTTP service over a Gateway.

`GatewayHTTPServer` exposes one `Gateway` (and through it the whole
fleet) as an OpenAI-compatible network service:

* ``GET  /healthz``                — liveness + fleet summary
* ``GET  /v1/models``              — the unified model list
* ``POST /v1/completions``         — prompt (text or token ids) completion
* ``POST /v1/chat/completions``    — chat-templated completion
* ``POST /v1/requests/<id>/cancel``— abort an in-flight request (499)
* ``GET/POST /v1/admin/...``       — snapshot, deploy, undeploy, scale,
                                     drain, resume, tenant quotas

Both generation endpoints accept ``"stream": true`` and answer with SSE
framing (``data:`` JSON chunks, terminal ``data: [DONE]``) driven by the
Gateway's per-token stream callbacks; a mid-stream structured failure
becomes a terminal error frame before ``[DONE]``.  Admission rejections
are returned as plain HTTP errors (the `schemas.HTTP_STATUS` table) even
for stream requests, so every `ErrorCode` is observable from the wire.

Tenancy: ``Authorization: Bearer <tenant>`` maps the caller onto the
per-tenant token buckets; no header means the anonymous unlimited
tenant.  `start()` boots the Gateway's continuous serving runtime, so
requests are served entirely by background pump threads (zero caller
pumps); connections are handled by a bounded thread pool with HTTP/1.1
keep-alive, and `stop()` drains in-flight requests before joining.

This file differs from `repro.api.http.server` in one line: the handler
sets TCP_NODELAY on every connection (`disable_nagle_algorithm`).  The
reference writes a response's headers and its body (and an SSE stream's
frames) as separate small segments; with Nagle's algorithm on, the
kernel holds the second until the client acknowledges the first, and a
keep-alive client may delay that acknowledgement (some 40 ms where a
host's TCP stack delays ACKs), so a response after a connection's first
could wait that long.
"""
from __future__ import annotations

import dataclasses
import json
import socket
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from http.server import BaseHTTPRequestHandler, HTTPServer
from typing import Any, Dict, Optional, Tuple

from repro_torch.api.gateway import Gateway, GenerationHandle
from repro_torch.api.http import chat as chat_mod
from repro_torch.api.http import schemas
from repro_torch.api.http.schemas import WireError
from repro_torch.api.runtime import RuntimeConfig
from repro_torch.api.types import (API_VERSION, APIError, ErrorCode,
                             GenerationRequest, StreamEventType)
from repro_torch.core.frontend import TenantQuota
from repro_torch.core.placement import ModelDemand

_MAX_BODY_BYTES = 8 * 1024 * 1024


@dataclasses.dataclass
class HTTPConfig:
    host: str = "127.0.0.1"
    port: int = 0                    # 0 => ephemeral (server.port tells)
    max_workers: int = 8             # connection thread pool size
    keepalive_idle_s: float = 5.0    # idle keep-alive connection timeout
    default_timeout_s: float = 120.0  # per-request generation deadline
    drain_timeout_s: float = 10.0    # stop(): in-flight request budget
    # advisory Retry-After (seconds) attached to every 429/503 response
    # so well-behaved clients back off instead of hammering an
    # overloaded/draining service; <= 0 disables the header
    retry_after_s: float = 1.0


class _PooledHTTPServer(HTTPServer):
    """Accept loop + bounded worker pool.  One pool task per connection;
    HTTP/1.1 keep-alive serves that connection's requests serially while
    other connections proceed on other workers."""

    allow_reuse_address = True
    daemon_threads = True

    def __init__(self, addr, handler, pool: ThreadPoolExecutor,
                 service: "GatewayHTTPServer"):
        super().__init__(addr, handler)
        self._pool = pool
        self.service = service
        self._conns: set = set()
        self._conns_lock = threading.Lock()

    def process_request(self, request, client_address):
        with self._conns_lock:
            self._conns.add(request)
        try:
            self._pool.submit(self._serve, request, client_address)
        except RuntimeError:            # pool already shut down
            self._drop(request)

    def _serve(self, request, client_address):
        try:
            self.finish_request(request, client_address)
        except Exception:               # connection-level noise only
            pass
        finally:
            self._drop(request)

    def _drop(self, request):
        self.shutdown_request(request)
        with self._conns_lock:
            self._conns.discard(request)

    def close_connections(self):
        """Force-close lingering (idle keep-alive) connections."""
        with self._conns_lock:
            conns = list(self._conns)
        for s in conns:
            try:
                s.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass


class _Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"     # keep-alive by default
    disable_nagle_algorithm = True    # small writes leave at once
    server_version = f"repro-gateway/{API_VERSION}"

    @property
    def svc(self) -> "GatewayHTTPServer":
        return self.server.service

    def log_message(self, fmt, *args):  # route nothing to stderr
        pass

    # ---- plumbing ------------------------------------------------ #
    def _tenant(self) -> str:
        auth = self.headers.get("Authorization", "")
        if auth.startswith("Bearer "):
            return auth[len("Bearer "):].strip()
        return ""

    def _read_json(self) -> Dict[str, Any]:
        try:
            length = int(self.headers.get("Content-Length", 0))
        except ValueError:
            self.close_connection = True    # unreadable framing
            raise WireError(ErrorCode.INVALID_REQUEST,
                            "bad Content-Length") from None
        if length <= 0:
            raise WireError(ErrorCode.INVALID_REQUEST,
                            "request body required")
        if length > _MAX_BODY_BYTES:
            self.close_connection = True    # body left unread
            raise WireError(ErrorCode.INVALID_REQUEST,
                            "request body too large")
        raw = self.rfile.read(length)
        try:
            body = json.loads(raw)
        except (ValueError, UnicodeDecodeError):
            raise WireError(ErrorCode.INVALID_REQUEST,
                            "request body is not valid JSON") from None
        if not isinstance(body, dict):
            raise WireError(ErrorCode.INVALID_REQUEST,
                            "request body must be a JSON object")
        return body

    def _drain_body(self):
        """Consume an unread request body so the next keep-alive request
        on this connection parses cleanly (used by bodyless routes).  A
        body we refuse to read (oversized, unparseable length) forces
        connection close instead — never a desynchronized socket."""
        try:
            length = int(self.headers.get("Content-Length", 0))
        except ValueError:
            self.close_connection = True
            return
        if length > _MAX_BODY_BYTES:
            self.close_connection = True
        elif length > 0:
            self.rfile.read(length)

    def _send_json(self, status: int, obj: Dict[str, Any],
                   headers: Optional[Dict[str, str]] = None):
        data = json.dumps(obj).encode("utf-8")
        self.send_response(status)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(data)))
        if headers:
            for k, v in headers.items():
                self.send_header(k, v)
        self.end_headers()
        self.wfile.write(data)

    def _retry_headers(self, status: int) -> Optional[Dict[str, str]]:
        """Retry-After on 429/503: the rejection is transient (rate
        limit, overload, drain) — tell the client when to come back.
        Header-only; the error body shape stays pinned."""
        after = self.svc.cfg.retry_after_s
        if status in (429, 503) and after > 0:
            return {"Retry-After": str(int(max(1, round(after))))}
        return None

    def _send_error_body(self, err: APIError):
        status = schemas.status_for(err.code)
        self._send_json(status, schemas.error_body(err),
                        headers=self._retry_headers(status))

    # ---- SSE / chunked ------------------------------------------- #
    def _begin_sse(self, rid: int):
        self.send_response(200)
        self.send_header("Content-Type", "text/event-stream")
        self.send_header("Cache-Control", "no-cache")
        self.send_header("Transfer-Encoding", "chunked")
        # known before the first token: lets a client cancel a stream
        # that has not produced anything yet (POST /v1/requests/<id>/
        # cancel from another connection)
        self.send_header("X-Request-Id", str(rid))
        self.end_headers()

    def _chunk(self, data: bytes):
        self.wfile.write(f"{len(data):x}\r\n".encode("ascii")
                         + data + b"\r\n")
        self.wfile.flush()

    def _end_chunked(self):
        self.wfile.write(b"0\r\n\r\n")
        self.wfile.flush()

    # ---- routing ------------------------------------------------- #
    def do_GET(self):
        self._route("GET")

    def do_POST(self):
        self._route("POST")

    def _route(self, method: str):
        svc = self.svc
        if not svc._enter():
            self.close_connection = True    # also skips body drain
            self._send_json(503, schemas.error_body(APIError(
                ErrorCode.DRAINING, "server is shutting down")),
                headers=self._retry_headers(503))
            return
        try:
            self._dispatch(method, self.path.split("?", 1)[0])
        except WireError as e:
            self._send_json(e.status, e.body(),
                            headers=self._retry_headers(e.status))
        except (BrokenPipeError, ConnectionResetError, socket.timeout):
            self.close_connection = True    # client went away mid-write
        except Exception as e:              # never leak a stack trace
            try:
                self._send_json(500, schemas.error_body(APIError(
                    ErrorCode.ENGINE_FAILED, f"internal error: {e!r}")))
            except OSError:
                self.close_connection = True
        finally:
            svc._leave()

    def _dispatch(self, method: str, path: str):
        if method == "GET":
            if path == "/healthz":
                return self._healthz()
            if path == "/v1/models":
                return self._models()
            if path == "/v1/admin/snapshot":
                return self._send_json(
                    200, self.svc.gateway.admin.snapshot().to_dict())
            if path == "/v1/admin/tenants":
                return self._tenants_get()
        elif method == "POST":
            if path == "/v1/completions":
                return self._completions()
            if path == "/v1/chat/completions":
                return self._chat_completions()
            if (path.startswith("/v1/requests/")
                    and path.endswith("/cancel")):
                return self._cancel(path)
            if path.startswith("/v1/admin/"):
                return self._admin(path[len("/v1/admin/"):])
        if method == "POST":
            self._drain_body()          # unrouted body: keep-alive safe
        known = ("/healthz", "/v1/models", "/v1/completions",
                 "/v1/chat/completions")
        if path in known or path.startswith("/v1/admin/"):
            self._send_json(405, {"error": {
                "message": f"{method} not allowed on {path}",
                "type": "method_not_allowed", "code": 405}})
        else:
            self._send_json(404, {"error": {
                "message": f"no route for {path}",
                "type": "not_found", "code": 404}})

    # ---- endpoints ----------------------------------------------- #
    def _healthz(self):
        gw = self.svc.gateway
        snap_models = gw.models()
        self._send_json(200, {
            "status": "ok",
            "api_version": API_VERSION,
            "runtime_active": gw.runtime_active,
            "models": snap_models,
        })

    def _models(self):
        gw = self.svc.gateway
        entries = []
        for name in gw.models():
            cfg = self.svc.arch_cfg(name)
            ctx = gw._max_prompt_len(name)
            entries.append(schemas.model_entry(
                name,
                family=cfg.family if cfg is not None else "",
                replicas=len(gw.c.frontend.healthy_replicas(name)),
                context=ctx or 0))
        self._send_json(200, schemas.models_body(entries))

    def _completions(self):
        call = schemas.parse_completion_request(self._read_json())
        cfg = self.svc.arch_cfg(call.model)
        prompt = call.prompt
        if isinstance(prompt, str):
            prompt = chat_mod.encode_text(
                prompt, cfg.vocab if cfg is not None else 256)
        self._generate(call.model, prompt, call, kind="completion")

    def _chat_completions(self):
        call = schemas.parse_chat_request(self._read_json())
        cfg = self.svc.arch_cfg(call.model)
        prompt = chat_mod.render_prompt(call.model, call.messages, cfg)
        self._generate(call.model, prompt, call, kind="chat")

    def _generate(self, model: str, prompt: Tuple[int, ...], call,
                  kind: str):
        svc = self.svc
        greq = GenerationRequest(model=model, prompt=tuple(prompt),
                                 sampling=call.sampling,
                                 tenant=self._tenant())
        handle = svc.gateway.submit(greq)
        rid = handle.internal.request_id
        svc._track(rid, handle)
        timeout_s = (call.timeout_s if call.timeout_s is not None
                     else svc.cfg.default_timeout_s)
        try:
            if call.stream:
                # synchronous rejections (validation/admission/routing)
                # surface as plain HTTP errors, not empty streams
                if handle.done and handle.response.error is not None:
                    return self._send_error_body(handle.response.error)
                return self._stream(handle, rid, model, kind, timeout_s,
                                    n_prompt=len(prompt))
            resp = handle.result(timeout_s=timeout_s)
            if resp.error is not None:
                return self._send_error_body(resp.error)
            body_fn = (schemas.chat_body if kind == "chat"
                       else schemas.completion_body)
            self._send_json(200, body_fn(
                rid, model, text=chat_mod.decode_tokens(resp.tokens),
                resp=resp, prompt_tokens=len(prompt)))
        finally:
            svc._untrack(rid)

    def _stream(self, handle: GenerationHandle, rid: int, model: str,
                kind: str, timeout_s: float, n_prompt: int = 0):
        self._begin_sse(rid)
        try:
            if kind == "chat":
                self._chunk(schemas.sse_event(schemas.chat_chunk(
                    rid, model, role="assistant", text="")))
            for ev in handle.stream(timeout_s=timeout_s):
                if ev.type is StreamEventType.TOKEN:
                    text = chat_mod.decode_tokens([ev.token])
                    if kind == "chat":
                        chunk = schemas.chat_chunk(
                            rid, model, text=text, token=ev.token,
                            index=ev.index)
                    else:
                        chunk = schemas.completion_chunk(
                            rid, model, text=text, token=ev.token,
                            index=ev.index)
                elif ev.type is StreamEventType.FINISH:
                    usage = schemas._usage(n_prompt,
                                           len(ev.response.tokens))
                    if kind == "chat":
                        chunk = schemas.chat_chunk(
                            rid, model,
                            finish_reason=ev.response.finish_reason,
                            usage=usage)
                    else:
                        chunk = schemas.completion_chunk(
                            rid, model,
                            finish_reason=ev.response.finish_reason,
                            usage=usage)
                else:       # terminal structured failure mid-stream
                    chunk = schemas.stream_error_chunk(ev.error)
                self._chunk(schemas.sse_event(chunk))
            self._chunk(schemas.SSE_DONE)
            self._end_chunked()
        except (BrokenPipeError, ConnectionResetError, socket.timeout):
            handle.cancel()             # client gone: free the slot
            self.close_connection = True

    def _cancel(self, path: str):
        self._drain_body()              # cancel takes no meaningful body
        frag = path[len("/v1/requests/"):-len("/cancel")]
        try:
            rid = int(frag)
        except ValueError:
            raise WireError(ErrorCode.INVALID_REQUEST,
                            f"bad request id {frag!r}") from None
        handle = self.svc._handle_for(rid)
        if handle is None:
            return self._send_json(404, {"error": {
                "message": f"no in-flight request {rid}",
                "type": "not_found", "code": 404}})
        self._send_json(200, {"id": rid, "cancelled": handle.cancel()})

    # ---- admin --------------------------------------------------- #
    def _admin(self, verb: str):
        gw = self.svc.gateway
        body = self._read_json()
        if verb == "deploy":
            model = schemas._field(body, "model", str, required=True)
            cfg = self.svc.arch_cfg(model)
            if cfg is None:
                raise WireError(ErrorCode.INVALID_REQUEST,
                                f"model {model!r} not in catalog")
            demand = ModelDemand(
                cfg,
                min_replicas=schemas._field(body, "min_replicas", int,
                                            default=1),
                max_replicas=schemas._field(body, "max_replicas", int,
                                            default=0),
                n_slots=schemas._field(body, "n_slots", int, default=4),
                max_len=schemas._field(body, "max_len", int,
                                       default=2048))
            res = gw.admin.deploy_model(demand)
            return self._send_json(200, {
                "model": model, "placed": res.placed,
                "unplaced": list(res.unplaced), "ok": res.ok})
        if verb in ("undeploy", "resume", "drain", "scale"):
            model = schemas._field(body, "model", str, required=True)
            if verb == "undeploy":
                return self._send_json(
                    200, {"model": model,
                          "removed": gw.admin.undeploy_model(model)})
            if verb == "resume":
                gw.admin.resume_model(model)
                return self._send_json(200, {"model": model,
                                             "draining": False})
            if verb == "drain":
                t = float(schemas._field(body, "timeout_s", (int, float),
                                         default=5.0))
                left = gw.admin.drain_model(model, timeout_s=t)
                return self._send_json(200, {"model": model,
                                             "remaining": left,
                                             "drained": left == 0})
            replicas = schemas._field(body, "replicas", int,
                                      required=True)
            res = gw.admin.scale_model(model, replicas)
            return self._send_json(200, {
                "model": model, "placed": res.placed,
                "unplaced": list(res.unplaced), "ok": res.ok})
        if verb == "tenants":
            tenant = schemas._field(body, "tenant", str, required=True)
            if schemas._field(body, "remove", bool, default=False):
                gw.admin.remove_tenant_quota(tenant)
                return self._send_json(200, {"tenant": tenant,
                                             "removed": True})
            quota = TenantQuota(
                requests_per_s=float(schemas._field(
                    body, "requests_per_s", (int, float), default=0.0)),
                tokens_per_s=float(schemas._field(
                    body, "tokens_per_s", (int, float), default=0.0)),
                burst_requests=float(schemas._field(
                    body, "burst_requests", (int, float), default=0.0)),
                burst_tokens=float(schemas._field(
                    body, "burst_tokens", (int, float), default=0.0)))
            gw.admin.set_tenant_quota(tenant, quota)
            return self._send_json(200, {
                "tenant": tenant,
                "requests_per_s": quota.requests_per_s,
                "tokens_per_s": quota.tokens_per_s})
        if verb == "cache/flush":
            model = schemas._field(body, "model", str, default="") or None
            return self._send_json(200, gw.admin.flush_cache(model))
        raise WireError(ErrorCode.INVALID_REQUEST,
                        f"unknown admin verb {verb!r}")

    def _tenants_get(self):
        quotas = self.svc.gateway.admin.tenant_quotas()
        self._send_json(200, {"tenants": {
            t: {"requests_per_s": q.requests_per_s,
                "tokens_per_s": q.tokens_per_s,
                "burst_requests": q.burst_requests,
                "burst_tokens": q.burst_tokens}
            for t, q in sorted(quotas.items())}})


class GatewayHTTPServer:
    """Lifecycle owner: `start()` boots the Gateway runtime + the
    listener; `stop()` drains in-flight requests, parks the fleet, and
    joins every thread.  `port`/`url()` tell where the service landed
    (ephemeral ports supported for tests)."""

    def __init__(self, gateway: Gateway, cfg: Optional[HTTPConfig] = None,
                 runtime_cfg: Optional[RuntimeConfig] = None):
        self.gateway = gateway
        self.cfg = cfg if cfg is not None else HTTPConfig()
        self._runtime_cfg = runtime_cfg
        self._httpd: Optional[_PooledHTTPServer] = None
        self._accept_thread: Optional[threading.Thread] = None
        self._pool: Optional[ThreadPoolExecutor] = None
        self._handles: Dict[int, GenerationHandle] = {}
        self._handles_lock = threading.Lock()
        self._inflight = 0
        self._state_cv = threading.Condition()
        self._closing = False

    # ---- in-flight request accounting (drain on stop) ------------- #
    def _enter(self) -> bool:
        with self._state_cv:
            if self._closing:
                return False
            self._inflight += 1
            return True

    def _leave(self):
        with self._state_cv:
            self._inflight -= 1
            self._state_cv.notify_all()

    def _track(self, rid: int, handle: GenerationHandle):
        with self._handles_lock:
            self._handles[rid] = handle

    def _untrack(self, rid: int):
        with self._handles_lock:
            self._handles.pop(rid, None)

    def _handle_for(self, rid: int) -> Optional[GenerationHandle]:
        with self._handles_lock:
            return self._handles.get(rid)

    def arch_cfg(self, model: str):
        catalog = self.gateway.c.catalog
        return catalog.get(model) if model in catalog else None

    # ---- lifecycle ------------------------------------------------ #
    @property
    def running(self) -> bool:
        return self._httpd is not None

    @property
    def port(self) -> int:
        if self._httpd is None:
            raise RuntimeError("server not started")
        return self._httpd.server_address[1]

    def url(self, path: str = "") -> str:
        return f"http://{self.cfg.host}:{self.port}{path}"

    def start(self) -> "GatewayHTTPServer":
        if self._httpd is not None:
            return self
        self.gateway.start(self._runtime_cfg)    # background pumps drive
        with self._state_cv:           # _enter/_leave race a restart
            self._closing = False
        self._pool = ThreadPoolExecutor(
            max_workers=self.cfg.max_workers,
            thread_name_prefix="http-worker")
        handler = type("GatewayHTTPHandler", (_Handler,),
                       {"timeout": self.cfg.keepalive_idle_s})
        self._httpd = _PooledHTTPServer(
            (self.cfg.host, self.cfg.port), handler, self._pool, self)
        self._accept_thread = threading.Thread(
            target=self._httpd.serve_forever,
            kwargs={"poll_interval": 0.05},
            name="http-accept", daemon=True)
        self._accept_thread.start()
        return self

    def stop(self, drain: bool = True,
             timeout_s: Optional[float] = None) -> bool:
        """Stop the service: refuse new requests, let in-flight ones
        (including open SSE streams) finish within the drain budget,
        force-close what remains, then park the Gateway runtime.
        Returns True when everything drained and joined."""
        if self._httpd is None:
            return True
        budget = (timeout_s if timeout_s is not None
                  else self.cfg.drain_timeout_s)
        deadline = time.monotonic() + budget
        with self._state_cv:
            self._closing = True
        self._httpd.shutdown()                  # stop accepting
        self._accept_thread.join(budget + 1.0)
        drained = True
        if drain:
            with self._state_cv:
                while self._inflight > 0:
                    left = deadline - time.monotonic()
                    if left <= 0:
                        break
                    self._state_cv.wait(min(left, 0.05))
                drained = self._inflight == 0
        if not drain or not drained:
            with self._handles_lock:    # abort whatever is still going
                for h in list(self._handles.values()):
                    h.cancel()
        self._httpd.close_connections()
        self._httpd.server_close()
        self._pool.shutdown(wait=False)
        self._httpd = None
        self._accept_thread = None
        stopped = self.gateway.stop(
            drain=drain, timeout_s=max(deadline - time.monotonic(), 1.0))
        return drained and stopped
