"""The port's wire service on its engines on the CPU, against the JAX
package's.

First the counterpart of tests/test_http.py, on the port's stack
(ErrorCode -> HTTP status mapping, SSE framing, chat-template golden
renders, tenant auth + rate limiting over keep-alive connections, remote
cancel, drain-on-stop, HTTP-vs-in-process greedy parity, the deprecated
client shim, the CLI).  Then the two services side by side: the JAX one
on JAX params and the port's on the same params carried across, on the
reduced OLMo-1B and on a reduced llama3.2-1b with grouped-query
attention (G = 4) and RMS-norm scales drawn from a seed; the same
requests over HTTP give the same greedy token ids, usage, SSE frames
(but for `id` and `created`), statuses and error bodies.  Then the
wizard, the launcher (`python -m repro_torch.api.http`'s
`build_service`) and the examples, on the CPU."""
import dataclasses
import http.client
import json
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import Gateway as JaxGateway
from repro.api.http import GatewayHTTPServer as JaxHTTPServer
from repro.api.http import HTTPConfig as JaxHTTPConfig
from repro.api.http import chat as jax_chat
from repro.cluster import BackendNode as JaxNode
from repro.cluster import Fleet as JaxFleet
from repro.configs import ARCHS as JAX_ARCHS
from repro.configs import ZOO as JAX_ZOO
from repro.core import ModelCatalog as JaxCatalog
from repro.core import ModelDemand as JaxDemand
from repro.core import SDAIController as JaxController
from repro.models import build as jax_build
from repro_torch import params as params_lib
from repro_torch.api import ErrorCode, Gateway, GatewayConfig
from repro_torch.api.http import (HTTP_STATUS, ChatMessage,
                                  GatewayHTTPServer, HTTPClient,
                                  HTTPClientError, HTTPConfig,
                                  decode_tokens, encode_text, error_body,
                                  render_prompt, template_for)
from repro_torch.api.http import chat as port_chat
from repro_torch.api.http.chat import CHATML, GEMMA, LLAMA3, PLAIN
from repro_torch.api.types import APIError
from repro_torch.cluster import BackendNode, Fleet, paper_testbed
from repro_torch.configs import ARCHS, ZOO
from repro_torch.core import (ConfigWizard, ControllerConfig,
                              ModelCatalog, ModelDemand, SDAIController,
                              WizardConfig, WizardModelChoice,
                              WizardSelection)
from repro_torch.models import build
from repro_torch.serving import SamplingParams

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def param_store():
    """The port's engines on the CPU: seeded params per config name."""
    cache = {}

    def store(cfg):
        if cfg.name not in cache:
            cache[cfg.name] = build(cfg, "cpu").init(
                torch.Generator().manual_seed(0))
        return cache[cfg.name]
    return store


MODEL = "olmo-1b-reduced"


def _stack(param_store, n_nodes=2, n_slots=2, max_len=160,
           min_replicas=2):
    fleet = Fleet([BackendNode(f"h{i}", "rx6800-16gb",
                               param_store=param_store, device="cpu")
                   for i in range(n_nodes)])
    cfg = ARCHS["olmo-1b"].reduced()
    catalog = ModelCatalog()
    catalog.register(cfg)
    ctrl = SDAIController(fleet, catalog)
    ctrl.cfg.fill_vram = False
    ctrl.discover()
    plan = ctrl.deploy([ModelDemand(cfg, min_replicas=min_replicas,
                                    max_replicas=min_replicas,
                                    n_slots=n_slots, max_len=max_len)])
    assert not plan.unplaced
    return fleet, ctrl


@pytest.fixture(scope="module")
def server(param_store):
    """Module-shared healthy service (tests that kill nodes or need a
    special GatewayConfig build their own)."""
    _, ctrl = _stack(param_store)
    srv = GatewayHTTPServer(Gateway(ctrl), HTTPConfig(port=0)).start()
    yield srv
    assert srv.stop(timeout_s=30.0)


@pytest.fixture()
def client(server):
    c = HTTPClient(server.url())
    yield c
    c.close()


# -------------------- error mapping -------------------------------- #
def test_status_table_covers_every_error_code():
    expected = {
        ErrorCode.NO_BACKEND: 503, ErrorCode.OVERLOADED: 429,
        ErrorCode.ENGINE_FAILED: 500, ErrorCode.CANCELLED: 499,
        ErrorCode.TIMEOUT: 504, ErrorCode.DRAINING: 503,
        ErrorCode.INVALID_REQUEST: 400, ErrorCode.RATE_LIMITED: 429,
    }
    assert HTTP_STATUS == expected          # every code, documented status
    for code in ErrorCode:
        body = error_body(APIError(code, "boom"))["error"]
        assert body["type"] == code.value
        assert body["code"] == expected[code]
        assert body["message"] == "boom"
        assert body["retryable"] == code.retryable


def test_every_error_code_reachable_over_http(param_store):
    """One stack, every taxonomy entry observed from the wire with its
    documented status (CANCELLED/ENGINE_FAILED via their own scenarios
    below)."""
    _, ctrl = _stack(param_store)
    srv = GatewayHTTPServer(Gateway(ctrl), HTTPConfig(port=0)).start()
    c = HTTPClient(srv.url())
    try:
        # INVALID_REQUEST (400): empty prompt
        with pytest.raises(HTTPClientError) as e:
            c.complete(MODEL, [], max_tokens=2)
        assert (e.value.status, e.value.code) == (
            400, ErrorCode.INVALID_REQUEST)
        # ... also malformed JSON bodies
        conn = http.client.HTTPConnection("127.0.0.1", srv.port)
        conn.request("POST", "/v1/completions", b"{not json",
                     {"Content-Type": "application/json"})
        assert conn.getresponse().status == 400
        conn.close()
        # NO_BACKEND (503): nothing serves the model
        with pytest.raises(HTTPClientError) as e:
            c.complete("ghost-model", [1], max_tokens=2)
        assert (e.value.status, e.value.code) == (
            503, ErrorCode.NO_BACKEND)
        assert e.value.retryable
        # TIMEOUT (504): sub-millisecond wall-clock deadline
        with pytest.raises(HTTPClientError) as e:
            c.complete(MODEL, [1, 2], max_tokens=140,
                       timeout_s=0.001)
        assert (e.value.status, e.value.code) == (504, ErrorCode.TIMEOUT)
        # RATE_LIMITED (429): tenant bucket of one request, no refill
        c.set_tenant_quota("wire-capped", requests_per_s=0.001,
                           burst_requests=1)
        capped = HTTPClient(srv.url(), tenant="wire-capped")
        assert capped.complete(MODEL, [1], max_tokens=2)["choices"]
        with pytest.raises(HTTPClientError) as e:
            capped.complete(MODEL, [1], max_tokens=2)
        assert (e.value.status, e.value.code) == (
            429, ErrorCode.RATE_LIMITED)
        capped.close()
        # DRAINING (503): admin drain, then resume restores service
        assert c.admin_drain(MODEL)["drained"]
        with pytest.raises(HTTPClientError) as e:
            c.complete(MODEL, [1], max_tokens=2)
        assert (e.value.status, e.value.code) == (503, ErrorCode.DRAINING)
        c.admin_resume(MODEL)
        assert c.complete(MODEL, [1], max_tokens=2)["choices"]
    finally:
        c.close()
        assert srv.stop(timeout_s=30.0)


def test_overloaded_maps_to_429(param_store):
    _, ctrl = _stack(param_store)
    gw = Gateway(ctrl, GatewayConfig(max_inflight_per_model=0))
    srv = GatewayHTTPServer(gw, HTTPConfig(port=0)).start()
    c = HTTPClient(srv.url())
    try:
        with pytest.raises(HTTPClientError) as e:
            c.complete(MODEL, [1], max_tokens=2)
        assert (e.value.status, e.value.code) == (
            429, ErrorCode.OVERLOADED)
        # stream requests see the same plain HTTP rejection, not SSE
        with pytest.raises(HTTPClientError) as e:
            list(c.complete(MODEL, [1], max_tokens=2, stream=True))
        assert e.value.status == 429
    finally:
        c.close()
        assert srv.stop(timeout_s=30.0)


def test_cancelled_maps_to_499(param_store):
    """Remote cancel: a non-stream request blocked decoding is aborted
    from a second connection and comes back as HTTP 499."""
    _, ctrl = _stack(param_store, n_nodes=1, min_replicas=1)
    srv = GatewayHTTPServer(Gateway(ctrl), HTTPConfig(port=0)).start()
    c = HTTPClient(srv.url())
    errors = []

    def blocked():
        try:
            c.complete(MODEL, [1, 2], max_tokens=140, timeout_s=60)
        except HTTPClientError as e:
            errors.append(e)

    t = threading.Thread(target=blocked)
    t.start()
    try:
        rid = None
        deadline = time.monotonic() + 30
        while rid is None and time.monotonic() < deadline:
            with srv._handles_lock:
                ids = list(srv._handles)
            rid = ids[0] if ids else None
            time.sleep(0.01)
        assert rid is not None
        c2 = HTTPClient(srv.url())
        assert c2.cancel(rid) is True
        t.join(timeout=30)
        assert not t.is_alive()
        assert len(errors) == 1
        assert (errors[0].status, errors[0].code) == (
            499, ErrorCode.CANCELLED)
        # cancelling a settled request 404s (handle untracked just
        # after the 499 is written; poll past that sliver)
        deadline = time.monotonic() + 10
        while True:
            try:
                assert c2.cancel(rid) is False   # done, still tracked
                assert time.monotonic() < deadline
                time.sleep(0.01)
            except HTTPClientError as e:
                assert e.status == 404
                break
        c2.close()
    finally:
        t.join(timeout=5)
        c.close()
        assert srv.stop(timeout_s=30.0)


def test_engine_failure_midstream_is_terminal_sse_error(param_store):
    """After the first streamed token a backend death surfaces as a
    terminal SSE error frame (engine_failed, code 500) followed by
    [DONE] — never a broken stream."""
    fleet, ctrl = _stack(param_store, n_nodes=1, min_replicas=1)
    srv = GatewayHTTPServer(Gateway(ctrl), HTTPConfig(port=0)).start()
    c = HTTPClient(srv.url())
    try:
        frames = []
        for chunk in c.complete(MODEL, [1, 2, 3], max_tokens=140,
                                stream=True, timeout_s=60):
            frames.append(chunk)
            if len([f for f in frames if "error" not in f
                    and f["choices"][0].get("token") is not None]) == 1:
                fleet.fail_node("h0")       # mid-stream outage
        assert "error" in frames[-1]        # terminal structured frame
        err = frames[-1]["error"]
        assert err["type"] == "engine_failed"
        assert err["code"] == 500
        # the SSE generator only returns on [DONE], so reaching here
        # proves the terminator followed the error frame
    finally:
        c.close()
        srv.stop(timeout_s=30.0)


# -------------------- basic surface -------------------------------- #
def test_healthz_and_models(client):
    health = client.healthz()
    assert health["status"] == "ok" and health["runtime_active"]
    entries = client.models_full()
    assert [m["id"] for m in entries] == [MODEL]
    assert entries[0]["family"] == "dense"
    assert entries[0]["replicas"] == 2
    assert entries[0]["max_context"] == 160


def test_http_greedy_matches_inprocess_gateway(server, client):
    """Acceptance: completion bytes over the socket == Gateway.generate
    for the same request."""
    prompt = [1, 2, 3, 4]
    out = client.complete(MODEL, prompt, max_tokens=8)
    resp = server.gateway.generate(MODEL, prompt,
                                   SamplingParams(max_tokens=8),
                                   timeout_s=60)
    assert resp.ok
    choice = out["choices"][0]
    assert choice["token_ids"] == list(resp.tokens)
    assert choice["text"] == decode_tokens(resp.tokens)
    assert choice["finish_reason"] == resp.finish_reason
    assert out["usage"] == {"prompt_tokens": 4, "completion_tokens": 8,
                            "total_tokens": 12}
    assert out["metadata"]["node"].startswith("h")


def test_text_prompt_encodes_with_model_vocab(client):
    out = client.complete(MODEL, "hi!", max_tokens=4)
    assert out["usage"]["prompt_tokens"] == len("hi!".encode())


def test_stream_final_chunks_carry_usage(client):
    """OpenAI parity: the terminal chunk of a completion stream and of a
    chat stream carries the `usage` object; token chunks never do."""
    chunks = list(client.complete(MODEL, [1, 2, 3], max_tokens=4,
                                  stream=True))
    final = chunks[-1]
    assert final["choices"][0]["finish_reason"] == "length"
    assert final["usage"] == {"prompt_tokens": 3, "completion_tokens": 4,
                              "total_tokens": 7}
    assert all("usage" not in ch for ch in chunks[:-1])
    chat_chunks = list(client.chat(MODEL, ["hi"], max_tokens=4,
                                   stream=True))
    cfinal = chat_chunks[-1]
    assert cfinal["choices"][0]["finish_reason"] == "length"
    assert cfinal["usage"]["completion_tokens"] == 4
    assert cfinal["usage"]["prompt_tokens"] > 0      # templated prompt
    assert cfinal["usage"]["total_tokens"] == \
        cfinal["usage"]["prompt_tokens"] + 4
    assert all("usage" not in ch for ch in chat_chunks[:-1])


def test_sse_stream_framing(server):
    """Raw-socket SSE: ordered data frames, one finish chunk, then the
    literal `data: [DONE]` terminator."""
    conn = http.client.HTTPConnection("127.0.0.1", server.port,
                                      timeout=60)
    conn.request("POST", "/v1/completions", json.dumps({
        "model": MODEL, "prompt": [5, 6], "max_tokens": 6,
        "stream": True}), {"Content-Type": "application/json"})
    resp = conn.getresponse()
    assert resp.status == 200
    assert resp.headers["Content-Type"] == "text/event-stream"
    assert int(resp.headers["X-Request-Id"]) >= 0
    payloads = []
    while True:
        line = resp.readline().strip()
        if not line.startswith(b"data:"):
            continue
        data = line[len(b"data:"):].strip()
        payloads.append(data)
        if data == b"[DONE]":
            break
    conn.close()
    assert payloads[-1] == b"[DONE]"
    frames = [json.loads(p) for p in payloads[:-1]]
    tokens = [f["choices"][0] for f in frames
              if f["choices"][0].get("token") is not None]
    assert [t["token_index"] for t in tokens] == list(range(6))
    finals = [f for f in frames if f["choices"][0]["finish_reason"]]
    assert len(finals) == 1                 # exactly one terminal chunk
    assert finals[0]["choices"][0]["finish_reason"] == "length"
    assert frames[-1] is finals[0]          # ... and it precedes [DONE]


def test_chat_stream_role_then_deltas(client):
    frames = list(client.chat(MODEL, ["hello"], max_tokens=5,
                              stream=True))
    assert frames[0]["choices"][0]["delta"]["role"] == "assistant"
    toks = [f["choices"][0]["delta"] for f in frames
            if f["choices"][0].get("delta", {}).get("token") is not None]
    assert len(toks) == 5
    assert [d["token_index"] for d in toks] == list(range(5))
    assert frames[-1]["choices"][0]["finish_reason"] == "length"


def test_stream_tokens_match_nonstream(client):
    streamed = [f["choices"][0]["token"]
                for f in client.complete(MODEL, [9, 8, 7], max_tokens=6,
                                         stream=True)
                if f["choices"][0].get("token") is not None]
    flat = client.complete(MODEL, [9, 8, 7], max_tokens=6)
    assert streamed == flat["choices"][0]["token_ids"]


def test_validation_errors(client):
    for body_err in (
            {"prompt": [1], "max_tokens": 0},
            {"prompt": [1], "temperature": -1.0},
            {"prompt": [1], "top_p": 0.0},
            {"prompt": [1], "n": 2},
            {"prompt": [1, "x"]},
            {"prompt": [1], "timeout_s": 0},
    ):
        with pytest.raises(HTTPClientError) as e:
            client.complete(MODEL, body_err.pop("prompt"), max_tokens=2,
                            extra=body_err)
        assert e.value.status == 400, body_err
    with pytest.raises(HTTPClientError) as e:
        client.chat(MODEL, [{"role": "alien", "content": "hi"}])
    assert e.value.status == 400
    with pytest.raises(HTTPClientError) as e:
        client.chat(MODEL, [])
    assert e.value.status == 400


def test_unknown_route_and_method(server):
    conn = http.client.HTTPConnection("127.0.0.1", server.port)
    conn.request("GET", "/v2/everything")
    resp = conn.getresponse()
    assert resp.status == 404
    resp.read()                    # keep-alive: drain before reuse
    conn.request("GET", "/v1/completions")
    resp = conn.getresponse()
    assert resp.status == 405
    resp.read()
    conn.close()


# -------------------- chat templates ------------------------------- #
def test_template_registry_resolution():
    assert template_for("llama3.2-1b") is LLAMA3
    assert template_for("llama3.2-1b-reduced") is LLAMA3
    assert template_for("gemma3-4b") is GEMMA
    assert template_for("qwen3-8b") is CHATML
    assert template_for("deepseek-r1-7b") is CHATML
    assert template_for("mystery-model") is PLAIN


def test_chat_template_golden_renders():
    msgs = [ChatMessage("system", "be brief"), ChatMessage("user", "hi")]
    assert LLAMA3.render_text(msgs) == (
        "<|begin_of_text|>"
        "<|start_header_id|>system<|end_header_id|>\n\nbe brief<|eot_id|>"
        "<|start_header_id|>user<|end_header_id|>\n\nhi<|eot_id|>"
        "<|start_header_id|>assistant<|end_header_id|>\n\n")
    assert GEMMA.render_text(msgs) == (
        "<bos>"
        "<start_of_turn>system\nbe brief<end_of_turn>\n"
        "<start_of_turn>user\nhi<end_of_turn>\n"
        "<start_of_turn>model\n")
    assert CHATML.render_text(msgs) == (
        "<|im_start|>system\nbe brief<|im_end|>\n"
        "<|im_start|>user\nhi<|im_end|>\n"
        "<|im_start|>assistant\n")
    assert PLAIN.render_text(msgs) == (
        "system: be brief\nuser: hi\nassistant:")
    # assistant -> model rename is gemma-only
    turn = [ChatMessage("assistant", "ok")]
    assert "<start_of_turn>model\nok" in GEMMA.render_text(turn)
    assert "assistant\nok" in CHATML.render_text(turn)


def test_vision_models_get_image_marker_and_prefix_budget():
    from repro_torch.api.http import prefix_budget
    vlm = ZOO["gemma3-4b"].reduced()            # frontend="vision"
    assert prefix_budget(vlm) > 0
    msgs = [ChatMessage("user", "what is this?")]
    with_marker = render_prompt(vlm.name, msgs, vlm)
    text = GEMMA.render_text(msgs, vision=True)
    assert with_marker == encode_text(text, vlm.vocab)
    assert "<start_of_image>" in text
    # non-vision render of the same family omits the marker
    dense = ZOO["gemma3-1b"].reduced()
    assert "<start_of_image>" not in GEMMA.render_text(msgs)
    assert len(render_prompt(dense.name, msgs, dense)) < len(with_marker)


def test_codec_roundtrip():
    text = "hello ☃ world"
    toks = encode_text(text, 256)
    assert decode_tokens(toks) == text
    assert decode_tokens([72, 105, 9999]) == "Hi�"


# -------------------- tenancy over keep-alive ---------------------- #
def test_concurrent_keepalive_tenants_one_rate_limited(server, client):
    """Two tenants on concurrent keep-alive connections: the capped one
    sees 429 RATE_LIMITED mid-burst, the free one never does."""
    client.set_tenant_quota("ka-capped", requests_per_s=0.001,
                            burst_requests=2)
    results = {}

    def worker(tenant):
        c = HTTPClient(server.url(), tenant=tenant)
        ok, limited, other = 0, 0, []
        first = c.healthz()                      # open the connection
        sock = c._conn.sock
        for i in range(5):
            try:
                c.complete(MODEL, [1, 2, i + 1], max_tokens=3,
                           timeout_s=60)
                ok += 1
            except HTTPClientError as e:
                if e.code is ErrorCode.RATE_LIMITED:
                    limited += 1
                else:
                    other.append(e)
        reused = c._conn is not None and c._conn.sock is sock
        results[tenant] = (ok, limited, other, reused, first)
        c.close()

    threads = [threading.Thread(target=worker, args=(t,))
               for t in ("ka-free", "ka-capped")]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
        assert not t.is_alive()
    ok, limited, other, reused, _ = results["ka-free"]
    assert (ok, limited, other) == (5, 0, [])
    assert reused                       # keep-alive: one socket, 6 calls
    ok, limited, other, reused, _ = results["ka-capped"]
    assert ok == 2 and limited == 3 and other == []
    assert reused                       # 429s ride the same connection
    client.remove_tenant_quota("ka-capped")


def test_tenant_quota_admin_roundtrip(client):
    client.set_tenant_quota("acme", requests_per_s=7, tokens_per_s=100)
    quotas = client.tenant_quotas()
    assert quotas["acme"]["requests_per_s"] == 7
    assert quotas["acme"]["tokens_per_s"] == 100
    client.remove_tenant_quota("acme")
    assert "acme" not in client.tenant_quotas()


# -------------------- stale-connection retry ----------------------- #
class _FakeSock:
    def __init__(self):
        self.data = b""

    def sendall(self, b):
        self.data += b

    def close(self):
        pass


class _FlakyConn:
    """Connection whose first `request` dies with OSError — optionally
    after pushing bytes onto the wire (the stale keep-alive case)."""

    def __init__(self, send_bytes=True):
        self.sock = None
        self.attempts = 0
        self._failed = False
        self._send = send_bytes

    def connect(self):
        self.sock = _FakeSock()

    def request(self, method, path, body=None, headers=None):
        self.attempts += 1
        if not self._failed:
            self._failed = True
            if self._send:
                self.sock.sendall(b"POST /x HTTP/1.1\r\n")
            raise OSError(104, "connection reset by peer")
        self.sock.sendall(b"ok")

    def getresponse(self):
        class _R:
            status = 200
            headers = {}

            def read(self):
                return b"{}"
        return _R()

    def close(self):
        self.sock = None


def _patched_client(conn):
    c = HTTPClient("http://127.0.0.1:1")
    c._connection = lambda: conn
    return c


def test_post_with_bytes_on_wire_is_not_retried():
    """A send error after request bytes reached the socket may still
    have delivered the whole request — blind-retrying a generation POST
    there could double-submit and double-charge it, so the client must
    surface the error instead."""
    conn = _FlakyConn(send_bytes=True)
    with pytest.raises(OSError):
        _patched_client(conn)._json("POST", "/v1/completions", {"x": 1})
    assert conn.attempts == 1


def test_get_and_zero_byte_post_failures_are_retried():
    """Idempotent GETs always retry once; a POST whose send died before
    any byte left the client cannot have been acted on, so it retries
    too."""
    conn = _FlakyConn(send_bytes=True)
    assert _patched_client(conn)._json("GET", "/healthz") == {}
    assert conn.attempts == 2
    conn = _FlakyConn(send_bytes=False)
    assert _patched_client(conn)._json("POST", "/v1/x", {"x": 1}) == {}
    assert conn.attempts == 2


# -------------------- admin over the wire -------------------------- #
def test_admin_cache_flush_over_wire(client):
    """The flush verb round-trips; engines deployed without a prefix
    cache report zero flushed/remaining."""
    res = client.admin_cache_flush()
    assert res == {"flushed": 0, "remaining": 0}
    res = client.admin_cache_flush(MODEL)
    assert set(res) == {"flushed", "remaining"}


def test_admin_snapshot_and_scale(client):
    snap = client.admin_snapshot()
    assert snap["connected"] == 2
    assert snap["models"][MODEL] == 2
    assert client.admin_scale(MODEL, 2)["ok"]       # no-op at target
    with pytest.raises(HTTPClientError) as e:
        client.admin_deploy("never-registered")
    assert e.value.status == 400


# -------------------- lifecycle ------------------------------------ #
def test_stop_drains_inflight_stream(param_store):
    """stop(drain=True) lets an open SSE stream finish ([DONE] arrives)
    before the server parks, then refuses new connections."""
    _, ctrl = _stack(param_store)
    srv = GatewayHTTPServer(Gateway(ctrl), HTTPConfig(port=0)).start()
    url = srv.url()
    c = HTTPClient(url)
    frames = []
    stream = c.complete(MODEL, [1, 2], max_tokens=40, stream=True,
                        timeout_s=60)
    frames.append(next(stream))                  # stream is live
    stopped = {}
    t = threading.Thread(
        target=lambda: stopped.update(ok=srv.stop(timeout_s=60.0)))
    t.start()
    frames.extend(stream)                        # drain to [DONE]
    t.join(timeout=90)
    assert not t.is_alive() and stopped["ok"] is True
    toks = [f for f in frames
            if f["choices"][0].get("token") is not None]
    assert len(toks) == 40                       # nothing truncated
    assert frames[-1]["choices"][0]["finish_reason"] == "length"
    c.close()
    with pytest.raises((ConnectionRefusedError, HTTPClientError, OSError)):
        HTTPClient(url).healthz()


def test_deprecated_client_shim_warns(param_store):
    from repro_torch.core import Client
    _, ctrl = _stack(param_store, n_nodes=1, min_replicas=1)
    with pytest.warns(DeprecationWarning, match="Gateway"):
        shim = Client(ctrl)
    req = shim.generate(MODEL, [1, 2], SamplingParams(max_tokens=3))
    assert len(req.output) == 3                  # still functional


# -------------------- CLI ------------------------------------------ #
def test_cli_models_complete_and_stream(server, capsys):
    from repro_torch.api.http.client import _main
    url = server.url()
    assert _main(["--url", url, "models"]) == 0
    out = capsys.readouterr().out
    assert MODEL in out and "replicas=2" in out
    assert _main(["--url", url, "complete", MODEL, "1,2,3", "--tokens",
                  "--max-tokens", "4"]) == 0
    body = json.loads(capsys.readouterr().out)
    assert len(body["choices"][0]["token_ids"]) == 4
    assert _main(["--url", url, "chat", MODEL, "hello",
                  "--max-tokens", "3", "--stream"]) == 0
    assert "[finish] length" in capsys.readouterr().out
    assert _main(["--url", url, "health"]) == 0
    assert json.loads(capsys.readouterr().out)["status"] == "ok"


def test_keepalive_responses_are_not_held_by_nagle(client):
    """Every response on a keep-alive connection leaves at once: the
    client's latency less the Gateway's stays far below the ~40 ms that a
    delayed acknowledgement costs when the server's second small write
    waits on Nagle's algorithm (the reference's server: no TCP_NODELAY)."""
    extra = []
    for i in range(9):
        t0 = time.perf_counter()
        out = client.complete(MODEL, [1, 2, i + 1], max_tokens=2)
        extra.append(time.perf_counter() - t0
                     - out["metadata"]["latency_s"])
    assert sorted(extra)[len(extra) // 2] < 0.025, extra


def test_wire_cancel_releases_pages_under_the_instance_lock(param_store):
    """A cancel over the wire reaches `engine.cancel` from a handler
    thread, holding the instance lock that the pump thread steps the
    engine under; the stream ends in a 499 frame and the slot's pages
    come back."""
    fleet, ctrl = _stack(param_store, n_nodes=1, min_replicas=1)
    insts = [i for n in fleet.nodes.values() for i in n.instances.values()]
    held = []
    for inst in insts:
        def checked(rid, cancel=inst.engine.cancel, lock=inst.lock):
            held.append(lock._is_owned())
            return cancel(rid)
        inst.engine.cancel = checked
    srv = GatewayHTTPServer(Gateway(ctrl), HTTPConfig(port=0)).start()
    c, c2 = HTTPClient(srv.url()), HTTPClient(srv.url())
    try:
        frames, cancelled = [], None
        for ch in c.complete(MODEL, [1, 2, 3], max_tokens=140, stream=True,
                             timeout_s=60):
            frames.append(ch)
            if cancelled is None and "error" not in ch \
                    and ch["choices"][0].get("token") is not None:
                cancelled = c2.cancel(int(ch["id"].rsplit("-", 1)[1]))
        assert cancelled is True
        assert frames[-1]["error"]["code"] == 499
    finally:
        c.close()
        c2.close()
        assert srv.stop(timeout_s=30.0)
    assert held == [True]
    assert all(i.engine.pool.pages_in_use == 0 for i in insts)


# -------------------- the port's service against JAX's ------------- #
PARITY = {
    # name: (JAX config, port config); llama: G = 4, RMS scales seeded
    "olmo": lambda z, a: a["olmo-1b"].reduced(dtype="f32",
                                              name="olmo-1b-reduced-f32"),
    "llama-g4": lambda z, a: z["llama3.2-1b"].reduced(
        dtype="f32", n_kv_heads=1, name="llama3.2-1b"),
}


def _jax_params(cfg):
    """JAX-initialised params with every RMS-norm scale drawn from a numpy
    seed, so that `(1 + scale)` is not the identity."""
    params = jax_build(cfg).init(jax.random.PRNGKey(0))
    if cfg.norm == "rms":
        rng = np.random.default_rng(5)

        def seeded(a):
            return jnp.asarray(rng.normal(0.0, 0.5, a.shape), a.dtype)
        params["layers"]["ln1"] = seeded(params["layers"]["ln1"])
        params["layers"]["ln2"] = seeded(params["layers"]["ln2"])
        params["final_norm"] = seeded(params["final_norm"])
    return params


def _parity_requests(model, vocab):
    """(kind, path, body) greedy requests: token-id and text completions,
    chats, streamed and not."""
    rng = np.random.default_rng(11)
    ids = [rng.integers(0, vocab, n).tolist() for n in (4, 21, 40)]
    msgs = [{"role": "system", "content": "be brief"},
            {"role": "user", "content": "hi"}]
    out = []
    for stream in (False, True):
        for prompt, n in zip(ids, (8, 12, 5)):
            out.append(("/v1/completions", {
                "model": model, "prompt": prompt, "max_tokens": n,
                "stream": stream}))
        out.append(("/v1/completions", {
            "model": model, "prompt": "hi!", "max_tokens": 6,
            "stream": stream}))
        out.append(("/v1/chat/completions", {
            "model": model, "messages": msgs, "max_tokens": 7,
            "stream": stream}))
    return out


def _invalid_requests(model, max_len):
    ok = {"model": model, "prompt": [1, 2]}
    return [
        ("POST", "/v1/completions", {**ok, "prompt": []}),
        ("POST", "/v1/completions", {**ok, "max_tokens": 0}),
        ("POST", "/v1/completions", {**ok, "temperature": -1.0}),
        ("POST", "/v1/completions", {**ok, "top_p": 0.0}),
        ("POST", "/v1/completions", {**ok, "n": 2}),
        ("POST", "/v1/completions", {**ok, "prompt": [1, "x"]}),
        ("POST", "/v1/completions", {**ok, "timeout_s": 0}),
        ("POST", "/v1/completions", {**ok, "prompt": [1] * (max_len + 1)}),
        ("POST", "/v1/completions", {**ok, "model": "ghost-model"}),
        ("POST", "/v1/completions", b"{not json"),
        ("POST", "/v1/completions", {"prompt": [1]}),
        ("POST", "/v1/chat/completions", {
            "model": model, "messages": [{"role": "alien",
                                          "content": "hi"}]}),
        ("POST", "/v1/chat/completions", {"model": model, "messages": []}),
        ("POST", "/v1/requests/abc/cancel", b""),
        ("POST", "/v1/requests/123456/cancel", b""),
        ("GET", "/v2/everything", None),
        ("GET", "/v1/completions", None),
    ]


def _exchange(port, method, path, body):
    """One raw request: (status, JSON body) or, for SSE, (status, frames
    with `id` and `created` dropped, the terminator kept)."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    data = body if isinstance(body, (bytes, type(None))) \
        else json.dumps(body).encode()
    conn.request(method, path, data, {"Content-Type": "application/json"})
    resp = conn.getresponse()
    if resp.headers.get("Content-Type") != "text/event-stream":
        out = (resp.status, json.loads(resp.read()))
        conn.close()
        return out
    frames = []
    while True:
        line = resp.readline().strip()
        if not line.startswith(b"data:"):
            continue
        payload = line[len(b"data:"):].strip()
        if payload == b"[DONE]":
            frames.append("[DONE]")
            break
        frame = json.loads(payload)
        frame.pop("id")
        frame.pop("created")
        frames.append(frame)
    conn.close()
    return resp.status, frames


def _wire_fields(out):
    """A non-streamed response's wire fields (all but `id` and `created`);
    SSE frames as they are."""
    if not isinstance(out, dict):
        return out
    choice = out["choices"][0]
    return {"token_ids": choice["token_ids"],
            "text": choice.get("text", choice.get("message")),
            "finish_reason": choice["finish_reason"],
            "usage": out["usage"], "object": out["object"],
            "model": out["model"]}


def _serve_and_collect(server, requests, invalid):
    server.start()
    try:
        port = server.port
        got = []
        for path, body in requests:
            status, out = _exchange(port, "POST", path, body)
            got.append((status, _wire_fields(out)))
        errors = [_exchange(port, *case) for case in invalid]
    finally:
        assert server.stop(timeout_s=30.0)
    return got, errors


@pytest.fixture(scope="module", params=sorted(PARITY))
def wire_pair(request):
    """The same requests through the JAX service and the port's, each on
    two nodes (one replica each) with the same params."""
    jcfg = PARITY[request.param](JAX_ZOO, JAX_ARCHS)
    pcfg = PARITY[request.param](ZOO, ARCHS)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(pcfg)
    jparams = _jax_params(jcfg)
    tparams = params_lib.from_jax(jax.tree.map(np.asarray, jparams), pcfg,
                                  "cpu")
    max_len = 256
    reqs = _parity_requests(pcfg.name, pcfg.vocab)
    invalid = _invalid_requests(pcfg.name, max_len)
    out = {}
    for side, node_of, catalog, ctrl_cls, demand, gw_cls, srv_cls, \
            http_cfg, cfg, params in (
                ("jax", lambda i: JaxNode(f"h{i}", "v5e-1",
                                          param_store=lambda c: jparams),
                 JaxCatalog(), JaxController, JaxDemand, JaxGateway,
                 JaxHTTPServer, JaxHTTPConfig, jcfg, jparams),
                ("port", lambda i: BackendNode(
                    f"h{i}", "rx6800-16gb", param_store=lambda c: tparams,
                    device="cpu"),
                 ModelCatalog(), SDAIController, ModelDemand, Gateway,
                 GatewayHTTPServer, HTTPConfig, pcfg, tparams)):
        fleet_cls = JaxFleet if side == "jax" else Fleet
        fleet = fleet_cls([node_of(i) for i in range(2)])
        catalog.register(cfg)
        ctrl = ctrl_cls(fleet, catalog)
        ctrl.cfg.fill_vram = False
        ctrl.discover()
        plan = ctrl.deploy([demand(cfg, min_replicas=2, max_replicas=2,
                                   n_slots=2, max_len=max_len)])
        assert not plan.unplaced
        srv = srv_cls(gw_cls(ctrl), http_cfg(port=0))
        out[side] = _serve_and_collect(srv, reqs, invalid)
    return request.param, pcfg, out


def test_wire_greedy_tokens_usage_and_sse_match_jax(wire_pair):
    name, cfg, out = wire_pair
    jgot, pgot = out["jax"][0], out["port"][0]
    assert len(pgot) == len(jgot) == 10
    for (js, jo), (ps, po) in zip(jgot, pgot):
        assert ps == js == 200
        assert po == jo
    # the streams carry every token and end in one usage chunk, [DONE]
    streamed = [o for _, o in pgot if isinstance(o, list)]
    assert len(streamed) == 5 and all(f[-1] == "[DONE]" for f in streamed)
    assert all("usage" in f[-2] for f in streamed)


def test_wire_statuses_and_error_bodies_match_jax(wire_pair):
    name, cfg, out = wire_pair
    jerr, perr = out["jax"][1], out["port"][1]
    assert perr == jerr
    statuses = [s for s, _ in perr]
    assert statuses == [400] * 8 + [503, 400, 400, 400, 400, 400, 404, 404,
                                    405]


MESSAGES = [ChatMessage("system", "be brief"), ChatMessage("user", "hi"),
            ChatMessage("assistant", "ok"), ChatMessage("user", "☃ again")]


@pytest.mark.parametrize("prefix", sorted(jax_chat._REGISTRY) + ["mystery"])
def test_render_prompt_matches_jax_for_every_template(prefix):
    """Each registered template renders the same ids in both packages,
    with no config, with a text config and with a vision one."""
    jmsgs = [jax_chat.ChatMessage(m.role, m.content) for m in MESSAGES]
    assert sorted(port_chat._REGISTRY) == sorted(jax_chat._REGISTRY)
    name = f"{prefix}-7b"
    for zoo_name in (None, "llama3.2-1b", "gemma3-4b"):
        jcfg = JAX_ZOO[zoo_name].reduced() if zoo_name else None
        pcfg = ZOO[zoo_name].reduced() if zoo_name else None
        assert port_chat.render_prompt(name, MESSAGES, pcfg) == \
            jax_chat.render_prompt(name, jmsgs, jcfg)
    assert port_chat.template_for(name).name == \
        jax_chat.template_for(name).name


# -------------------- wizard ---------------------------------------- #
def test_wizard_select_configure_generate(param_store):
    """tests/test_controller.py's wizard flow on the port's control
    plane."""
    fleet = paper_testbed(param_store=param_store, device="cpu")
    catalog = ModelCatalog()
    catalog.register(dataclasses.replace(ZOO["llama3.2-1b"].reduced(),
                                         name="llama3.2-1b"))
    catalog.register(ZOO["deepseek-r1-7b"])
    catalog.register(ZOO["qwen3-8b"])
    ctrl = SDAIController(fleet, catalog, ControllerConfig())
    ctrl.discover()
    wiz = ConfigWizard(ctrl)
    agents = wiz.list_agents()
    assert len(agents) == 6 and all("hbm_free_gb" in a for a in agents)
    cap = wiz.model_capacity("deepseek-r1-7b", "node6")
    assert cap["max_instances"] >= 1
    gen = wiz.generate(WizardConfig(
        selection=WizardSelection(agents=[a["node_id"] for a in agents],
                                  gpu_enabled={"node3": False}),
        models=[WizardModelChoice("deepseek-r1-7b", replicas=2),
                WizardModelChoice("qwen3-8b", replicas=1, port=12000)],
    ))
    ov = gen["overview"]
    assert ov["system_stats"]["agents"] == 5      # node3 GPU disabled
    assert ov["model_distribution"]["deepseek-r1-7b"] >= 2
    assert ov["ports"]["qwen3-8b"] == 12000
    assert "node3" not in ov["agent_distribution"]       # GPU disabled
    assert "backend bk_deepseek-r1-7b" in ov["frontend_config"]
    keys = wiz.apply(gen)
    assert len(keys) == len(gen["plan"].assignments)


# -------------------- the launcher ---------------------------------- #
def test_launcher_serves_reduced_models_on_cpu():
    """`python -m repro_torch.api.http --device cpu --reduced`'s own code:
    both default models, two replicas each, every one an engine on the
    CPU, answering /healthz, /v1/models and a chat."""
    from repro_torch.api.http.__main__ import build_service
    server, ctrl = build_service(["--device", "cpu", "--reduced",
                                  "--port", "0"])
    insts = [i for n in ctrl.fleet.nodes.values()
             for i in n.instances.values()]
    assert sorted(i.model_name for i in insts) == \
        ["gemma3-1b"] * 2 + ["llama3.2-1b"] * 2
    assert all(i.engine is not None and i.engine.device.type == "cpu"
               for i in insts)
    server.start()
    c = HTTPClient(server.url())
    try:
        assert c.healthz()["status"] == "ok"
        assert sorted(c.models()) == ["gemma3-1b", "llama3.2-1b"]
        for model in ("llama3.2-1b", "gemma3-1b"):
            out = c.chat(model, ["hello"], max_tokens=5)
            assert len(out["choices"][0]["token_ids"]) == 5
            assert out["usage"]["completion_tokens"] == 5
    finally:
        c.close()
        assert server.stop(timeout_s=30.0)


@pytest.mark.parametrize("argv", [
    ["--models", "xlstm-125m", "--device", "cpu", "--reduced"],
    ["--models", "qwen3-1.7b,seamless-m4t-large-v2", "--device", "cpu",
     "--reduced"],
    ["--models", "seamless-m4t-large-v2", "--device", "cpu", "--reduced"],
])
def test_launcher_refuses_models_the_port_does_not_run(argv, monkeypatch):
    """No family is refused any more: with xLSTM and the encoder-decoder
    patched into the zoo (the paper's zoo has neither), the launcher
    serves each reduced on the CPU, two replicas each, and a chat through
    each returns its max_tokens.  The name dates from when the port
    refused both families."""
    from repro_torch.api.http import __main__ as port_main
    from repro_torch.api.http.__main__ import build_service
    from repro_torch.configs import ARCHS as PORT_ARCHS
    for name in ("xlstm-125m", "seamless-m4t-large-v2"):
        monkeypatch.setitem(port_main.ZOO, name, PORT_ARCHS[name])
    models = argv[1].split(",")
    server, ctrl = build_service(argv + ["--port", "0"])
    insts = [i for n in ctrl.fleet.nodes.values()
             for i in n.instances.values()]
    assert sorted(i.model_name for i in insts) == sorted(models * 2)
    assert all(i.engine is not None and i.engine.device.type == "cpu"
               for i in insts)
    server.start()
    c = HTTPClient(server.url())
    try:
        assert sorted(c.models()) == sorted(models)
        for model in models:
            out = c.chat(model, ["hello"], max_tokens=5)
            assert len(out["choices"][0]["token_ids"]) == 5
            assert out["usage"]["completion_tokens"] == 5
    finally:
        c.close()
        assert server.stop(timeout_s=30.0)


@pytest.mark.parametrize("models", ["gemma3-4b", "qwen2.5vl-3b",
                                    "qwen3-1.7b"])
def test_launcher_serves_more_zoo_models_by_name(models):
    """gemma3-4b and qwen2.5vl-3b (256 vision prefix tokens, the reduced
    config's 4) and qwen3-1.7b, by name: a chat through each."""
    from repro_torch.api.http.__main__ import build_service
    server, ctrl = build_service(["--device", "cpu", "--reduced", "--port",
                                  "0", "--models", models])
    server.start()
    c = HTTPClient(server.url())
    try:
        assert c.models() == [models]
        out = c.chat(models, ["hello"], max_tokens=4)
        assert out["usage"]["completion_tokens"] == 4
    finally:
        c.close()
        assert server.stop(timeout_s=30.0)


def test_launcher_gemma_wire_matches_jax_launcher(monkeypatch):
    """The reference launcher's default second model, the reduced
    gemma3-1b (gelu, window 16, G = 4), served by both launchers' own code
    on the same argv: the JAX one (`repro.api.http.__main__.main`, run in
    a thread until its sleep is interrupted) and the port's with
    `--device cpu --reduced`, the port on the JAX launcher's params
    carried across.  The same greedy requests over HTTP give the same
    token ids, usage and SSE frames.  Both zoo entries are put in f32 for
    the test, as every greedy parity test of the port runs (bf16
    near-ties can flip an argmax across frameworks)."""
    import queue

    from repro.api.http import __main__ as jax_main
    from repro_torch.api.http import __main__ as port_main
    monkeypatch.setitem(jax_main.ZOO, "gemma3-1b", dataclasses.replace(
        JAX_ZOO["gemma3-1b"], dtype="f32"))
    monkeypatch.setitem(port_main.ZOO, "gemma3-1b", dataclasses.replace(
        ZOO["gemma3-1b"], dtype="f32"))
    monkeypatch.setattr(jax_main, "_params", {})    # no cached bf16 tree
    started, stop = queue.Queue(), threading.Event()

    class Recording(JaxHTTPServer):
        def start(self):
            out = super().start()
            started.put(self)
            return out

    class Time:
        @staticmethod
        def sleep(_):
            stop.wait()
            raise KeyboardInterrupt

    monkeypatch.setattr(jax_main, "GatewayHTTPServer", Recording)
    monkeypatch.setattr(jax_main, "time", Time)
    argv = ["--models", "gemma3-1b", "--port", "0"]
    jcfg = dataclasses.replace(jax_main.ZOO["gemma3-1b"].reduced(),
                               name="gemma3-1b")
    tparams = params_lib.from_jax(
        jax.tree.map(np.asarray, jax_main._param_store(jcfg)),
        dataclasses.replace(ZOO["gemma3-1b"].reduced(dtype="f32"),
                            name="gemma3-1b"), "cpu")
    monkeypatch.setattr(port_main, "seeded_store",
                        lambda dev: (lambda cfg: tparams))
    reqs = _parity_requests("gemma3-1b", jcfg.vocab)
    thread = threading.Thread(target=jax_main.main, args=(argv,))
    thread.start()
    try:
        jsrv = started.get(timeout=300)
        jgot = [_exchange(jsrv.port, "POST", path, body)
                for path, body in reqs]
    finally:
        stop.set()
        thread.join(timeout=60)
    assert not thread.is_alive()
    server, _ = port_main.build_service(argv + ["--device", "cpu",
                                                "--reduced"])
    pgot, _ = _serve_and_collect(server, reqs, [])
    jgot = [(st, _wire_fields(out)) for st, out in jgot]
    assert len(pgot) == len(jgot) == 10
    for (js, jo), (ps, po) in zip(jgot, pgot):
        assert ps == js == 200
        assert po == jo
    assert sum(o["usage"]["completion_tokens"] for _, o in pgot
               if isinstance(o, dict)) == 8 + 12 + 5 + 6 + 7


def test_launcher_refuses_unknown_model(capsys):
    from repro_torch.api.http.__main__ import build_service
    with pytest.raises(SystemExit) as e:
        build_service(["--models", "no-such-model", "--device", "cpu"])
    assert e.value.code == 2
    assert "unknown zoo model" in capsys.readouterr().err


def test_launcher_refuses_to_serve_replicas_without_an_engine(
        monkeypatch, capsys):
    """A replica deployed in accounted mode (no engine) stops the
    launcher before it serves."""
    from repro_torch.api.http import __main__ as launcher
    monkeypatch.setattr(
        launcher, "ControllerConfig",
        lambda real_param_threshold: ControllerConfig(
            real_param_threshold=0))
    with pytest.raises(SystemExit) as e:
        launcher.build_service(["--device", "cpu", "--reduced",
                                "--models", "llama3.2-1b", "--port", "0"])
    assert e.value.code == 1
    assert "no engine on cpu" in capsys.readouterr().err


# -------------------- the examples ---------------------------------- #
@pytest.mark.parametrize("name,argv", [
    ("quickstart", []), ("serve_testbed", ["--requests", "12"]),
    ("wizard_flow", [])])
def test_examples_run_on_cpu(name, argv, capsys):
    import importlib
    mod = importlib.import_module(f"repro_torch.examples.{name}")
    result = mod.main(["--device", "cpu", "--reduced"] + argv)
    out = capsys.readouterr().out
    if name == "serve_testbed":
        assert result == (12, 0)
        assert "availability: 12/12" in out
    elif name == "quickstart":
        assert "8 SSE token deltas" in out
    else:
        assert "(llama3.2-1b on cpu)" in out
