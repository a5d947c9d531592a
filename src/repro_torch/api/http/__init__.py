"""Wire protocol v1 — the OpenAI-compatible HTTP service layer.

    from repro_torch.api.http import GatewayHTTPServer, HTTPClient

    server = GatewayHTTPServer(gateway).start()   # runtime-backed, no pumps
    client = HTTPClient(server.url(), tenant="acme")
    client.models()
    client.chat("llama3.2-1b", ["hello"], stream=True)
    server.stop()                                  # drain, park, join

Launch the paper's two-model service:  ``python -m repro_torch.api.http``
Talk to any service:  ``python -m repro_torch.api.http.client``

The modules here are the JAX package's `repro.api.http` with their imports
renamed, but for `__main__`, which builds the port's engines on the card.
"""
from repro_torch.api.http.chat import (ChatMessage, ChatTemplate,
                                       decode_tokens, encode_text,
                                       prefix_budget, register_template,
                                       render_prompt, template_for)
from repro_torch.api.http.schemas import (HTTP_STATUS, ChatCall,
                                          CompletionCall, WireError,
                                          error_body, parse_chat_request,
                                          parse_completion_request,
                                          sse_event, status_for)
from repro_torch.api.http.server import GatewayHTTPServer, HTTPConfig


def __getattr__(name):
    # lazy: `python -m repro_torch.api.http.client` imports this package
    # first, and an eager client import here would trip runpy's
    # double-import warning for that module
    if name in ("HTTPClient", "HTTPClientError"):
        from repro_torch.api.http import client
        return getattr(client, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")

__all__ = ["ChatCall", "ChatMessage", "ChatTemplate", "CompletionCall",
           "GatewayHTTPServer", "HTTPClient", "HTTPClientError",
           "HTTPConfig", "HTTP_STATUS", "WireError", "decode_tokens",
           "encode_text", "error_body", "parse_chat_request",
           "parse_completion_request", "prefix_budget",
           "register_template", "render_prompt", "sse_event",
           "status_for", "template_for"]
