"""Client Interface — DEPRECATED back-compat shim over Gateway API v1.

Historically the OpenWebUI analogue: one logical endpoint for every
deployed model.  In-process callers should use `repro.api.Gateway`
(streaming, async handles, admission control, frozen response types);
network callers should use `repro.api.http.HTTPClient` against a
`GatewayHTTPServer`.  `Client` survives one more cycle as a thin adapter
that routes through a `Gateway` but keeps returning the internal mutable
`Request` objects the seed API exposed; constructing one emits a
`DeprecationWarning`.
"""
from __future__ import annotations

import warnings
from typing import List, Optional

from repro_torch.core.controller import SDAIController
from repro_torch.serving.request import Request
from repro_torch.serving.sampler import SamplingParams


class Client:
    def __init__(self, controller: SDAIController):
        warnings.warn(
            "repro.core.Client is deprecated: use repro.api.Gateway "
            "in-process or repro.api.http.HTTPClient over the wire",
            DeprecationWarning, stacklevel=2)
        # imported lazily: repro.api builds on repro.core, and this shim
        # is the one place the dependency points back up
        from repro_torch.api.gateway import Gateway, GatewayConfig
        self.c = controller
        # stream retries swap the handle's internal Request; this shim
        # hands the internal Request to callers, so hidden re-routing
        # would leave them polling a stale object — keep seed semantics
        self.gateway = Gateway(controller,
                               GatewayConfig(max_stream_retries=0))

    def models(self) -> List[str]:
        """Every model currently served (across all nodes)."""
        return self.gateway.models()

    def submit(self, model: str, prompt: List[int],
               sampling: Optional[SamplingParams] = None) -> Request:
        handle = self.gateway.submit(model, prompt, sampling)
        return handle.internal

    def generate(self, model: str, prompt: List[int],
                 sampling: Optional[SamplingParams] = None,
                 max_pump_steps: int = 10_000) -> Request:
        """Submit and drive the fleet until the request completes."""
        handle = self.gateway.submit(model, prompt, sampling)
        steps = 0
        while not handle.done and steps < max_pump_steps:
            self.c.fleet.pump()
            steps += 1
        return handle.internal
