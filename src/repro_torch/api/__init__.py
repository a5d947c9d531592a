"""Gateway API v1 — the system's single public surface.

    from repro_torch.api import Gateway
    gw = Gateway(controller)
    gw.start()                                            # background pumps
    resp = gw.generate("olmo-1b", [1, 2, 3])              # sync
    handle = gw.submit("olmo-1b", [1, 2, 3],
                       tenant="acme")                     # async, tenanted
    for ev in handle.stream(): ...                        # streaming
    gw.admin.set_tenant_quota("acme", requests_per_s=5)   # rate limits
    snap = gw.admin.snapshot()                            # typed admin
    gw.stop()                                             # drain + join

(The reference's HTTP surface, `repro.api.http`, is not ported yet.)
"""
from repro_torch.api.admin import (AdminAPI, DeployResult, FleetSnapshot,
                                   InstanceSnapshot, ModelSnapshot,
                                   NodeSnapshot, TenantSnapshot)
from repro_torch.api.gateway import (Gateway, GatewayConfig, GatewayStats,
                                     GenerationHandle)
from repro_torch.api.runtime import (RuntimeConfig, RuntimeStats,
                                     ServingRuntime)
from repro_torch.api.types import (API_VERSION, APIError, ErrorCode,
                                   GatewayError, GenerationRequest,
                                   GenerationResponse, StreamEvent,
                                   StreamEventType, response_from_internal)
from repro_torch.core.frontend import TenantQuota

__all__ = ["API_VERSION", "APIError", "AdminAPI", "DeployResult",
           "ErrorCode", "FleetSnapshot", "Gateway", "GatewayConfig",
           "GatewayError", "GatewayStats", "GenerationHandle",
           "GenerationRequest", "GenerationResponse", "InstanceSnapshot",
           "ModelSnapshot", "NodeSnapshot", "RuntimeConfig",
           "RuntimeStats", "ServingRuntime", "StreamEvent",
           "StreamEventType", "TenantQuota", "TenantSnapshot",
           "response_from_internal"]
