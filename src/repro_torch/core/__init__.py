"""The paper's primary contribution: the Software-Defined AI (SDAI) control
plane — controller, VRAM-aware placement, HAProxy-style frontend, health
monitoring, configuration wizard, unified client."""
from repro_torch.core.client import Client
from repro_torch.core.controller import (AutoscaleConfig, ControllerConfig,
                                         ModelLoad, SDAIController)
from repro_torch.core.events import Event, EventBus
from repro_torch.core.frontend import (FrontendConfig, ServiceFrontend,
                                       TenantLimiter, TenantQuota,
                                       TenantUsage)
from repro_torch.core.health import HealthConfig, HealthMonitor, NodeHealth
from repro_torch.core.placement import (Assignment, ModelDemand,
                                        PlacementPlan, place, place_naive,
                                        plan_utilization, reallocation_plan)
from repro_torch.core.registry import (ModelCatalog, NodeRegistry,
                                       ReplicaInfo, ReplicaKey,
                                       ReplicaRegistry)
from repro_torch.core.wizard import (ConfigWizard, WizardConfig,
                                     WizardModelChoice, WizardSelection)

__all__ = ["SDAIController", "ControllerConfig", "AutoscaleConfig",
           "ModelLoad", "ModelDemand",
           "Assignment", "PlacementPlan", "place", "place_naive",
           "reallocation_plan", "plan_utilization", "ServiceFrontend",
           "FrontendConfig", "TenantLimiter", "TenantQuota", "TenantUsage",
           "HealthMonitor", "HealthConfig", "NodeHealth",
           "ModelCatalog", "NodeRegistry", "ReplicaRegistry", "ReplicaKey",
           "ReplicaInfo", "ConfigWizard", "WizardConfig", "WizardSelection",
           "WizardModelChoice", "Client", "EventBus", "Event"]
