"""Configuration Wizard — Select -> Configure -> Generate (paper §5.1-5.3).

Stage 1 (Select): choose agents + enable GPU instances per agent.
Stage 2 (Configure): per-model network ports, replica counts, LB policy.
Stage 3 (Generate): the consolidated Configuration Overview — system stats,
model distribution, agent distribution — plus the rendered frontend config
(our HAProxy-config analogue) the controller pushes to nodes.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

from repro_torch.core.controller import SDAIController
from repro_torch.core.placement import ModelDemand, PlacementPlan, place


@dataclasses.dataclass
class WizardSelection:
    agents: List[str]
    # agent -> enabled (True) / disabled; missing => enabled
    gpu_enabled: Dict[str, bool] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class WizardModelChoice:
    model_name: str
    replicas: int = 1
    n_slots: int = 4
    max_len: int = 2048
    allow_quant: bool = True
    port: Optional[int] = None      # auto-assigned when None


@dataclasses.dataclass
class WizardConfig:
    selection: WizardSelection
    models: List[WizardModelChoice]
    stats_port: int = 8404
    base_port: int = 11434          # ollama-style default


class ConfigWizard:
    def __init__(self, controller: SDAIController):
        self.c = controller

    # Stage 1 ------------------------------------------------------ #
    def list_agents(self) -> List[Dict]:
        """Agent cards: status, last-seen, vendor/class, VRAM."""
        out = []
        for nid in self.c.nodes.ids():
            node = self.c.fleet.nodes.get(nid)
            if node is None:
                continue
            out.append({
                "node_id": nid,
                "class": node.klass.name,
                "toolkit": node.klass.toolkit,
                "year": node.klass.year,
                "hbm_total_gb": node.klass.hbm_total / 2**30,
                "hbm_free_gb": node.hbm_free / 2**30,
                "status": self.c.monitor.status(nid).value,
                "last_seen": self.c.monitor.last_seen.get(nid),
            })
        return out

    # Stage 1b: model capacity panel ------------------------------- #
    def model_capacity(self, model_name: str, node_id: str,
                       n_slots: int = 4, max_len: int = 2048) -> Dict:
        """VRAM per instance / free VRAM / max instances (paper Fig. 6)."""
        from repro_torch.cluster.node import instance_bytes
        cfg = self.c.catalog.get(model_name)
        node = self.c.fleet.nodes[node_id]
        per = {q: instance_bytes(cfg, q, n_slots, max_len)
               for q in ["", "int8", "int4"]}
        fit_prec = next((q for q in ["", "int8", "int4"]
                         if per[q] <= node.hbm_free), None)
        return {
            "model": model_name,
            "bytes_per_instance": per,
            "node_free": node.hbm_free,
            "max_instances": (node.hbm_free // per[fit_prec]
                              if fit_prec is not None else 0),
            "precision": fit_prec,
        }

    # Stage 2+3 ----------------------------------------------------- #
    def generate(self, wcfg: WizardConfig) -> Dict:
        """Dry-run placement over the selected agents and render the
        Configuration Overview + frontend config.  Nothing is deployed
        until `apply()`."""
        enabled = [a for a in wcfg.selection.agents
                   if wcfg.selection.gpu_enabled.get(a, True)]
        cap = {nid: v for nid, v in self.c._free_capacity().items()
               if nid in enabled}
        demands = [ModelDemand(self.c.catalog.get(mc.model_name),
                               min_replicas=mc.replicas,
                               n_slots=mc.n_slots, max_len=mc.max_len,
                               allow_quant=mc.allow_quant)
                   for mc in wcfg.models]
        plan = place(cap, demands, fill=self.c.cfg.fill_vram)
        # port assignment (paper Fig. 7)
        ports = {}
        next_port = wcfg.base_port
        for mc in wcfg.models:
            if mc.port is not None:
                ports[mc.model_name] = mc.port
            else:
                ports[mc.model_name] = next_port
                next_port += 1
        by_model: Dict[str, int] = {}
        by_agent: Dict[str, int] = {}
        for a in plan.assignments:
            by_model[a.model_name] = by_model.get(a.model_name, 0) + 1
            by_agent[a.node_id] = by_agent.get(a.node_id, 0) + 1
        overview = {
            "system_stats": {
                "agents": len(enabled),
                "instances": len(plan.assignments),
                "distinct_models": len(by_model),
                "stats_port": wcfg.stats_port,
            },
            "model_distribution": by_model,
            "agent_distribution": by_agent,
            "ports": ports,
            "unplaced": plan.unplaced,
            "frontend_config": self.render_frontend_config(plan, ports,
                                                           wcfg.stats_port),
        }
        return {"plan": plan, "overview": overview}

    def render_frontend_config(self, plan: PlacementPlan,
                               ports: Dict[str, int],
                               stats_port: int) -> str:
        """HAProxy-style config text (one frontend+backend per model)."""
        lines = ["global", "  maxconn 4096", "defaults",
                 "  timeout connect 5s", "  timeout server 300s",
                 "listen stats", f"  bind *:{stats_port}",
                 "  stats enable"]
        for model, port in sorted(ports.items()):
            lines += [f"frontend ft_{model}", f"  bind *:{port}",
                      f"  default_backend bk_{model}",
                      f"backend bk_{model}", "  balance leastconn"]
            for i, a in enumerate(plan.replicas(model)):
                lines.append(
                    f"  server {model}_{i} {a.node_id}:auto check "
                    f"weight 100{' # ' + a.quantize if a.quantize else ''}")
        return "\n".join(lines)

    def apply(self, generated: Dict) -> List:
        """Execute the generated plan (Stage 3 'finalize')."""
        plan: PlacementPlan = generated["plan"]
        keys = self.c._execute(plan)
        self.c.bus.emit("wizard_applied",
                        instances=len(plan.assignments))
        return keys
