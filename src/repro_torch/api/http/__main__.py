"""Serve the paper's models over HTTP:  ``python -m repro_torch.api.http``.

Builds the paper's 6-node heterogeneous testbed, every node's engines on
one device, deploys zoo models through the SDAI controller, and exposes
the Gateway as the OpenAI-compatible wire service until interrupted
(Ctrl-C drains what is in flight, then exits 0).

This file differs from `repro.api.http.__main__` in these places:

- Weights come from `repro_torch.params.seeded_store(device)`: seeded
  on the device, one tree per model, shared by every replica (an engine
  does not copy weights that are already on its device).
- It serves the full-width zoo configs on the card by default.
  ``--device cpu --reduced`` is the reference's only mode: reduced
  configs, renamed to the paper's model ids so that chat templates and
  clients address them as such.
- A config the port cannot run (`params.require_supported`: none of
  the zoo's families, xLSTM and the encoder-decoder among them, is
  refused) exits 2 with the reason, as an unknown name does.
- `ControllerConfig(real_param_threshold=)` lies above the largest
  served model's parameters, so every replica is a real engine (the
  default threshold deploys a full-width model in accounted mode, with
  synthetic tokens); after the deploy it refuses to serve, exit 1, if
  any instance holds no engine on the device.
- Each model gets exactly ``--replicas`` replicas (`max_replicas` too):
  filling the nodes' nominal VRAM would place up to two more of each,
  every one a real engine with its own KV pool on the one card.  At
  full width a replica has `n_slots=8, max_len=1024`; reduced keeps the
  reference's `n_slots=2, max_len=256`.
- `build_service(argv)` returns the server, not yet started, and the
  controller, so tests and scripts drive the launcher's own code.
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
import time
from typing import List, Optional, Tuple

from repro_torch.api import Gateway
from repro_torch.api.http.server import GatewayHTTPServer, HTTPConfig
from repro_torch.cluster import paper_testbed
from repro_torch.configs import ZOO
from repro_torch.core import (ControllerConfig, ModelCatalog, ModelDemand,
                              SDAIController)
from repro_torch.device import resolve_device
from repro_torch.params import require_supported, seeded_store


def _refuse(msg: str, code: int):
    print(msg, file=sys.stderr)
    raise SystemExit(code)


def build_service(argv: Optional[List[str]] = None
                  ) -> Tuple[GatewayHTTPServer, SDAIController]:
    """Parse `argv`, deploy the models and return (server, controller);
    the server is not started.  Exits 2 on a model it cannot serve and 1
    when a deployed replica holds no engine on the device."""
    p = argparse.ArgumentParser(prog="python -m repro_torch.api.http")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--models", default="llama3.2-1b,gemma3-1b",
                   help="comma-separated zoo names")
    p.add_argument("--replicas", type=int, default=2)
    p.add_argument("--device", default="cuda",
                   help="where every engine runs (default: the card)")
    p.add_argument("--reduced", action="store_true",
                   help="serve reduced configs under the paper's ids "
                        "(with --device cpu: the CPU path)")
    args = p.parse_args(argv)

    cfgs = []
    for name in args.models.split(","):
        name = name.strip()
        if name not in ZOO:
            _refuse(f"unknown zoo model {name!r}", 2)
        cfg = ZOO[name]
        if args.reduced:
            cfg = dataclasses.replace(cfg.reduced(), name=name)
        try:
            require_supported(cfg)
        except NotImplementedError as e:
            _refuse(str(e), 2)
        cfgs.append(cfg)

    dev = resolve_device(args.device)
    fleet = paper_testbed(param_store=seeded_store(dev), device=dev)
    catalog = ModelCatalog()
    slots, max_len = (2, 256) if args.reduced else (8, 1024)
    demands = []
    for cfg in cfgs:
        catalog.register(cfg)
        demands.append(ModelDemand(cfg, min_replicas=args.replicas,
                                   max_replicas=args.replicas,
                                   n_slots=slots, max_len=max_len))
    ctrl = SDAIController(fleet, catalog, ControllerConfig(
        real_param_threshold=max(c.num_params() for c in cfgs) + 1))
    ctrl.discover()
    plan = ctrl.deploy(demands)
    if plan.unplaced:
        print(f"warning: unplaced {plan.unplaced}", file=sys.stderr)
    for node in fleet.nodes.values():
        for inst in node.instances.values():
            if inst.engine is None or inst.engine.device.type != dev.type:
                _refuse(f"{node.node_id}: {inst.model_name} has no engine "
                        f"on {dev}; refusing to serve", 1)

    server = GatewayHTTPServer(
        Gateway(ctrl), HTTPConfig(host=args.host, port=args.port))
    return server, ctrl


def main(argv: Optional[List[str]] = None) -> int:
    server, ctrl = build_service(argv)
    server.start()
    print(f"serving {ctrl.replicas.models()} on {server.url()}  "
          f"(Ctrl-C to stop)", flush=True)
    try:
        while True:
            time.sleep(1.0)
    except KeyboardInterrupt:
        pass
    finally:
        print("draining...", flush=True)
        server.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
