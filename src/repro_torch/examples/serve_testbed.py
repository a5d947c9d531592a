"""End-to-end serving run (the paper's kind of workload): the 6-node
heterogeneous testbed serves a batched request stream across the full zoo
while nodes fail and recover mid-flight.

Demonstrates every architectural claim at once:
  * unified client interface (one endpoint, many models/nodes),
  * VRAM-aware placement with int8/int4 fallback on legacy nodes,
  * health-checked least-connection load balancing,
  * replica failover + controller-driven reallocation on node death,
  * elastic re-fill when a node recovers.

    python -m repro_torch.examples.serve_testbed [--requests 60]
    python -m repro_torch.examples.serve_testbed --device cpu --reduced

Two models are live, real engines on the device (llama3.2-1b and
gemma3-1b, full width on the card); the rest of the paper's Table-1 zoo
is deployed in accounted mode (exact bytes, analytic latency, synthetic
tokens), as in the JAX package's example, whose live pair is the same
two, reduced.
"""
import argparse
import random

from repro_torch.api import Gateway
from repro_torch.cluster import paper_testbed
from repro_torch.configs import ZOO
from repro_torch.core import (ControllerConfig, ModelCatalog, ModelDemand,
                              SDAIController)
from repro_torch.device import resolve_device
from repro_torch.examples import device_args, engines_on, zoo_cfg
from repro_torch.params import seeded_store
from repro_torch.serving import SamplingParams

LIVE = ("llama3.2-1b", "gemma3-1b")


def main(argv=None):
    ap = device_args(argparse.ArgumentParser())
    ap.add_argument("--requests", type=int, default=60)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    rng = random.Random(args.seed)

    dev = resolve_device(args.device)
    store = seeded_store(dev, names=LIVE)
    fleet = paper_testbed(param_store=store, device=dev)
    catalog = ModelCatalog()
    # two live models + the big accounted zoo from paper Table 1
    live = {name: zoo_cfg(name, args.reduced) for name in LIVE}
    for cfg in live.values():
        catalog.register(cfg)
    for name in ("deepseek-r1-7b", "qwen3-8b", "deepseek-r1-1.5b",
                 "nomic-embed-text"):
        catalog.register(ZOO[name])

    ctrl = SDAIController(fleet, catalog, ControllerConfig(
        real_param_threshold=max(c.num_params() for c in live.values())
        + 1))
    ctrl.discover()
    plan = ctrl.deploy(
        [ModelDemand(c, min_replicas=2, n_slots=2, max_len=48)
         for c in live.values()] +
        [ModelDemand(ZOO["deepseek-r1-7b"], min_replicas=2),
         ModelDemand(ZOO["qwen3-8b"], min_replicas=1),
         ModelDemand(ZOO["deepseek-r1-1.5b"], min_replicas=2),
         ModelDemand(ZOO["nomic-embed-text"], min_replicas=2)])
    engines_on(fleet, dev, LIVE)
    print(f"placed {len(plan.assignments)} instances "
          f"(util {ctrl.fleet_utilization():.1%}); quantized: "
          f"{sum(1 for a in plan.assignments if a.quantize)}; live "
          f"engines on {dev}: {LIVE}")

    gw = Gateway(ctrl)
    models = gw.models()
    ok = fail = 0
    failed_at = recovered_at = None
    victim = None
    for i in range(args.requests):
        # failure injection at 1/3, recovery at 2/3 of the workload
        if i == args.requests // 3:
            victim = rng.choice([n for n in fleet.nodes
                                 if fleet.nodes[n].alive])
            fleet.fail_node(victim)
            ctrl.tick()
            failed_at = i
            routing = {m: len(r) for m, r in
                       ctrl.frontend.routing_table().items()}
            print(f"[{i}] !! node {victim} DIED -> controller "
                  f"reallocated; routing now {routing}")
        if i == 2 * args.requests // 3 and victim:
            fleet.recover_node(victim)
            ctrl.tick()
            recovered_at = i
            print(f"[{i}] node {victim} RECOVERED -> re-filled")
        model = rng.choice(models)
        resp = gw.generate(model, [rng.randrange(64) for _ in range(4)],
                           SamplingParams(max_tokens=4))
        if resp.ok:
            ok += 1
        else:
            fail += 1
    print(f"\navailability: {ok}/{ok+fail} = {ok/(ok+fail):.1%} "
          f"(node died at req {failed_at}, recovered at {recovered_at})")
    print("frontend stats:", ctrl.frontend.stats)
    ev = [e.kind for e in ctrl.bus.events]
    print("controller events:", {k: ev.count(k) for k in sorted(set(ev))})
    return ok, fail


if __name__ == "__main__":
    main()
