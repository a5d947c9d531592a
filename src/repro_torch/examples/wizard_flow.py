"""The SDAI Configuration Wizard flow (paper §5): Select -> Configure ->
Generate, printing the agent cards, model-capacity panel, configuration
overview, and the rendered HAProxy-style frontend config; then apply.

    python -m repro_torch.examples.wizard_flow                 # the card
    python -m repro_torch.examples.wizard_flow --device cpu --reduced

Applying the plan starts llama3.2-1b's replicas as real engines on the
device (full width on the card); the other models are deployed in
accounted mode (exact bytes, synthetic tokens), as the JAX package's
flow deploys all of them.
"""
import argparse
import json

from repro_torch.cluster import paper_testbed
from repro_torch.configs import ZOO
from repro_torch.core import (ConfigWizard, ControllerConfig, ModelCatalog,
                              SDAIController, WizardConfig,
                              WizardModelChoice, WizardSelection)
from repro_torch.device import resolve_device
from repro_torch.examples import device_args, engines_on, zoo_cfg
from repro_torch.params import seeded_store

LIVE = "llama3.2-1b"


def main(argv=None):
    args = device_args(argparse.ArgumentParser()).parse_args(argv)
    dev = resolve_device(args.device)
    store = seeded_store(dev, names=[LIVE])
    fleet = paper_testbed(param_store=store, device=dev)
    catalog = ModelCatalog()
    live = zoo_cfg(LIVE, args.reduced)
    catalog.register(live)
    for name in ("deepseek-r1-7b", "qwen3-8b", "gemma3-1b",
                 "nomic-embed-text", "mxbai-embed-large"):
        catalog.register(ZOO[name])
    ctrl = SDAIController(fleet, catalog, ControllerConfig(
        real_param_threshold=live.num_params() + 1))
    ctrl.discover()
    wiz = ConfigWizard(ctrl)

    print("=" * 64)
    print("STAGE 1 - SELECT AGENTS")
    for card in wiz.list_agents():
        print(f"  [{card['status']:8s}] {card['node_id']:6s} "
              f"{card['class']:16s} {card['toolkit']:7s} "
              f"({card['year']}) free={card['hbm_free_gb']:.1f} GB")

    print("\n  model capacity on node6 (RX 6800):")
    cap = wiz.model_capacity("deepseek-r1-7b", "node6")
    for q, b in cap["bytes_per_instance"].items():
        print(f"    deepseek-r1-7b {q or 'bf16':5s}: {b/2**30:.2f} GiB")
    print(f"    -> precision={cap['precision'] or 'bf16'}, "
          f"max_instances={cap['max_instances']}")

    print("\n" + "=" * 64)
    print("STAGE 2 - CONFIGURE (models, replicas, ports)")
    wcfg = WizardConfig(
        selection=WizardSelection(agents=[a["node_id"]
                                          for a in wiz.list_agents()]),
        models=[
            WizardModelChoice("deepseek-r1-7b", replicas=2),
            WizardModelChoice("qwen3-8b", replicas=1),
            WizardModelChoice(LIVE, replicas=3),
            WizardModelChoice("nomic-embed-text", replicas=2,
                              port=11500),
        ])
    gen = wiz.generate(wcfg)

    print("\n" + "=" * 64)
    print("STAGE 3 - GENERATE: configuration overview")
    ov = gen["overview"]
    print(json.dumps({k: v for k, v in ov.items()
                      if k != "frontend_config"}, indent=2))
    print("\n--- generated frontend config " + "-" * 30)
    print(ov["frontend_config"])

    keys = wiz.apply(gen)
    engines_on(fleet, dev, [LIVE])
    print(f"\napplied: {len(keys)} instances running ({LIVE} on {dev}); "
          f"fleet util {ctrl.fleet_utilization():.1%}")
    return gen


if __name__ == "__main__":
    main()
