"""Quickstart: AIvailable in ~80 lines, on Gateway API v1 + wire v1.

Build the paper's heterogeneous 6-node testbed, deploy two models through
the SDAI controller (VRAM-aware placement + HAProxy-style frontend), and
talk to everything through ONE unified gateway: sync `generate`, async
`submit` + token streaming, the typed admin snapshot — then the same
fleet over the network, via the OpenAI-compatible HTTP service and its
stdlib client (the old `repro_torch.core.Client` shim is deprecated).

    python -m repro_torch.examples.quickstart                 # the card
    python -m repro_torch.examples.quickstart --device cpu --reduced

The JAX package's quickstart serves reduced llama3.2-1b and gemma3-1b;
this one serves the same two at full width on the card, every replica a
real engine.
"""
import argparse

from repro_torch.api import Gateway
from repro_torch.api.http import GatewayHTTPServer, HTTPClient, HTTPConfig
from repro_torch.cluster import paper_testbed
from repro_torch.core import (ControllerConfig, ModelCatalog, ModelDemand,
                              SDAIController)
from repro_torch.device import resolve_device
from repro_torch.examples import device_args, engines_on, zoo_cfg
from repro_torch.params import seeded_store
from repro_torch.serving import SamplingParams


def main(argv=None):
    args = device_args(argparse.ArgumentParser()).parse_args(argv)
    # backend nodes pull weights from this store (the Ollama analogue)
    dev = resolve_device(args.device)
    store = seeded_store(dev)
    fleet = paper_testbed(param_store=store, device=dev)
    catalog = ModelCatalog()
    llama = zoo_cfg("llama3.2-1b", args.reduced)
    gemma = zoo_cfg("gemma3-1b", args.reduced)
    catalog.register(llama)
    catalog.register(gemma)

    # every replica a real engine: the threshold lies above both models
    ctrl = SDAIController(fleet, catalog, ControllerConfig(
        real_param_threshold=max(llama.num_params(),
                                 gemma.num_params()) + 1))
    print("discovered nodes:", ctrl.discover())

    # max_len fits a chat-templated prompt (the llama3 header format
    # alone costs ~120 byte-tokens) plus decode budget
    plan = ctrl.deploy([
        ModelDemand(llama, min_replicas=2, n_slots=2, max_len=192),
        ModelDemand(gemma, min_replicas=2, n_slots=2, max_len=192),
    ])
    engines_on(fleet, dev, [llama.name, gemma.name])
    print(f"deployed {len(plan.assignments)} instances on {dev}, "
          f"fleet VRAM utilization {ctrl.fleet_utilization():.1%}")

    gw = Gateway(ctrl)
    print("models behind the unified endpoint:", gw.models())

    # sync: one blocking call -> frozen GenerationResponse
    resp = gw.generate("llama3.2-1b", prompt=[1, 2, 3, 4],
                       sampling=SamplingParams(max_tokens=8))
    print(f"  sync   {resp.model:14s} -> {list(resp.tokens)}  "
          f"(via {resp.node}, ttft={resp.ttft*1e3:.0f}ms, "
          f"finish={resp.finish_reason})")

    # async + streaming: tokens arrive as engine decode steps produce them
    handle = gw.submit("gemma3-1b", prompt=[5, 6, 7],
                       sampling=SamplingParams(max_tokens=8))
    toks = []
    for ev in handle.stream():
        if ev.type.value == "token":
            toks.append(ev.token)           # incremental delta
    print(f"  stream {handle.response.model:14s} -> {toks}  "
          f"(via {handle.response.node})")

    snap = gw.admin.snapshot()
    print(f"admin snapshot: {snap.connected}/{snap.total} agents, "
          f"routing={ {m: len(r) for m, r in snap.routing.items()} }")

    # the same fleet over the wire: OpenAI-compatible HTTP + SSE
    server = GatewayHTTPServer(gw, HTTPConfig(port=0)).start()
    client = HTTPClient(server.url(), tenant="quickstart")
    print(f"HTTP service on {server.url()}: models={client.models()}")
    out = client.chat("llama3.2-1b", ["hello fleet"], max_tokens=8)
    choice = out["choices"][0]
    print(f"  chat   {out['model']:14s} -> {choice['token_ids']}  "
          f"(finish={choice['finish_reason']}, "
          f"via {out['metadata']['node']})")
    deltas = sum(1 for c in client.chat("gemma3-1b", ["stream please"],
                                        max_tokens=8, stream=True)
                 if c["choices"][0].get("delta", {}).get("token")
                 is not None)
    print(f"  stream gemma3-1b      -> {deltas} SSE token deltas")
    client.close()
    server.stop()


if __name__ == "__main__":
    main()
