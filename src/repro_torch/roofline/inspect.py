"""Hot spots of one dry-run cell: its collectives, products and bytes a
rank, ranked and attributed to the model or kernel function that issued
them.  The counterpart of `repro.roofline.inspect`, which ranks a
compiled HLO module's instructions by their op_name paths; the port has
no compiled module, so it runs the cell once under the op profile with
attribution on (`roofline.op_profile.profile(attribute=True)`) and ranks
its sites, "models/transformer.py:_attend_cache" and the like (the port's
models are functions, not `nn.Module`s: a function is the path).

    PYTHONPATH=src python -m repro_torch.roofline.inspect --arch \\
        mixtral-8x22b --shape train_4k [--mesh single] [--top 15] \\
        [--strategy ...]

It runs on the CPU on a fake world, as the dry run does.
"""
from __future__ import annotations

import argparse


def hot_spots(arch: str, shape_name: str, mesh_kind: str = "single",
              strategy: str = ""):
    """(the cell's strategy name, its OpProfile with `sites`)."""
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.launch.mesh import (make_production_mesh,
                                         start_fake_world)
    from repro_torch.launch.steps import lower_cell
    from repro_torch.roofline import op_profile

    multi = mesh_kind == "multi"
    start_fake_world(512 if multi else 256)
    mesh = make_production_mesh(multi_pod=multi, device="cpu")
    cell, info = lower_cell(get_config(arch), SHAPES[shape_name], mesh,
                            strategy_override=strategy)
    with op_profile.profile(attribute=True) as prof:
        cell.run()
    return info["strategy"], prof


def inspect(arch: str, shape_name: str, mesh_kind: str = "single",
            strategy: str = "", top: int = 15) -> None:
    name, prof = hot_spots(arch, shape_name, mesh_kind, strategy)
    sites = prof.sites
    print(f"=== {arch} x {shape_name} x {mesh_kind} "
          f"(strategy={name}) ===")
    for key, title, unit, scale in (
            ("coll", "collectives by wire bytes/chip", "GiB", 2 ** 30),
            ("flops", "products by flops/chip", "", 1),
            ("bytes", "byte scopes", "GiB", 2 ** 30)):
        total = sum(s[key] for s in sites.values())
        ranked = sorted(((s[key], site) for site, s in sites.items()
                         if s[key]), reverse=True)[:top]
        tot = f"{total / scale:.1f} {unit}" if unit else f"{total:.2e}"
        print(f"\n-- top {title} (total {tot}) --")
        for v, site in ranked:
            val = f"{v / scale:9.2f} {unit}" if unit else f"{v:9.2e}"
            print(f"  {val}  {site}")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--mesh", default="single")
    ap.add_argument("--strategy", default="")
    ap.add_argument("--top", type=int, default=15)
    args = ap.parse_args()
    inspect(args.arch, args.shape, args.mesh, args.strategy, args.top)


if __name__ == "__main__":
    main()
