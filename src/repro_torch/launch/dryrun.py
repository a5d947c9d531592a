"""Multi-pod dry run: build and run every (architecture x input-shape x
mesh) cell against the production mesh on meta tensors, prove each
rank's share of the state fits, and extract the roofline terms.  The
counterpart of `repro.launch.dryrun`.

It runs on the CPU, with no card and no second process: the world of
256 (or 512) ranks is torch's fake process group in this one process
(`launch.mesh.start_fake_world`), this process its rank 0, and every
tensor is a meta tensor (shapes, dtypes and layouts; nothing computed,
nothing allocated).  Every rank's block is alike (the resolver shards a
dim only where its mesh axes divide it), so rank 0's counts are every
rank's.

Where JAX lowers (`lower_s`) and compiles (`compile_s`) each cell, the
port builds its step and inputs (`lower_cell`: `build_s`) and runs the
step once on them under the op profile (`roofline.op_profile`:
`trace_s`).  The record keeps JAX's other keys.  `memory` holds the
per-rank `argument_size_in_bytes` (the local blocks of the state or the
params, the cache and the batch), `output_size_in_bytes` (the outputs'
local blocks) and, for a decode cell that donates its cache,
`alias_size_in_bytes` (the cache, written in place).  There is no
`temp_size_in_bytes`, `peak_memory_in_bytes` or
`generated_code_size_in_bytes`: a meta tensor has no allocator to ask,
and no program is generated.  JAX's `--save-hlo` has no counterpart
either: there is no compiled program text to save.

Usage:
    python -m repro_torch.launch.dryrun --arch olmo-1b --shape train_4k
    python -m repro_torch.launch.dryrun --all --mesh both \\
        --out results/dryrun_torch
"""
from __future__ import annotations

import argparse
import json
import time
import traceback
from pathlib import Path

DEFAULT_OUT = "results/dryrun_torch"


def _local_bytes(tensors) -> int:
    from repro_torch.distributed.sharding import is_dtensor
    total = 0
    for t in tensors:
        t = t.to_local() if is_dtensor(t) else t
        total += t.numel() * t.element_size()
    return total


def run_cell(arch: str, shape_name: str, mesh_kind: str,
             strategy_override: str = "", variant: str = "") -> dict:
    """One cell's record: "skipped" with JAX's reason where `runnable`
    says so, else "ok" with the strategy, the chips, build_s / trace_s,
    the per-rank memory and the roofline, or "error" with the
    traceback's tail."""
    from repro_torch.configs import SHAPES, get_config, runnable
    from repro_torch.launch.mesh import (make_production_mesh,
                                         start_fake_world)
    from repro_torch.launch.steps import lower_cell
    from repro_torch.roofline import op_profile
    from repro_torch.roofline.analysis import analyze, model_flops_for
    from repro_torch.training.tree import leaves

    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    ok, reason = runnable(cfg, shape)
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
           "strategy": strategy_override or "auto", "variant": variant}
    if not ok:
        rec.update({"status": "skipped", "reason": reason})
        return rec
    multi = mesh_kind == "multi"
    start_fake_world(512 if multi else 256)
    mesh = make_production_mesh(multi_pod=multi, device="cpu")
    chips = mesh.size()
    try:
        t0 = time.time()
        cell, info = lower_cell(cfg, shape, mesh,
                                strategy_override=strategy_override,
                                variant=variant)
        t1 = time.time()
        with op_profile.profile() as prof:
            out = cell.run()
        t2 = time.time()
        mem = {"argument_size_in_bytes": _local_bytes(cell.inputs()),
               "output_size_in_bytes": _local_bytes(
                   t for o in out for t in leaves(o))}
        if cell.kind == "decode" and cell.donate_cache:
            mem["alias_size_in_bytes"] = _local_bytes(leaves(cell.args[1]))
        roof = analyze(prof, chips,
                       model_flops_global=model_flops_for(cfg, shape))
        rec.update({
            "status": "ok", "strategy": info["strategy"], "chips": chips,
            "build_s": round(t1 - t0, 2), "trace_s": round(t2 - t1, 2),
            "memory": mem,
            "roofline": roof.to_dict(),
            "dominant": roof.dominant,
            "roofline_fraction": roof.roofline_fraction(),
        })
    except Exception as e:               # noqa: BLE001 - the cell's record
        rec.update({"status": "error", "error": f"{type(e).__name__}: {e}",
                    "traceback": traceback.format_exc()[-3000:]})
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="The dry run of every (arch x shape x mesh) cell on "
        "meta tensors under a fake world of 256 / 512 ranks, on the CPU "
        "(no card, no second process).  JAX's --save-hlo has no "
        "counterpart: no compiled program text exists.")
    ap.add_argument("--arch", default="")
    ap.add_argument("--shape", default="")
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--strategy", default="")
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--variant", default="")
    ap.add_argument("--skip-existing", action="store_true")
    args = ap.parse_args(argv)

    from repro_torch.configs import ARCHS, SHAPES
    archs = list(ARCHS) if (args.all or not args.arch) \
        else args.arch.split(",")
    shapes = list(SHAPES) if (args.all or not args.shape) \
        else args.shape.split(",")
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]

    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    n_fail = 0
    for arch in archs:
        for shape in shapes:
            for mesh_kind in meshes:
                tag = f"{arch}__{shape}__{mesh_kind}"
                if args.strategy:
                    tag += f"__{args.strategy}"
                if args.variant:
                    tag += f"__{args.variant}"
                fp = out_dir / f"{tag}.json"
                if args.skip_existing and fp.exists():
                    prev = json.loads(fp.read_text())
                    if prev.get("status") in ("ok", "skipped"):
                        print(f"[skip-existing] {tag}", flush=True)
                        continue
                t0 = time.time()
                rec = run_cell(arch, shape, mesh_kind,
                               strategy_override=args.strategy,
                               variant=args.variant)
                fp.write_text(json.dumps(rec, indent=1))
                dt = time.time() - t0
                if rec["status"] == "ok":
                    r = rec["roofline"]
                    print(f"[ok]   {tag} ({dt:.0f}s) dominant="
                          f"{rec['dominant']} "
                          f"c/m/coll={r['compute_s']:.3f}/"
                          f"{r['memory_s']:.3f}/{r['collective_s']:.3f}s "
                          f"frac={rec['roofline_fraction']:.2f}",
                          flush=True)
                elif rec["status"] == "skipped":
                    print(f"[skip] {tag}: {rec['reason'][:60]}", flush=True)
                else:
                    n_fail += 1
                    print(f"[FAIL] {tag}: {rec['error']}", flush=True)
    print(f"done; {n_fail} failures", flush=True)
    raise SystemExit(1 if n_fail else 0)


if __name__ == "__main__":
    main()
