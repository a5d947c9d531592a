"""The dry run's tables from its records (`launch.dryrun`'s JSON files),
the counterpart of `repro.roofline.report`, with its columns:

    PYTHONPATH=src python -m repro_torch.roofline.report [results/dryrun_torch]

prints the dry-run and roofline markdown tables.  The port's record has
`trace_s` where JAX's has `compile_s` (the "trace" column) and no
temporaries (`temp/dev` reads "—": `launch.dryrun` says why).
"""
from __future__ import annotations

import glob
import json
import sys
from pathlib import Path

ARCH_ORDER = ["internvl2-76b", "phi4-mini-3.8b", "deepseek-7b",
              "starcoder2-3b", "olmo-1b", "granite-moe-3b-a800m",
              "mixtral-8x22b", "seamless-m4t-large-v2", "xlstm-125m",
              "hymba-1.5b"]
SHAPE_ORDER = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]
COLL_KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
              "collective-permute")


def load(results_dir: str):
    recs = {}
    for f in glob.glob(str(Path(results_dir) / "*.json")):
        r = json.loads(Path(f).read_text())
        if "arch" in r:
            recs[(r["arch"], r["shape"], r["mesh"])] = r
    return recs


def gb(x):
    return f"{x/2**30:.2f}"


def dryrun_table(recs) -> str:
    lines = [
        "| arch × shape | mesh | strategy | trace | args/dev | temp/dev"
        " | FLOPs/chip | coll GB/chip (ag/ar/rs/a2a/cp) |",
        "|---|---|---|---|---|---|---|---|",
    ]
    for a in ARCH_ORDER:
        for s in SHAPE_ORDER:
            for m in ("single", "multi"):
                r = recs.get((a, s, m))
                if r is None:
                    continue
                if r["status"] == "skipped":
                    if m == "single":
                        lines.append(
                            f"| {a} × {s} | — | — | SKIP | — | — | — | "
                            f"{r['reason'][:48]} |")
                    continue
                if r["status"] != "ok":
                    lines.append(f"| {a} × {s} | {m} | — | **ERROR** | — "
                                 f"| — | — | {r.get('error', '')[:40]} |")
                    continue
                rf = r["roofline"]
                mem = r.get("memory", {})
                cb = rf["coll_breakdown"]
                coll = "/".join(f"{cb.get(k, 0)/2**30:.1f}"
                                for k in COLL_KINDS)
                temp = mem.get("temp_size_in_bytes")
                lines.append(
                    f"| {a} × {s} | {m} | {r['strategy']} "
                    f"| {r['trace_s']:.0f}s "
                    f"| {gb(mem.get('argument_size_in_bytes', 0))} "
                    f"| {'—' if temp is None else gb(temp)} "
                    f"| {rf['flops_per_chip']:.2e} | {coll} |")
    return "\n".join(lines)


def roofline_table(recs, mesh: str = "single") -> str:
    lines = [
        "| arch × shape | dominant | compute s | memory s (raw→adj) | "
        "collective s (raw→adj) | bound s | frac | MODEL/counted |",
        "|---|---|---|---|---|---|---|---|",
    ]
    for a in ARCH_ORDER:
        for s in SHAPE_ORDER:
            r = recs.get((a, s, mesh))
            if r is None:
                continue
            if r["status"] == "skipped":
                lines.append(f"| {a} × {s} | — | — | — | — | — | — | "
                             f"N/A (sub-quadratic rule) |")
                continue
            if r["status"] != "ok":
                lines.append(f"| {a} × {s} | ERROR | | | | | | |")
                continue
            rf = r["roofline"]
            bound = max(rf["compute_s"], rf["memory_adj_s"],
                        rf["collective_adj_s"])
            lines.append(
                f"| {a} × {s} | {r['dominant']} "
                f"| {rf['compute_s']:.4f} "
                f"| {rf['memory_s']:.3f}→{rf['memory_adj_s']:.3f} "
                f"| {rf['collective_s']:.3f}→"
                f"{rf['collective_adj_s']:.3f} "
                f"| {bound:.4f} | {r['roofline_fraction']:.2f} "
                f"| {rf['useful_ratio']:.2f} |")
    return "\n".join(lines)


def main():
    d = sys.argv[1] if len(sys.argv) > 1 else "results/dryrun_torch"
    recs = load(d)
    print("## Dry-run table\n")
    print(dryrun_table(recs))
    print("\n## Roofline table (single-pod)\n")
    print(roofline_table(recs, "single"))
    print("\n## Roofline table (multi-pod)\n")
    print(roofline_table(recs, "multi"))


if __name__ == "__main__":
    main()
