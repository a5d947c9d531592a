"""How far the unsharded train step's f32 gradients move under another
order of summation, for the families of `chip_smoke.py`'s `sharded`
phase: the yardstick for that phase's 1e-5 bound on each gradient leaf.

    python3 tools/grad_rounding.py [--rows 4 2]

For each family (`chip_smoke.sharded_families()`: hymba-1.5b and
gemma3-4b at full width, 2 layers, f32) and each batch of `rows` x
`chip_smoke.SHARDED_SEQ` tokens (the phase's seed-3 data, a vision
model's prefix embeddings from seed 4, the seed-5 init): the gradients of
`launch.steps.make_train_step(...).grads` on the card, on the card with
the batch rows reversed (the same sums over the rows in another order),
and on the host's CPU (every product and reduction in another order).
It prints one JSON line a (family, rows): each comparison's largest
leaf difference over that leaf's largest magnitude (the phase's
measure) and its three worst leaves, and the card's name and power
limit.  TF32 is off, as in the phase.  The CPU leg of gemma3-4b at 4
rows takes about a minute on 8 cores.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def rel_errs(got, want):
    """{leaf path: max |got - want| / max |want|}, the worst three."""
    errs = {p: float((got[p].cpu() - w.cpu()).abs().max()
                     / w.abs().max().clamp_min(1e-30).cpu())
            for p, w in want.items()}
    top = sorted(errs.items(), key=lambda kv: -kv[1])[:3]
    return {"max_rel": top[0][1], "worst": top}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", type=int, nargs="+", default=[4, 2])
    args = ap.parse_args()

    import torch

    import chip_smoke as cs
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import build
    from repro_torch.training.data import DataConfig, SyntheticLM
    from repro_torch.training.optimizer import AdamWConfig
    from repro_torch.training.tree import items, unflatten
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = torch.device("cuda", 0)
    cpu = torch.device("cpu")
    line = cs.card_line()
    for name, cfg in cs.sharded_families():
        for rows in args.rows:
            data = SyntheticLM(DataConfig(vocab=cfg.vocab,
                                          seq_len=cs.SHARDED_SEQ,
                                          batch=rows, seed=3))
            batch = {k: torch.from_numpy(v)
                     for k, v in data.batch_at(0).items()}
            if cfg.n_prefix_tokens:
                batch["prefix_embeds"] = torch.randn(
                    rows, cfg.n_prefix_tokens, cfg.d_model,
                    generator=torch.Generator().manual_seed(4))
            params = build(cfg, card).init(
                torch.Generator(card).manual_seed(5))
            grads = {}
            for leg, dev, flip in (("card", card, False),
                                   ("card_rows_reversed", card, True),
                                   ("cpu", cpu, False)):
                step, _ = make_train_step(cfg, opt_cfg=AdamWConfig(),
                                          device=dev)
                b = {k: (v.flip(0) if flip else v).to(dev)
                     for k, v in batch.items()}
                p = params if dev == card else unflatten(
                    params, [v.to(dev) for _, v in items(params)])
                g, _ = step.grads(p, b)
                grads[leg] = {k: v.cpu() for k, v in items(g)}
                del g, p
                torch.cuda.empty_cache()
            print(json.dumps({
                "family": name, "rows": rows, "seq": cs.SHARDED_SEQ,
                "prefix": cfg.n_meta_tokens + cfg.n_prefix_tokens,
                "rows_reversed": rel_errs(grads["card_rows_reversed"],
                                          grads["card"]),
                "cpu": rel_errs(grads["cpu"], grads["card"]),
                "card": line}), flush=True)
            del params, grads
            torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
