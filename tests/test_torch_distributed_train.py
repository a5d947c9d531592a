"""The port's sharded training beyond the dense step, on a 4-rank gloo
world on the CPU (one spawn; the helpers live in
test_torch_distributed.py): reduced granite-moe under fsdp_tp (the
experts axis, the MoE's seq gather on its collective path), reduced
xlstm under fsdp and fsdp_tp, hymba (also with a vocabulary of 257),
seamless and internvl2 (its prefix embeddings) under fsdp_tp, against
the unsharded step; `remesh_state` from (2, 2)
to (1, 2) and to (4,), bit for bit; the `Trainer` on a mesh: 3 steps,
its checkpoint, a crash and the resume onto the mesh, and the compressed
step."""
import pickle
from pathlib import Path

import numpy as np
import pytest
import torch

from test_torch_distributed import (WORLD, _np_tree, _rel, _steps,
                                    init_rank, spawn_world)


# (config, strategy): the MoE and xLSTM steps, and the other families'
# layers (hymba's hybrid layer, the encoder-decoder's encoder and cross
# attention, the vision prefix) under fsdp_tp, each step under the
# dispatch mode that fails on a functional all-gather, DTensor's own
# included (test_torch_distributed.py).  "hymba-1.5b/vocab257" is hymba
# with a vocabulary "model" does not divide (as its 32001): the logits
# keep the sequence sharded, and the loss takes the tail past the meta
# tokens from it; internvl2's batch carries its prefix embeddings
FAMILIES = [("granite-moe-3b-a800m", "fsdp_tp"), ("xlstm-125m", "fsdp"),
            ("xlstm-125m", "fsdp_tp"), ("hymba-1.5b", "fsdp_tp"),
            ("seamless-m4t-large-v2", "fsdp_tp"),
            ("hymba-1.5b/vocab257", "fsdp_tp"), ("internvl2-76b", "fsdp_tp")]
# a FAMILIES name's config overrides past the reduced config's
VARIANTS = {"hymba-1.5b/vocab257": {"vocab": 257}}


def family_config(name: str):
    from repro_torch.configs import ARCHS
    arch = name.split("/")[0]
    return ARCHS[arch].reduced(dtype="f32", name=name.replace("/", "-")
                               + "-f32", **VARIANTS.get(name, {}))


def train_world(rank, store, out):
    dist = init_rank(rank, store)
    from torch.distributed.tensor import Shard
    from repro_torch.configs import ARCHS
    from repro_torch.distributed import sharding as S
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.steps import (_placement_leaves, gather_tree,
                                          make_train_step, state_shardings)
    from repro_torch.models import build
    from repro_torch.training.checkpoint import save
    from repro_torch.training.data import DataConfig, SyntheticLM
    from repro_torch.training.optimizer import AdamWConfig, adamw_init
    from repro_torch.training.train_loop import (TrainConfig, Trainer,
                                                 remesh_state)
    from repro_torch.training.tree import items, leaves
    rec = {}
    mesh = make_mesh((2, 2), ("data", "model"), "cpu")
    oc = AdamWConfig(lr=1e-3, warmup_steps=1)
    for name, strat in FAMILIES:
        cfg = family_config(name)
        data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=32, batch=4))
        batches = [{k: torch.from_numpy(v) for k, v in
                    data.batch_at(t).items()} for t in range(2)]
        for t, b in enumerate(batches):
            # the encoder's frames and the vision prefix, from a seed
            g = torch.Generator().manual_seed(t)
            if cfg.is_encdec:
                b["src_embeds"] = torch.randn(4, 16, cfg.d_model,
                                              generator=g)
            if cfg.n_prefix_tokens:
                b["prefix_embeds"] = torch.randn(
                    4, cfg.n_prefix_tokens, cfg.d_model, generator=g)
        params = build(cfg, "cpu").init(torch.Generator().manual_seed(0))
        state = {"params": params, "opt": adamw_init(params),
                 "step": torch.zeros((), dtype=torch.int32)}
        un = _steps(cfg, None, None, state, batches, oc)
        sh = _steps(cfg, mesh, S.STRATEGIES[strat](mesh), state, batches,
                    oc, detect=True)
        rec[(name, strat)] = {"unsharded": (un[0], _np_tree(un[1])),
                              "sharded": (sh[0], _np_tree(sh[1]), sh[2])}
    # remesh_state: an fsdp_tp state after one step, to (1, 2) over ranks
    # 0-1 and to (4,) over all, then back to the full tensors
    cfg = ARCHS["olmo-1b"].reduced(dtype="f32")
    step, init = make_train_step(cfg, mesh, S.train_strategy(mesh),
                                 opt_cfg=oc)
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=32, batch=4))
    state, _ = step(init(torch.Generator().manual_seed(0)),
                    {k: torch.from_numpy(v)
                     for k, v in data.batch_at(0).items()})
    full = gather_tree(state)
    sub = make_mesh((1, 2), ("data", "model"), "cpu", ranks=[0, 1])
    line = make_mesh((WORLD,), ("data",), "cpu")
    fsdp_line = S.Strategy(rules={"embed": [("data",)], "mlp": [("data",)],
                                  "vocab": [("data",)],
                                  "batch": [("data",)]},
                           priority=["batch", "mlp", "vocab", "embed"],
                           name="fsdp_data")
    remesh = {}
    for label, m, strat in (("1x2", sub, S.train_strategy(sub)),
                            ("4", line, fsdp_line)):
        moved = remesh_state(state, cfg, m, strat)
        if moved is None:
            remesh[label] = None
            continue
        want = state_shardings(cfg, m, strat)
        layout = [tuple(t.placements) for t in leaves(moved)]
        want_l = _placement_leaves(moved, want)
        back = gather_tree(moved)
        remesh[label] = {
            "bit_for_bit": all(torch.equal(a, b) for a, b in
                               zip(leaves(full), leaves(back))),
            "layout": layout == want_l,
            "sharded": any(isinstance(p, Shard) for pl in layout
                           for p in pl)}
    rec["remesh"] = remesh
    # the Trainer on (2, 2) under fsdp: 3 steps with a checkpoint at 3;
    # a crash at 2 and the resume to 3; the compressed step
    cfg = ARCHS["olmo-1b"].reduced(dtype="f32")
    dc = DataConfig(vocab=cfg.vocab, seq_len=16, batch=4)
    root = Path(out)
    strat = S.train_strategy_fsdp(mesh)

    def trainer(steps, sub_dir, mesh_on=True, compress=False, every=3):
        tc = TrainConfig(steps=steps, ckpt_every=every, log_every=1,
                         ckpt_dir=str(root / sub_dir),
                         compress_grads=compress)
        kw = {"mesh": mesh, "strategy": strat} if mesh_on \
            else {"device": "cpu"}
        return Trainer(cfg, dc, tc, opt_cfg=oc, **kw)
    whole = trainer(3, "whole").run()
    first = trainer(2, "crash", every=2).run()
    resumed = trainer(3, "crash", every=2).run()
    packed = trainer(3, "comp", compress=True).run()
    rec["trainer"] = {
        "history": [h["loss"] for h in whole["history"]],
        "resumed_from": resumed["resumed_from"],
        "first_steps": [h["step"] for h in first["history"]],
        "resume_bitwise": all(torch.equal(a, b) for a, b in zip(
            leaves(gather_tree(whole["state"])),
            leaves(gather_tree(resumed["state"])))),
        "comp_history": [h["loss"] for h in packed["history"]],
        "comp_state": _np_tree(gather_tree(packed["state"])["params"]),
        "state": _np_tree(gather_tree(whole["state"])["params"])}
    gathered = gather_tree(whole["state"])      # a collective: every rank
    if rank == 0:
        plain = trainer(3, "plain", mesh_on=False).run()
        plain_c = trainer(3, "plain_comp", mesh_on=False,
                          compress=True).run()
        save(gathered, root / "gathered.msgpack")
        rec["trainer"]["plain"] = {
            "history": [h["loss"] for h in plain["history"]],
            "state": _np_tree(plain["state"]["params"]),
            "comp_history": [h["loss"] for h in plain_c["history"]],
            "comp_state": _np_tree(plain_c["state"]["params"])}
        rec["trainer"]["files"] = {
            name: (root / name / "ckpt_00000003.msgpack").read_bytes()
            for name in ("whole", "plain")}
        rec["trainer"]["files"]["gathered"] = \
            (root / "gathered.msgpack").read_bytes()
        keys = [k for k, _ in items(whole["state"])]
        rec["trainer"]["keys"] = keys
    Path(out, f"rank{rank}.pkl").write_bytes(pickle.dumps(rec))
    dist.barrier()
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def recs(tmp_path_factory):
    return spawn_world(train_world, tmp_path_factory.mktemp("train_world"))


@pytest.mark.parametrize("name,strategy", FAMILIES)
def test_family_sharded_step_matches_unsharded(recs, name, strategy):
    """Loss and grad norm within 1e-5 relative at steps 0 and 1, every
    param leaf within 1e-5 after them; no functional all-gather."""
    got, got_p, counts = recs[0][(name, strategy)]["sharded"]
    un, un_p = recs[0][(name, strategy)]["unsharded"]
    for t in range(2):
        for j in range(2):
            assert _rel(got[t][j], un[t][j]) <= 1e-5, (t, j)
    for path, leaf in got_p.items():
        assert np.abs(leaf - un_p[path]).max() <= 1e-5, path
    if name.startswith("granite"):
        # the MoE FFN gathers the seq-sharded residual: the gather
        # helper's collective path; the row-parallel down-projections
        # (attention and experts) and the column-parallel q its own
        assert counts["gather"]["collective"] > 0
        assert counts["row"]["collective"] > 0
        assert counts["col"]["collective"] > 0


def test_remesh_state_bit_for_bit(recs):
    """(2, 2) fsdp_tp -> (1, 2) over ranks 0-1 and -> (4,) fsdp over
    "data": every leaf gathered back equals the original bit for bit,
    each rank's layout is the new strategy's (`state_shardings`), and a
    rank outside the new mesh gets None."""
    for r in range(WORLD):
        rm = recs[r]["remesh"]
        assert rm["4"] == {"bit_for_bit": True, "layout": True,
                           "sharded": True}
        if r < 2:
            assert rm["1x2"] == {"bit_for_bit": True, "layout": True,
                                 "sharded": True}
        else:
            assert rm["1x2"] is None


def test_trainer_on_a_mesh(recs):
    """3 steps on (2, 2) under fsdp: losses within 1e-5 relative of the
    unsharded Trainer's, params within 1e-5; the checkpoint is the
    unsharded codec's file of the gathered state byte for byte, with
    the unsharded Trainer's keys and length (its values differ by
    rounding: the sharded sums run in another order); a crash after 2
    steps resumes from the checkpoint onto the mesh and ends bit for bit
    where the whole run did; the compressed step on the mesh as the
    unsharded compressed step (with the int8 ties' allowance)."""
    t = recs[0]["trainer"]
    plain = t["plain"]
    for a, b in zip(t["history"], plain["history"]):
        assert _rel(a, b) <= 1e-5
    for path, leaf in t["state"].items():
        assert np.abs(leaf - plain["state"][path]).max() <= 1e-5, path
    files = t["files"]
    assert files["whole"] == files["gathered"]
    assert len(files["whole"]) == len(files["plain"])
    assert t["first_steps"] == [1, 2] and t["resumed_from"] == 2
    assert all(recs[r]["trainer"]["resume_bitwise"] for r in range(WORLD))
    for a, b in zip(t["comp_history"], plain["comp_history"]):
        assert _rel(a, b) <= 1e-5
    # under compression an element at an int8 rounding tie may round one
    # step apart (the sharded gradients differ in their last bits), which
    # Adam turns into a step of at most lr (tests/test_torch_training.py
    # allows it against JAX): each element within 2 lr, and such flips
    # rare (16 of 131072 here: up to 1e-3 of the elements)
    off = total = 0
    for path, leaf in t["comp_state"].items():
        err = np.abs(leaf - plain["comp_state"][path])
        off, total = off + int((err > 1e-5).sum()), total + err.size
        assert err.max() <= 2 * 1e-3, path
    assert off <= 1e-3 * total, (off, total)
