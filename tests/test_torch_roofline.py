"""The port's roofline (`roofline.op_profile`, `roofline.analysis`,
`roofline.report`) against JAX's, where torch has the concept: the ring
model on collective records against JAX's parser on
tests/test_sharding_roofline.py's HLO_SAMPLE; ops counted once a loop
trip (JAX multiplies while bodies by their trip count); a stacked leaf
read layer by layer charged once (JAX's scanned xs); the kernels'
interior tagged; FLOPs from local blocks (a subprocess on a fake world
of 4 ranks); one reduced OLMo prefill's dot FLOPs worked out by hand;
the report's tables.  tests/test_sharding_roofline.py:76-146 are the
originals."""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro.roofline import analysis as jax_analysis
from repro_torch.configs import ARCHS, ShapeSpec
from repro_torch.distributed.sharding import CollectiveRecord
from repro_torch.kernels import ops
from repro_torch.launch import steps
from repro_torch.models import build
from repro_torch.roofline import analysis, op_profile, report

REPO = Path(__file__).resolve().parents[1]
META = torch.device("meta")

HLO_SAMPLE = """
ENTRY %main (p0: f32[16,1024]) -> f32[16,1024] {
  %p0 = f32[16,1024]{1,0} parameter(0)
  %ag = f32[16,8192]{1,0} all-gather(%p0), channel_id=1, replica_groups=[2,8]<=[16], dimensions={1}
  %ar = f32[16,1024]{1,0} all-reduce(%p0), channel_id=2, replica_groups=[1,16]<=[16], to_apply=%add
  %rs = f32[16,64]{1,0} reduce-scatter(%p0), channel_id=3, replica_groups=[1,16]<=[16], dimensions={1}
  %cp = f32[16,1024]{1,0} collective-permute(%p0), channel_id=4, source_target_pairs={{0,1}}
}
"""


def test_collective_bytes_ring_model_equals_jax():
    """The sample's four collectives as records (kind, the full buffer's
    bytes: the all-gather's output, the reduce-scatter's input, the
    all-reduce's and the permute's tensor; the group's size): the port's
    ring model gives JAX's parser's wire bytes, kind for kind."""
    f = 4
    recs = [CollectiveRecord("all-gather", 16 * 8192 * f, 8),
            CollectiveRecord("all-reduce", 16 * 1024 * f, 16),
            CollectiveRecord("reduce-scatter", 16 * 64 * 16 * f, 16),
            CollectiveRecord("collective-permute", 16 * 1024 * f, 16)]
    got = analysis.collective_bytes(recs, n_devices=16)
    want = jax_analysis.collective_bytes(HLO_SAMPLE, n_devices=16)
    assert set(got) == set(want)
    for kind, b in want.items():
        assert got[kind] == pytest.approx(b), kind


def test_loop_counts_every_trip():
    """A Python loop of 10 matmuls counts 10 of them; loops nested 5 x 3
    count 15 (JAX: a scan's body times its trip count)."""
    x = torch.empty(256, 256, device=META)
    ws = torch.empty(10, 256, 256, device=META)

    def scan10(x, ws):
        for i in range(10):
            x = x @ ws[i]
        return x
    _, prof = op_profile.count(scan10, x, ws)
    assert prof.flops == 10 * 2 * 256 ** 3

    x, ws = torch.empty(128, 128, device=META), torch.empty(
        5, 128, 128, device=META)

    def nested(x, ws):
        for i in range(5):
            for _ in range(3):
                x = x @ ws[i]
        return x
    _, prof = op_profile.count(nested, x, ws)
    assert prof.flops == 15 * 2 * 128 ** 3


def test_stacked_leaf_read_once():
    """A stacked (100, 1024, 1024) leaf read layer by layer: each layer's
    slice is a view (0 bytes), its sum reads it once, so the leaf is
    charged about once, under 6x its bytes."""
    x = torch.empty(8, device=META)
    ws = torch.empty(100, 1024, 1024, device=META)

    def scan_big(x, ws):
        for i in range(100):
            x = x + ws[i].sum()
        return x
    _, prof = op_profile.count(scan_big, x, ws)
    total = 100 * 1024 * 1024 * 4
    assert total <= prof.bytes < 6 * total


def test_kernel_interior_tagged():
    """The flash kernel's plain version (meta tensors): its interior
    (scores, probabilities) is tagged as kernel bytes, above 0 and at
    most the total; its own inputs and output are not."""
    q = torch.empty(1, 4, 64, 32, device=META)
    k = torch.empty(1, 2, 64, 32, device=META)
    _, prof = op_profile.count(ops.flash_attention, q, k, k, causal=False)
    io = (q.numel() + 2 * k.numel() + q.numel()) * 4
    assert 0 < prof.kernel_bytes <= prof.bytes - io


def test_reduced_olmo_prefill_dot_flops_by_hand():
    """One reduced OLMo prefill step on meta tensors: its dot FLOPs are
    the sum of its projections (q, k, v, out: 2 T d (H + 2 K + H) hd),
    its SwiGLU FFN (two halves up, one down: 6 T d f), its attention
    products (QK^T and PV over every pair, as the plain path scores them:
    4 B H S^2 hd) a layer, and the tied head on each row's last token
    (2 B d V)."""
    cfg = ARCHS["olmo-1b"].reduced(dtype="f32")
    b, s = 2, 24
    shape = ShapeSpec("p", "prefill", s, b)
    step = steps.make_prefill_step(cfg, shape, device=META)
    batch = steps.batch_specs(cfg, shape, with_labels=False)
    (logits, cache, _), prof = op_profile.count(
        step, build(cfg, META).param_specs(), batch)
    assert tuple(logits.shape) == (b, cfg.vocab)
    d, h, kv, hd, f = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                       cfg.head_dim, cfg.d_ff)
    t = b * s
    layer = (2 * t * d * (2 * h + 2 * kv) * hd + 6 * t * d * f
             + 4 * b * h * s * s * hd)
    assert prof.flops == cfg.n_layers * layer + 2 * b * d * cfg.vocab
    roof = analysis.analyze(prof, 1, analysis.model_flops_for(cfg, shape))
    assert roof.bound_s() == max(roof.compute_s, roof.memory_adj_s,
                                 roof.collective_adj_s)
    assert roof.compute_s == prof.flops / analysis.PEAK_FLOPS


PROBE = """
import json, sys, torch
from torch.distributed.tensor import Replicate, Shard
from repro_torch.distributed.sharding import distribute, record_collectives
from repro_torch.launch.mesh import make_mesh, start_fake_world
from repro_torch.roofline import op_profile
start_fake_world(4)
mesh = make_mesh((4,), ("model",), "cpu")
meta = torch.device("meta")
x = torch.empty(64, 512, device=meta)
w = torch.empty(512, 256, device=meta)
out = {}
for name, wp in (("sharded", (Shard(1),)), ("replicated", (Replicate(),))):
    xd = distribute(x, mesh, (Replicate(),))
    wd = distribute(w, mesh, wp)
    y, prof = op_profile.count(lambda a, b: a @ b, xd, wd)
    out[name] = prof.flops
# a row-parallel product's partial sums, all-reduced by the port
from repro_torch.distributed.sharding import redistribute
xd = distribute(x, mesh, (Shard(1),))
wd = distribute(w, mesh, (Shard(0),))
_, prof = op_profile.count(lambda a, b: redistribute(a @ b, (Replicate(),)),
                           xd, wd)
out["row"] = [prof.flops, prof.coll_breakdown, len(prof.records)]
json.dump(out, open(sys.argv[1], "w"))
print("OK")
"""


def test_flops_from_local_blocks(tmp_path):
    """On a fake world of 4 ranks: a matmul whose weight is sharded 4
    ways counts a quarter of its FLOPs a rank; a replicated one counts
    them whole on every rank (torch's FlopCounterMode counts the global
    op).  A row-parallel product's partial sums, all-reduced by the port
    (`redistribute` from Partial), count a quarter and one all-reduce of
    the (64, 256) f32 output in the ring model."""
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    r = subprocess.run([sys.executable, "-c", PROBE,
                        str(tmp_path / "o.json")], capture_output=True,
                       text=True, env=env, timeout=120)
    assert r.returncode == 0 and "OK" in r.stdout, r.stderr[-3000:]
    got = json.loads((tmp_path / "o.json").read_text())
    full = 2 * 64 * 512 * 256
    assert got["sharded"] == full / 4
    assert got["replicated"] == full
    flops, coll, n = got["row"]
    assert flops == full / 4 and n == 1
    assert coll == {"all-reduce": 2 * 64 * 256 * 4 * 3 / 4}


def _record(arch, shape, mesh):
    roof = analysis.Roofline(
        flops_per_chip=1e12, bytes_per_chip=2e9, coll_bytes_per_chip=3e8,
        coll_breakdown={"all-gather": 2 ** 30, "all-reduce": 2 ** 29},
        chips=256, kernel_bytes_per_chip=1e9).finish(1e14)
    return {"arch": arch, "shape": shape, "mesh": mesh, "strategy": "serve",
            "variant": "", "status": "ok", "chips": 256, "build_s": 1.0,
            "trace_s": 12.0, "memory": {"argument_size_in_bytes": 2 ** 31,
                                        "output_size_in_bytes": 2 ** 30},
            "roofline": roof.to_dict(), "dominant": roof.dominant,
            "roofline_fraction": roof.roofline_fraction()}


def test_report_tables(tmp_path):
    """`load`, `dryrun_table` and `roofline_table` on two records (an ok
    cell and a skipped one): JAX's columns, one row each."""
    ok = _record("olmo-1b", "decode_32k", "single")
    skip = {"arch": "olmo-1b", "shape": "long_500k", "mesh": "single",
            "strategy": "auto", "variant": "", "status": "skipped",
            "reason": "full-attention arch: 500k context is O(L^2)"}
    for r in (ok, skip):
        (tmp_path / f"{r['arch']}__{r['shape']}__{r['mesh']}.json") \
            .write_text(json.dumps(r))
    recs = report.load(str(tmp_path))
    assert set(recs) == {("olmo-1b", "decode_32k", "single"),
                         ("olmo-1b", "long_500k", "single")}
    dry = report.dryrun_table(recs).splitlines()
    assert len(dry) == 4 and dry[0].count("|") == 9
    assert dry[2] == ("| olmo-1b × decode_32k | single | serve | 12s | 2.00 "
                      "| — | 1.00e+12 | 1.0/0.5/0.0/0.0/0.0 |")
    assert "SKIP" in dry[3]
    roof = report.roofline_table(recs).splitlines()
    assert len(roof) == 4 and roof[0].count("|") == 9
    rf = ok["roofline"]
    assert roof[2].startswith(f"| olmo-1b × decode_32k | {ok['dominant']} "
                              f"| {rf['compute_s']:.4f} ")
    assert "N/A" in roof[3]
