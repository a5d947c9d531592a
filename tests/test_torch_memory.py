"""What placement charges an instance against what the port's engine
allocates (ROADMAP.md C14).  The port's `cluster/node.py::instance_bytes`
charges the weights as the engine holds them (the param tree's exact
bytes, and under int8 the kernel operands beside it: dequantized leaves,
expanded scales, the MoE router in f32), the scratch page each paged
pool keeps at the sentinel's id, Hymba's SSM state in f32, an xLSTM
engine's seven f32 state leaves (in place of the config's state at the
model dtype) and an encoder-decoder's cross K/V; with the engine's page
budget that is every byte `memory_report` counts, for each family the
port serves, in bf16 and int8."""
import pytest
import torch

from repro.cluster.node import instance_bytes as jax_instance_bytes
from repro.configs import ARCHS as JAX_ARCHS
from repro_torch.cluster.node import instance_bytes, weight_bytes
from repro_torch.configs import ARCHS, ZOO
from repro_torch.models import build
from repro_torch.serving import EngineConfig, InferenceEngine

torch.set_num_threads(2)

FAMILIES = {"dense": "olmo-1b", "gelu_window": "gemma3-1b",
            "moe": "granite-moe-3b-a800m", "hymba": "hymba-1.5b",
            "xlstm": "xlstm-125m", "encdec": "seamless-m4t-large-v2"}


def _cfg(family):
    name = FAMILIES[family]
    return (ARCHS[name] if name in ARCHS else ZOO[name]).reduced()


@pytest.mark.parametrize("quantize", ["", "int8"])
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_memory_report_equals_instance_bytes(family, quantize):
    cfg = _cfg(family)
    params = build(cfg, "cpu").init(torch.Generator().manual_seed(0))
    eng = InferenceEngine(cfg, params, EngineConfig(
        n_slots=4, max_len=64, page_size=8, kv_pages=24, quantize=quantize),
        device="cpu")
    mem = eng.memory_report()
    assert sum(mem.values()) == instance_bytes(
        cfg, quantize, 4, 64, 8, eng.pool.n_pages)
    assert (mem["operand_bytes"] > 0) == (quantize == "int8")
    # the weights' term alone is the engine's tree and operands
    assert mem["param_bytes"] + mem["operand_bytes"] == \
        weight_bytes(cfg, quantize)


def test_full_hymba_charge_over_the_reference():
    """The full hymba-1.5b at 8 slots of 1024 on 512 pages of 16: the port
    charges the reference's bytes plus the tree's exact weights over the
    analytic count, one scratch page of KV, and the SSM state's f32 over
    the model dtype: 32 layers x 8 slots x 1600 x 16 x 2 B =
    13,107,200 B."""
    cfg, jcfg = ARCHS["hymba-1.5b"], JAX_ARCHS["hymba-1.5b"]
    gap = instance_bytes(cfg, "", 8, 1024, 16, 512) \
        - jax_instance_bytes(jcfg, "", 8, 1024, 16, 512)
    scratch = 16 * int(cfg.kv_bytes_per_token())
    weights = weight_bytes(cfg, "") - cfg.param_bytes()
    assert gap == weights + scratch + 13_107_200
    assert scratch == 655_360


def test_full_xlstm_charge_is_its_engine_state():
    """The full xlstm-125m at 8 slots: the reference charges the config's
    (6 + 1) x 2 halves at the model dtype, 133,496,832 B; the port
    charges the engine's seven f32 leaves over 6 pairs, 114,131,712 B
    (mC (4, 384, 384) f32 alone is 2,359,296 B a pair and slot), with or
    without a page budget (nothing is paged)."""
    cfg, jcfg = ARCHS["xlstm-125m"], JAX_ARCHS["xlstm-125m"]
    assert jcfg.state_bytes(8) == 133_496_832
    for pages in ((16, 512), (0, 0)):
        assert instance_bytes(cfg, "", 8, 1024, *pages) \
            - weight_bytes(cfg, "") == 114_131_712
        assert jax_instance_bytes(jcfg, "", 8, 1024, *pages) \
            - jcfg.param_bytes() == 133_496_832


def test_full_seamless_charge_counts_the_cross_kv():
    """The full seamless-m4t-large-v2 at 8 slots of 1024 on 512 pages of
    16: the cross K/V the engine keeps slot-resident (24 layers x 8 x 1024
    x 2 x 16 x 64 x 2 B = 805,306,368 B) is the config's own term
    (`cache_bytes`, src = max_len), so the port charges the reference's
    bytes plus the tree's exact weights over the analytic count and one
    scratch page."""
    cfg, jcfg = ARCHS["seamless-m4t-large-v2"], JAX_ARCHS[
        "seamless-m4t-large-v2"]
    cross = 24 * 8 * 1024 * 2 * 16 * 64 * 2
    assert cross == 805_306_368
    assert cfg.cache_bytes(8, 1024) == cross + 8 * 1024 * int(
        cfg.kv_bytes_per_token())
    gap = instance_bytes(cfg, "", 8, 1024, 16, 512) \
        - jax_instance_bytes(jcfg, "", 8, 1024, 16, 512)
    assert gap == weight_bytes(cfg, "") - cfg.param_bytes() \
        + 16 * int(cfg.kv_bytes_per_token())


@pytest.mark.parametrize("name", ["xlstm-125m", "seamless-m4t-large-v2"])
def test_placement_plans_match_reference_but_bytes(name):
    """On the paper's testbed, placement's plans for the full model equal
    the reference's in every field but the bytes, which are the port's
    charge."""
    import dataclasses
    from repro.cluster import fleet as jax_fleet
    from repro.core import placement as jax_place
    from repro_torch.cluster import fleet as port_fleet
    from repro_torch.core import placement as port_place

    def plan(p):
        return ([dataclasses.astuple(dataclasses.replace(a, bytes=0))
                 for a in p.assignments], list(p.unplaced))
    jn = {nid: (n.hbm_free, n.klass.legacy)
          for nid, n in jax_fleet.paper_testbed().nodes.items()}
    pn = {nid: (n.hbm_free, n.klass.legacy)
          for nid, n in port_fleet.paper_testbed().nodes.items()}
    for fill in (True, False):
        jd = [jax_place.ModelDemand(JAX_ARCHS[name], min_replicas=2,
                                    n_slots=8, max_len=1024)]
        pd = [port_place.ModelDemand(ARCHS[name], min_replicas=2,
                                     n_slots=8, max_len=1024)]
        got = port_place.place(pn, pd, fill=fill)
        assert plan(got) == plan(jax_place.place(jn, jd, fill=fill))
        assert got.assignments
        for a in got.assignments:
            assert a.bytes == instance_bytes(ARCHS[name], a.quantize,
                                             a.n_slots, a.max_len,
                                             a.page_size, a.kv_pages)
