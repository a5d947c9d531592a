"""What placement charges an instance against what the port's engine
allocates (ROADMAP.md C14).  The port's `cluster/node.py::instance_bytes`
charges the weights as the engine holds them (the param tree's exact
bytes, and under int8 the kernel operands beside it: dequantized leaves,
expanded scales, the MoE router in f32), the scratch page each paged
pool keeps at the sentinel's id, and Hymba's SSM state in f32; with the
engine's page budget that is every byte `memory_report` counts, for each
family the port serves, in bf16 and int8."""
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
            "moe": "granite-moe-3b-a800m", "hymba": "hymba-1.5b"}


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
