"""The plain reference agrees with the port at reduced size (float32 on
the CPU, where the port runs its kernels' plain versions), capacity
drops included, and imports nothing of the program."""
import ast
import json
from pathlib import Path

import pytest
import torch

from port_bench.harness import arch_config
from port_bench.reference import decoder
from port_bench.weights import make_params

BENCH = Path(__file__).resolve().parents[1]
# granite-3.0-3b-a800m's file, kept beside the tests (no cell runs it)
# for the reference's MoE layer
CONFIGS = {"olmo-1b": BENCH / "configs" / "olmo-1b.json",
           "granite-moe-3b-a800m":
           BENCH / "tests" / "granite-moe-3b-a800m.json"}


def tiny(name, **moe):
    cfg = json.loads(CONFIGS[name].read_text())
    m = cfg["model"]
    m.update(n_layers=2, d_model=64, n_heads=4, head_dim=16, vocab=256,
             dtype="f32", n_kv_heads=4 if not m.get("moe") else 2,
             d_ff=128 if not m.get("moe") else 32)
    if m.get("moe"):
        m["moe"] = {"num_experts": 8, "top_k": 2, **moe}
    cfg["engine"].update(max_len=256)
    return cfg


@pytest.mark.parametrize("name,moe", [
    ("olmo-1b", {}),
    ("granite-moe-3b-a800m", {"capacity_factor": 1.25}),
    ("granite-moe-3b-a800m", {"capacity_factor": 0.3}),    # drops pairs
])
def test_reference_matches_port_prefill_and_decode(name, moe):
    from repro_torch.models import transformer
    cfg = tiny(name, **moe)
    model, arch = cfg["model"], arch_config(cfg["model"])
    params = make_params(model, 11, torch.device("cpu"))
    g = torch.Generator().manual_seed(3)
    prompt_len, n_new = 37, 6
    toks = torch.randint(0, 256, (1, prompt_len + n_new), generator=g)
    bucket = decoder.bucket_of(prompt_len, cfg["engine"])
    padded = torch.zeros((1, bucket), dtype=torch.long)
    padded[0, :prompt_len] = toks[0, :prompt_len]
    with torch.no_grad():
        ref = decoder.served_logits(params, model, cfg["engine"],
                                    toks[0].tolist(), prompt_len)
        last, cache, pos = transformer.prefill(
            params, arch, padded, lengths=torch.tensor([prompt_len]),
            cache_len=cfg["engine"]["max_len"])
        got = [last[0]]
        for j in range(n_new):
            p = torch.tensor([prompt_len + j], dtype=torch.int32)
            logits, cache = transformer.decode_step(
                params, arch, cache, toks[:, prompt_len + j].to(torch.int32),
                p)
            got.append(logits[0])
    got = torch.stack(got)
    assert ref.shape == got.shape
    torch.testing.assert_close(ref, got, rtol=1e-4, atol=1e-4)


def test_capacity_rule_drops_in_the_reference():
    cfg = tiny("granite-moe-3b-a800m", capacity_factor=0.3)
    model = cfg["model"]
    params = make_params(model, 11, torch.device("cpu"))
    toks = torch.randint(0, 256, (60,), generator=torch.Generator()
                         .manual_seed(4)).tolist()
    with torch.no_grad():
        dropped = decoder.served_logits(params, model, cfg["engine"], toks,
                                        50)
        model["moe"]["capacity_factor"] = 100.0
        kept = decoder.served_logits(params, model, cfg["engine"], toks, 50)
    assert (dropped - kept).abs().max() > 1e-3


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module \
                and node.level == 0:
            yield node.module


def test_no_jax_and_no_jax_package_anywhere():
    for path in BENCH.rglob("*.py"):
        tops = {m.split(".")[0] for m in _imports(path)}
        assert not tops & {"jax", "jaxlib", "flax", "repro"}, path
        assert not any(m.startswith("benchmarks") for m in tops), path


def test_reference_imports_nothing_of_the_program():
    for path in (BENCH / "reference").rglob("*.py"):
        tops = {m.split(".")[0] for m in _imports(path)}
        assert tops <= {"__future__", "typing", "torch"}, (path, tops)
