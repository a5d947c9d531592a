"""The yardstick's counts by hand."""
import json
from pathlib import Path

import pytest

from port_bench import flops

HERE = Path(__file__).resolve().parent
CONFIGS = {"olmo-1b": HERE.parent / "configs" / "olmo-1b.json",
           "granite-moe-3b-a800m": HERE / "granite-moe-3b-a800m.json"}


def model(name):
    return json.loads(CONFIGS[name].read_text())["model"]


def test_olmo_layer_and_head():
    m = model("olmo-1b")
    assert flops.layer_matmul_params(m) == 4 * 2048 * 2048 + 3 * 2048 * 8192
    assert flops.head_params(m) == 2048 * 50304


def test_granite_counts_only_routed_experts():
    m = model("granite-moe-3b-a800m")
    attn = 1536 * (24 + 16) * 64 + 24 * 64 * 1536
    assert flops.layer_matmul_params(m) == \
        attn + 1536 * 40 + 8 * 3 * 1536 * 512


def test_olmo_prefill_4x1024_against_2nd():
    m = model("olmo-1b")
    rows = 4 * flops.prefill_flops(m, 1024)
    layers = 16 * (4 * 2048 * 2048 + 3 * 2048 * 8192)
    attn = 4 * 16 * 16 * 128 * (1024 * 1025 // 2)
    assert rows == 4 * (2 * layers * 1024 + 2 * 2048 * 50304 + attn)
    n_params = layers + 2048 * 50304          # tied: the table once
    two_nd = 2 * n_params * 4096
    # the head runs once a row, and attention adds 2.8%
    assert 0.93 < rows / two_nd < 0.97


def test_cached_prefix_and_decode():
    m = model("olmo-1b")
    full = flops.prefill_flops(m, 1100)
    part = flops.prefill_flops(m, 1100, cached=1024)
    per_tok = 2 * 16 * flops.layer_matmul_params(m)
    assert part == pytest.approx(
        76 * per_tok + 2 * flops.head_params(m)
        + flops.attn_flops(m, sum(range(1025, 1101))))
    assert part < full
    assert flops.decode_flops(m, 1) == 2 * (16 * flops.layer_matmul_params(m)
                                            + flops.head_params(m)) \
        + 4 * 16 * 16 * 128


def test_flash_bound():
    # OLMo's 4 x 1024 causal prefill: bytes bound it (PERF.md's 0.0200 ms)
    t = flops.flash_bound_s(4, 16, 16, 1024, 1024, 128, True, 2)
    assert t == pytest.approx(2 * 128 * 4 * 4 * 16 * 1024 / 3.35e12)
    ops = 4.0 * 4 * 16 * 128 * 1024 * 1025 / 2
    assert ops / 989e12 < t


def test_paged_decode_bound():
    m = model("olmo-1b")
    t = flops.paged_decode_bound_s(m, 8, [1024] * 8, 16, 2)
    kv = 2 * 16 * 128 * 2 * 8 * 1024
    qo = 2 * 2 * 8 * 16 * 128
    assert t == pytest.approx((kv + qo + 4 * 8 * 64) / 3.35e12)
    block = flops.decode_block_bound_s(m, 8, [(100, 2), (50, 1)], 4, 16, 2)
    steps = [flops.paged_decode_bound_s(m, 8, v, 16, 2)
             for v in ([100, 50], [101], [], [])]
    assert block == pytest.approx(16 * sum(steps))
