"""The traffic generator: deterministic for each seed, and every seed
gets the same set of request shapes and gaps in another order."""
import json
from pathlib import Path

import numpy as np
import pytest

from port_bench.traffic import Traffic

MIXES = Path(__file__).resolve().parents[1] / "traffic"
NAMES = sorted(p.stem for p in MIXES.glob("*.json"))


def mix(name):
    return json.loads((MIXES / f"{name}.json").read_text())


def shapes(tr, n):
    return [tr.request(i, i % tr.tenants) for i in range(n)]


@pytest.mark.parametrize("name", NAMES)
def test_same_seed_same_requests(name):
    a, b = Traffic(mix(name), 2 ** 31 + 17, 50280), \
        Traffic(mix(name), 2 ** 31 + 17, 50280)
    for x, y in zip(shapes(a, 40), shapes(b, 40)):
        assert (x.prompt, x.max_tokens, x.tenant) == \
            (y.prompt, y.max_tokens, y.tenant)
    if a.loop == "open":
        assert [a.arrival(i) for i in range(60)] == \
            [b.arrival(i) for i in range(60)]


@pytest.mark.parametrize("name", NAMES)
def test_seeds_share_the_schedule_not_the_tokens(name):
    spec = mix(name)
    a, b = Traffic(spec, 1, 50280), Traffic(spec, 2, 50280)
    n = a.block
    assert [(len(s.prompt), s.max_tokens) for s in shapes(a, n)] == \
        [(len(s.prompt), s.max_tokens) for s in shapes(b, n)]
    if a.loop == "open":
        assert [a.arrival(i) for i in range(n)] == \
            [b.arrival(i) for i in range(n)]
    lo, hi = spec["output"]["lo"], spec["output"]["hi"]
    assert all(lo <= s.max_tokens <= hi for s in shapes(a, n))
    assert shapes(a, 3)[0].prompt != shapes(b, 3)[0].prompt
    # each block holds the quantiles of the distribution, in a new order
    first = [s.max_tokens for s in shapes(a, n)]
    second = [s.max_tokens for s in shapes(a, 2 * n)[n:]]
    assert sorted(first) == sorted(second) and (first != second or n < 4)


def test_open_loop_blocks_hold_the_rate():
    spec = mix("chat-poisson")
    tr = Traffic(spec, 99, 50280)
    per_block = int(spec["rate"] * spec["block_s"])
    ends = [tr.arrival(i) for i in range(0, 4 * per_block + 1, per_block)]
    assert np.allclose(ends, [k * spec["block_s"] for k in range(5)])
    gaps = np.diff([tr.arrival(i) for i in range(per_block)])
    assert gaps.min() >= 0 and gaps.std() > 0.5 * gaps.mean()
