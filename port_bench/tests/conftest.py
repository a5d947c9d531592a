"""A tiny copy of the benchmark for the CPU tests: the harness's folder
and BENCHMARK.json in a temporary directory, with a reduced OLMo
configuration and a reduced MoE one (from granite-3.0-3b-a800m's file
beside the tests), small closed and open mixes and their cells."""
import json
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

# float32, where the port and the reference agree to rounding
TINY = {"n_layers": 2, "d_model": 64, "n_heads": 4, "head_dim": 16,
        "vocab": 256, "dtype": "f32"}
TINY_LIMIT = 1e-3
TINY_ENGINE = {"n_slots": 8, "max_len": 256, "decode_block": 4}
CLOSED = {"loop": "closed", "clients": 12, "tenants": 4,
          "prompt": {"dist": "log_uniform", "lo": 16, "hi": 100},
          "output": {"dist": "uniform", "lo": 8, "hi": 24},
          "ramp_s": 0.5, "trace_s": 0.5}
CELLS = {"tiny.closed": ("tiny", "tiny-closed"),
         "tinymoe.closed": ("tinymoe", "tiny-closed"),
         "tiny.open": ("tiny", "tiny-open")}


def make_bench(root: Path) -> Path:
    """Writes the tiny benchmark under `root`; returns its folder."""
    bench = root / "port_bench"
    shutil.copytree(ROOT / "port_bench", bench,
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    olmo = json.loads((bench / "configs" / "olmo-1b.json").read_text())
    olmo["model"].update(TINY, name="tiny", n_kv_heads=4, d_ff=128)
    granite = json.loads((ROOT / "port_bench" / "tests" /
                          "granite-moe-3b-a800m.json").read_text())
    granite["model"].update(TINY, name="tinymoe", n_kv_heads=2, d_ff=32,
                            moe={"num_experts": 8, "top_k": 2,
                                 "capacity_factor": 1.25})
    for name, cfg in (("tiny", olmo), ("tinymoe", granite)):
        cfg["name"], cfg["token_ids"] = name, 256
        cfg["engine"].update(TINY_ENGINE)
        (bench / "configs" / f"{name}.json").write_text(json.dumps(cfg))
    opened = {"loop": "open", "rate": 20.0, "block_s": 1.0, "tenants": 4,
              "prompt": {"dist": "uniform", "lo": 40, "hi": 120},
              "output": {"dist": "uniform", "lo": 8, "hi": 16},
              "ramp_s": 0.5, "trace_s": 0.5}
    for name, mix in (("tiny-closed", CLOSED), ("tiny-open", opened)):
        (bench / "traffic" / f"{name}.json").write_text(json.dumps(mix))
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    spec["workloads"] = [{"name": c, "config": cfg, "traffic": mix,
                          "chips": 1, "why": "CPU test"}
                         for c, (cfg, mix) in CELLS.items()]
    for m in spec["per_layer"]:
        m.pop("workloads", None)
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    for c in CELLS:
        (bench / "limits" / f"{c}.json").write_text(json.dumps(
            {"compared": {"logit_gap_max": TINY_LIMIT},
             "min_sampled_tokens": 50}))
    return bench


@pytest.fixture(scope="session")
def tiny_bench(tmp_path_factory) -> Path:
    return make_bench(tmp_path_factory.mktemp("bench"))
