"""The harness on the CPU: a cell, a configuration, a mix and a metric
added as files alone are found and run; the command refuses to run
without a card; a run that loaded the JAX package is refused."""
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path


from port_bench import harness

ROOT = Path(__file__).resolve().parents[2]


def test_cells_of_the_tiny_copy_run_and_are_correct(tiny_bench):
    for cell in ("tiny.closed", "tinymoe.closed", "tiny.open"):
        rec = harness.run_cell(cell, 2 ** 31 + 5, 1.5, False, device="cpu",
                               bench=tiny_bench)
        assert rec["correct"], (cell, rec["numbers"])
        assert rec["attempted"] > 0 and rec["failed"] == 0
        for m in rec["spec"]["end_to_end"]:
            value = harness.load_metric(tiny_bench, m["name"]).read(rec)
            assert value is not None and value > 0, (cell, m["name"])


def test_added_files_alone_make_a_new_cell(tmp_path, tiny_bench):
    root = tmp_path / "copy"
    shutil.copytree(tiny_bench.parent, root)
    bench = root / "port_bench"
    cfg = json.loads((bench / "configs" / "tiny.json").read_text())
    cfg["model"].update(name="tiny3", n_layers=3)
    (bench / "configs" / "tiny3.json").write_text(json.dumps(cfg))
    mix = json.loads((bench / "traffic" / "tiny-closed.json").read_text())
    mix.update(clients=4, output={"dist": "uniform", "lo": 4, "hi": 6})
    (bench / "traffic" / "tiny-short.json").write_text(json.dumps(mix))
    (bench / "metrics" / "requests_sent.py").write_text(
        "def read(rec):\n    return float(rec['sent'])\n")
    (bench / "limits" / "tiny3.short.json").write_text(
        json.dumps({"compared": {"logit_gap_max": 0.05},
                    "min_sampled_tokens": 10}))
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["workloads"].append({"name": "tiny3.short", "config": "tiny3",
                              "traffic": "tiny-short", "chips": 1,
                              "why": "added as files"})
    spec["end_to_end"].append({"name": "requests_sent", "unit": "requests",
                               "better": "higher", "bound": 0.1,
                               "source": "host_clock",
                               "workloads": ["tiny3.short"]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    rec = harness.run_cell("tiny3.short", 3, 1.0, False, device="cpu",
                           bench=bench)
    assert rec["correct"]
    names = [m["name"] for m in rec["spec"]["end_to_end"]]
    assert "requests_sent" in names
    assert harness.load_metric(bench, "requests_sent").read(rec) > 0
    assert harness.load_cell(bench, "tiny.closed")["end_to_end"][-1][
        "name"] == "setup_s"


def _run(cwd, *extra, env=None):
    return subprocess.run(
        [sys.executable, "port_bench/run.py", "--workload",
         "olmo-1b.chat-poisson", "--seed", "1", "--seconds", "1", *extra],
        cwd=cwd, capture_output=True, text=True, timeout=120,
        env={**os.environ, "CUDA_VISIBLE_DEVICES": "", **(env or {})})


def test_no_card_no_result():
    out = _run(ROOT)
    assert out.returncode != 0
    assert "no CUDA device" in out.stderr
    assert out.stdout.strip() == ""


def test_without_the_program_no_result(tmp_path):
    shutil.copytree(ROOT / "port_bench", tmp_path / "port_bench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    out = _run(tmp_path)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_forbidden_modules_are_named(monkeypatch):
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "repro.serving", object())
    assert harness.forbidden_modules() == ["repro"]
    monkeypatch.delitem(sys.modules, "repro.serving")
    monkeypatch.setitem(sys.modules, "jaxlib", object())
    assert harness.forbidden_modules() == ["jaxlib"]


def test_benchmark_json_names_files_that_exist():
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench = ROOT / "port_bench"
    for c in spec["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"] and c["reduced"] == []
    for w in spec["workloads"]:
        assert (bench / "traffic" / f"{w['traffic']}.json").exists()
        assert (bench / "limits" / f"{w['name']}.json").exists()
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert hasattr(harness.load_metric(bench, m["name"]), "read")
