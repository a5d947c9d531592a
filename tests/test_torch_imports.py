"""The port stands alone: importing it (the control plane and the trainer
too) loads no JAX, nothing of the JAX package and no msgpack, and its
entry points, a real deploy of the control plane and the trainer among
them, need a card unless told to use the CPU."""
import os
import subprocess
import sys
from pathlib import Path

SRC = Path(__file__).resolve().parents[1] / "src"

PROBE = """
import sys
import repro_torch, repro_torch.serving, repro_torch.kernels.ops
import repro_torch.serving.quantization
import repro_torch.models, repro_torch.params, repro_torch.configs
import repro_torch.api, repro_torch.cluster, repro_torch.core
import repro_torch.roofline
import repro_torch.api.http, repro_torch.api.http.client
import repro_torch.api.http.__main__, repro_torch.core.wizard
import repro_torch.examples, repro_torch.examples.train_100m
import repro_torch.training.data, repro_torch.training.optimizer
import repro_torch.training.compression, repro_torch.training.checkpoint
import repro_torch.training.train_loop, repro_torch.launch.steps
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib"))
             or m == "repro" or m.startswith("repro.")
             or m == "msgpack" or m.startswith("msgpack."))
assert not bad, bad

import torch
from repro_torch.configs import ARCHS
from repro_torch.models import build
from repro_torch.serving import EngineConfig, InferenceEngine
cfg = ARCHS["olmo-1b"].reduced(dtype="f32")
params = build(cfg, "cpu").init(torch.Generator().manual_seed(0))
eng = InferenceEngine(cfg, params, EngineConfig(), device="cpu")
assert eng.device.type == "cpu"
eng = InferenceEngine(cfg, params, EngineConfig(quantize="int8", paged=False),
                      device="cpu")
assert eng.perf_stats()["paged"] is False
if not torch.cuda.is_available():
    try:
        InferenceEngine(cfg, params, EngineConfig())
    except RuntimeError as e:
        assert "CUDA" in str(e)
    else:
        raise AssertionError("engine ran without CUDA and without 'cpu'")
    # the control plane's real deploy: nodes built with no device mean
    # the card, as every entry point does
    from repro_torch.cluster import paper_testbed
    from repro_torch.core import ModelCatalog, ModelDemand, SDAIController
    cat = ModelCatalog()
    cat.register(cfg)
    ctrl = SDAIController(paper_testbed(param_store=lambda c: params), cat)
    ctrl.discover()
    try:
        ctrl.deploy([ModelDemand(cfg, n_slots=2, max_len=32)])
    except RuntimeError as e:
        assert "CUDA" in str(e)
    else:
        raise AssertionError("a real deploy ran without CUDA and 'cpu'")
# the trainer and the step builders, like every entry point, need a card
# unless told to use the CPU
if not torch.cuda.is_available():
    from repro_torch.training.data import DataConfig
    from repro_torch.training.train_loop import TrainConfig, Trainer
    from repro_torch.launch.steps import make_train_step
    for call in (lambda: make_train_step(cfg),
                 lambda: Trainer(cfg, DataConfig(vocab=cfg.vocab, seq_len=8,
                                                 batch=2), TrainConfig())):
        try:
            call()
        except RuntimeError as e:
            assert "CUDA" in str(e)
        else:
            raise AssertionError("trained without CUDA and without 'cpu'")
print("ok")
"""


def test_port_imports_no_jax_and_needs_cuda():
    env = dict(os.environ, PYTHONPATH=str(SRC))
    res = subprocess.run([sys.executable, "-c", PROBE], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-2000:]
    assert res.stdout.strip().endswith("ok")
