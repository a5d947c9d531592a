"""`correct` comes out false for the control and for the faults the
serving cells can have, at reduced size on the CPU (the card's readings
at the cells' own size are `calibrate.py`'s).  The control is the
program's own int8 path (quantize="int8"), and, for these float32
copies, the same cell in bfloat16; the faults are planted under the
timed path: a token altered where the fused decode produces it, a decode
step that leaves the KV state unchanged, and half of the batch's rows
given the other half's logits.  The cells run on one card, so no
exchange between chips can be left out."""
import json
import shutil

import pytest
import torch

from port_bench import harness

CELLS = ("tiny.closed", "tinymoe.closed", "tiny.open")


def run(bench, cell, **kw):
    return harness.run_cell(cell, 77, 1.5, False, device="cpu", bench=bench,
                            **kw)


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(tiny_bench, cell):
    assert run(tiny_bench, cell)["correct"]


@pytest.mark.parametrize("cell", CELLS)
def test_control_int8_path_fails(tiny_bench, cell):
    rec = run(tiny_bench, cell, overrides={"quantize": "int8"})
    assert not rec["correct"]
    assert rec["numbers"]["logit_gap_max"]["value"] > \
        rec["numbers"]["logit_gap_max"]["limit"]


def test_control_bf16_fails(tmp_path, tiny_bench):
    root = tmp_path / "bf16"
    shutil.copytree(tiny_bench.parent, root)
    path = root / "port_bench" / "configs" / "tiny.json"
    cfg = json.loads(path.read_text())
    cfg["model"]["dtype"] = "bf16"
    path.write_text(json.dumps(cfg))
    assert not run(root / "port_bench", "tiny.closed")["correct"]


def _altered_token(monkeypatch):
    from repro_torch.serving.engine import InferenceEngine
    fused = InferenceEngine._fused_decode

    def altered(self, mode):
        toks, emits, dones = fused(self, mode)
        return (toks + 1) % self.cfg.vocab, emits, dones
    monkeypatch.setattr(InferenceEngine, "_fused_decode", altered)


def _state_unchanged(monkeypatch):
    from repro_torch.models import transformer
    monkeypatch.setattr(transformer, "_paged_write", lambda *a, **k: None)


def _half_batch(monkeypatch):
    from repro_torch.models.model import Model
    decode = Model.decode_paged

    def half(self, *args, **kw):
        logits, cache = decode(self, *args, **kw)
        h = logits.shape[0] // 2
        return torch.cat([logits[:h], logits[:h]]), cache
    monkeypatch.setattr(Model, "decode_paged", half)


@pytest.mark.parametrize("fault", [_altered_token, _state_unchanged,
                                   _half_batch])
@pytest.mark.parametrize("cell", CELLS)
def test_faults_fail(tiny_bench, monkeypatch, fault, cell):
    fault(monkeypatch)
    assert not run(tiny_bench, cell)["correct"]
