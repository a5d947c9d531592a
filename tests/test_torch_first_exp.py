"""The plain versions that call `torch.exp` are right on the first `exp` of
a process (ROADMAP C9).

Torch's CPU `exp` was once seen ~1e-4 off on the first call of a loaded
process.  Each trial here runs one plain version as the first `exp` of a
fresh process and holds it against a float64 evaluation at 2e-5 (the f32
attention tolerance of the parity tests): `paged_decode_attention_ref`,
the LSE partials and their merge (`split_decode_ref`), and the paged
partials (`split_paged_ref`), 20 trials each.  One fresh interpreter
imports torch and the port (no `exp` runs on import), then forks one
child per trial, six at a time, so the CPU is loaded as in the parallel
test runs where the fault showed; each child's first `exp` is the plain
version's.  The flash reference is not here: it takes `torch.softmax`."""
import os
import subprocess
import sys
from pathlib import Path

SRC = Path(__file__).resolve().parents[1] / "src"
TRIALS, AT_ONCE, TOL = 20, 6, 2e-5

PROBE = r"""
import os, sys
import numpy as np
import torch
from repro_torch.kernels import ops  # noqa: F401  (imports the package)
from repro_torch.kernels.decode_attention import split_decode_ref
from repro_torch.kernels.paged_attention import (paged_decode_attention_ref,
                                                 split_paged_ref)

B, K, G, HD, PS, PPS = 3, 2, 2, 32, 8, 8
S = PS * PPS


def trial(which, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, K, G, HD)).astype(np.float32)
    pos = np.array([S - 1, S // 2 + 3, 5], np.int32)
    kp = rng.standard_normal((B * PPS, PS, K, HD)).astype(np.float32)
    vp = rng.standard_normal((B * PPS, PS, K, HD)).astype(np.float32)
    table = rng.permutation(B * PPS).astype(np.int32).reshape(B, PPS)
    # (B, K, S, hd) views of the pages each row reads
    kk = kp[table].reshape(B, S, K, HD).transpose(0, 2, 1, 3)
    vv = vp[table].reshape(B, S, K, HD).transpose(0, 2, 1, 3)
    t = torch.from_numpy
    if which == "paged_decode_attention_ref":
        got = paged_decode_attention_ref(t(q), t(kp), t(vp), t(table), t(pos))
    elif which == "split_paged_ref":
        got = split_paged_ref(t(q), t(kp), t(vp), t(table), t(pos), ppc=3)
    else:
        got = split_decode_ref(t(q), t(np.ascontiguousarray(kk)),
                               t(np.ascontiguousarray(vv)), t(pos),
                               chunk=16)
    s = np.einsum("bkgd,bksd->bkgs", q.astype(np.float64) * HD ** -0.5,
                  kk.astype(np.float64))
    s = np.where(np.arange(S)[None, None, None, :]
                 <= pos[:, None, None, None], s, -np.inf)
    w = np.exp(s - s.max(-1, keepdims=True))
    w /= w.sum(-1, keepdims=True)
    want = np.einsum("bkgs,bksd->bkgd", w, vv.astype(np.float64))
    return float(np.abs(got.numpy() - want).max())


jobs = [(w, i) for w in ("paged_decode_attention_ref", "split_decode_ref",
                         "split_paged_ref") for i in range(TRIALS)]
while jobs:
    batch, jobs = jobs[:AT_ONCE], jobs[AT_ONCE:]
    kids = []
    for which, seed in batch:
        r, w = os.pipe()
        pid = os.fork()
        if pid == 0:            # a fresh process: its first exp is here
            os.close(r)
            os.write(w, repr(trial(which, seed)).encode())
            os._exit(0)
        os.close(w)
        kids.append((which, seed, pid, r))
    for which, seed, pid, r in kids:
        with os.fdopen(r) as f:
            err = f.read()
        _, status = os.waitpid(pid, 0)
        assert status == 0, (which, seed, status)
        print(which, seed, err)
"""


def test_plain_versions_exact_on_a_first_exp():
    env = dict(os.environ, PYTHONPATH=str(SRC))
    code = f"TRIALS, AT_ONCE = {TRIALS}, {AT_ONCE}\n" + PROBE
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    rows = [line.split() for line in res.stdout.splitlines()]
    assert len(rows) == 3 * TRIALS
    off = [(w, s, float(e)) for w, s, e in rows if float(e) > TOL]
    assert not off, off
