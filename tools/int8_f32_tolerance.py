"""The f32 int8 product that `chip_smoke.py`'s kernel_checks hold to a
fixed atol = rtol = 1e-4 (`int8_matmul/m4096_8192x2048`: M 4096,
8192 -> 2048 on the CUDA-core tile route), on other draws of the same
distribution (ROADMAP C24).

    python3 tools/int8_f32_tolerance.py [--seeds 20 28]

For each seed, drawn on the host (numpy, as kernel_checks draws) and on
the device (`chip_smoke.int8_case(on_device=True)`), it prints one JSON
line: the kernel's largest difference from the f32 plain product and
the entries beyond atol = rtol = 1e-4 of it (kernel_checks' measure),
and, for the kernel and for the plain product (cuBLAS, TF32 off), the
largest error against the f64 product and its ratio to the f32
summation bound (K + 4) u sum |x||w| (`c5_seeds`' measure); then the
card's name and power limit.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", type=int, nargs=2, default=[20, 28])
    args = ap.parse_args()

    import torch

    import chip_smoke as cs
    from repro_torch.kernels import ops
    from repro_torch.kernels.int8_matmul import int8_matmul_ref
    from repro_torch.serving import quantization as q_lib
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    ops.build()
    M, K, N = 4096, 8192, 2048
    for on_device in (False, True):
        for seed in range(*args.seeds):
            x, wq, sc = cs.int8_case(dev, torch.float32, q_lib, M=M, K=K,
                                     N=N, head=False, seed=seed,
                                     on_device=on_device)
            got = cs.on_route(ops.int8_matmul, "cuda_core_tile",
                              lambda: ops.int8_matmul(x, wq, sc))
            plain = int8_matmul_ref(x, wq, sc)
            w64 = wq.double() * sc.double()
            truth = x.double() @ w64
            lim = (K + 4) * 2.0 ** -24 * (x.double().abs() @ w64.abs())
            diff = (got - plain).abs()
            row = {"on_device": on_device, "seed": seed,
                   "kernel_vs_plain": float(diff.max()),
                   "beyond_1e-4": int((diff > 1e-4 + 1e-4 * plain.abs())
                                      .sum())}
            for name, t in (("kernel", got), ("plain", plain)):
                err = (t.double() - truth).abs()
                row[f"{name}_vs_f64"] = float(err.max())
                row[f"{name}_over_bound"] = float((err / lim).max())
            print(json.dumps({**row, "card": cs.card_line()}), flush=True)
            del x, wq, sc, got, plain, w64, truth, lim, diff
            torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
