"""The benchmark's own initialiser: seeded weights made on the device, in
the served dtype, one draw a leaf, in the stacked tree layout that
`repro_torch.serving.InferenceEngine` takes (the JAX package's layout):

    embed (V, d)                        tied head
    layers.attn.wq (L, d, H, hd)  wk, wv (L, d, K, hd)  wo (L, H, hd, d)
    layers.mlp.wi (L, 2, d, f)  wo (L, f, d)            dense SwiGLU
    layers.moe.router (L, d, E) f32  wi (L, E, 2, d, f)  wo (L, E, f, d)
    layers.ln1 / ln2 (L, d), final_norm (d,)            rms norms only

Each dense leaf is normal with std 1/sqrt(fan-in), the embedding normal
with std 0.02; an rms norm's leaf s is normal with std 0.1 and scales by
(1 + s), the port's convention, which `reference.decoder` follows.  The
same tree goes to the program and to the reference.
"""
from __future__ import annotations

from typing import Dict

import torch

DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32}


def generator(device: torch.device, seed: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(int(seed) % 2 ** 63)


def make_params(model: Dict, seed: int, device: torch.device) -> Dict:
    gen = generator(device, seed)
    dt = DTYPES[model["dtype"]]

    def normal(shape, std, dtype=dt):
        t = torch.empty(shape, dtype=dtype, device=device)
        return t.normal_(0.0, std, generator=gen)

    n, d = model["n_layers"], model["d_model"]
    h, kv, hd = model["n_heads"], model["n_kv_heads"], model["head_dim"]
    f, v = model["d_ff"], model["vocab"]
    layers: Dict = {"attn": {"wq": normal((n, d, h, hd), d ** -0.5),
                             "wk": normal((n, d, kv, hd), d ** -0.5),
                             "wv": normal((n, d, kv, hd), d ** -0.5),
                             "wo": normal((n, h, hd, d), (h * hd) ** -0.5)}}
    moe = model.get("moe")
    if moe:
        e = moe["num_experts"]
        layers["moe"] = {"router": normal((n, d, e), d ** -0.5,
                                          torch.float32),
                         "wi": normal((n, e, 2, d, f), d ** -0.5),
                         "wo": normal((n, e, f, d), f ** -0.5)}
    else:
        layers["mlp"] = {"wi": normal((n, 2, d, f), d ** -0.5),
                         "wo": normal((n, f, d), f ** -0.5)}
    params: Dict = {"embed": normal((v, d), 0.02), "layers": layers}
    if model["norm"] == "rms":
        layers["ln1"] = normal((n, d), 0.1)
        layers["ln2"] = normal((n, d), 0.1)
        params["final_norm"] = normal((d,), 0.1)
    return params
