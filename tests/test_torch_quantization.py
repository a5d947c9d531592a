"""The port's weight quantization against `repro.serving.quantization`:
the same leaves, made with numpy from a seed, give int8 and packed int4
`q` exactly equal, scales bitwise equal, and bitwise-equal dequantized
weights, for f32 and bf16 leaves; whole trees quantize leaf for leaf as
JAX's do, stacked norm scales included (ROADMAP C5)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.serving import quantization as jq
from repro_torch import params as params_lib
from repro_torch.configs import ARCHS
from repro_torch.serving import quantization as tq

torch.set_num_threads(2)

SHAPES = [(2, 16, 4, 8),     # a stacked (L, d, H, hd) projection
          (64, 16),          # an embedding (V, d)
          (3, 16, 6)]        # an odd leading dim: int4 stays unpacked
_DT = {"f32": (jnp.float32, torch.float32),
       "bf16": (jnp.bfloat16, torch.bfloat16)}


def _leaf(seed, shape, dt):
    a = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    a[..., 0] *= 40.0                  # channels with different absmax
    jx = jnp.asarray(a, _DT[dt][0])
    return jx, params_lib.from_jax({"w": np.asarray(jx)}, _cfg(), "cpu")["w"]


def _cfg():
    return ARCHS["olmo-1b"].reduced(dtype="f32")


def _np(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy()
    return t.numpy()


def _jnp(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("dt", sorted(_DT))
@pytest.mark.parametrize("shape", SHAPES)
def test_quantize_array_matches_jax(shape, dt, bits):
    jx, tx = _leaf(1, shape, dt)
    want = jq.quantize_array(jx, bits)
    got = tq.quantize_array(tx, bits)
    np.testing.assert_array_equal(got["__q__"].numpy(),
                                  np.asarray(want["__q__"]))
    np.testing.assert_array_equal(got["scale"].numpy().view(np.int32),
                                  np.asarray(want["scale"]).view(np.int32))
    assert got["bits"] == (4 if "bits4" in want else 8)
    np.testing.assert_array_equal(_np(tq.dequantize_array(got)),
                                  _jnp(jq.dequantize_array(want)))


@pytest.mark.parametrize("dt", sorted(_DT))
def test_quantize_tree_matches_jax(dt):
    """A tree with a stacked norm scale (L, d), quantized as JAX does, and
    a 1-D leaf left as it is; trees are held leaf for leaf."""
    rng = np.random.default_rng(2)
    tree = {"layers": {"ln1": rng.standard_normal((2, 16)),
                       "attn": {"wq": rng.standard_normal((2, 16, 4, 8))}},
            "final_norm": rng.standard_normal((16,)),
            "embed": rng.standard_normal((64, 16))}
    jtree = jax.tree.map(lambda a: jnp.asarray(a, _DT[dt][0]), tree)
    ttree = params_lib.from_jax(jax.tree.map(np.asarray, jtree), _cfg(),
                                "cpu")
    for bits in (8, 4):
        want = jq.quantize_tree(jtree, bits=bits)
        got = tq.quantize_tree(ttree, bits=bits)
        assert tq.is_quantized_leaf(got["layers"]["ln1"])     # ROADMAP C5
        assert not tq.is_quantized_leaf(got["final_norm"])
        for path in (("layers", "ln1"), ("layers", "attn", "wq"),
                     ("embed",)):
            g, w = got, want
            for p in path:
                g, w = g[p], w[p]
            np.testing.assert_array_equal(g["__q__"].numpy(),
                                          np.asarray(w["__q__"]))
            np.testing.assert_array_equal(g["scale"].numpy(),
                                          np.asarray(w["scale"]))
        jd, td = jq.dequant_tree(want), tq.dequant_tree(got)
        for a, b in zip(jax.tree.leaves(jd), jax.tree.leaves(
                jax.tree.map(_np, td))):
            np.testing.assert_array_equal(_jnp(a), b)


def test_quantized_matmul_ref_and_tree_bytes_match_jax():
    jx, tx = _leaf(3, (5, 16), "f32")
    jw, tw = _leaf(4, (16, 24), "f32")
    jd, td = jq.quantize_array(jw, 8), tq.quantize_array(tw, 8)
    np.testing.assert_allclose(
        tq.quantized_matmul_ref(tx, td["__q__"], td["scale"]).numpy(),
        np.asarray(jq.quantized_matmul_ref(jx, jd["__q__"], jd["scale"])),
        atol=1e-5, rtol=1e-5)
    # JAX's leaf also holds a 0-d dtype marker (4 bytes for f32)
    assert tq.tree_bytes({"w": td}) == jq.tree_bytes({"w": jd}) - 4


@pytest.mark.parametrize("dt", sorted(_DT))
def test_gelu_tree_quantizes_as_jax(dt, param_store):
    """The reduced gemma3-1b's JAX-initialised tree, whose gelu `mlp.wi` is
    one (L, d, f) leaf: int8 and int4 leaf for leaf as JAX's, and the
    int8 kernel operand of `wi` a (d, f) matrix per layer with a (1, f)
    per-column scale."""
    from repro.configs import ZOO as JAX_ZOO
    from repro_torch.configs import ZOO
    jcfg = JAX_ZOO["gemma3-1b"].reduced(dtype=dt)
    cfg = ZOO["gemma3-1b"].reduced(dtype=dt)
    jtree = param_store(jcfg)
    ttree = params_lib.from_jax(jax.tree.map(np.asarray, jtree), cfg, "cpu")
    L, d, f = cfg.n_layers, cfg.d_model, cfg.d_ff
    assert tuple(ttree["layers"]["mlp"]["wi"].shape) == (L, d, f)
    for bits in (8, 4):
        want = jq.quantize_tree(jtree, bits=bits)
        got = tq.quantize_tree(ttree, bits=bits)
        wpaths = dict(jax.tree_util.tree_leaves_with_path(
            want, is_leaf=jq.is_quantized_leaf))
        n = 0
        for path, w in wpaths.items():
            g = got
            for p in path:
                g = g[p.key]
            if jq.is_quantized_leaf(w):
                np.testing.assert_array_equal(g["__q__"].numpy(),
                                              np.asarray(w["__q__"]))
                np.testing.assert_array_equal(g["scale"].numpy(),
                                              np.asarray(w["scale"]))
                n += 1
        assert n >= 8
        jd, td = jq.dequant_tree(want), tq.dequant_tree(got)
        for a, b in zip(jax.tree.leaves(jd), jax.tree.leaves(
                jax.tree.map(_np, td))):
            np.testing.assert_array_equal(_jnp(a), b)
    ops = tq.int8_operands(tq.quantize_tree(ttree, bits=8))
    wi = ops["layers"]["mlp"]["wi"]
    assert tuple(wi["__q__"].shape) == (L, d, f)
    assert tuple(wi["col"].shape) == (1, f)
