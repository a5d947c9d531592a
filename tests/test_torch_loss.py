"""The port's training loss and its gradients against the JAX package, on
the CPU: `Model.loss` under `torch.autograd.grad` against
`jax.value_and_grad(model.loss)` for every family (the counterpart of
tests/test_models.py's smoke gradient test), remat against no remat, the
chunked attention past 2048 keys, the MoE aux loss through `forward`,
and the flash kernel's refusal of a tensor that requires grad.

Configs: each arch's `reduced(dtype="f32")`; JAX's initialised params
carried across with `from_jax`; batches from a numpy seed (labels with
masked -100 entries, random vision prefix and encoder frames).

Tolerances: the loss within 1e-5 relative; each gradient leaf within
1e-4 of its largest magnitude.  One leaf is held to its gate's scale
instead: xLSTM's input-gate bias `b_i`, whose gradient is 0 in exact
arithmetic but for the exp(-m) floor (the mLSTM's stabiliser m absorbs a
shift of a head's every input gate), so that what is left is rounding:
JAX's own jit and eager gradients of it differ by 1e-3 of its largest
magnitude.  It is held to 1e-4 of the largest gradient of the same
gate's weight `w_i` (whose gradient is the same per-token gate gradient
times the input, without the cancellation).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JAX_ARCHS
from repro.models import attention as jax_attn
from repro.models import build as jax_build
from repro_torch import params as params_lib
from repro_torch.configs import ARCHS
from repro_torch.kernels import ops
from repro_torch.models import attention as attn_lib
from repro_torch.models import build
from repro_torch.training.tree import items, leaves, unflatten

torch.set_num_threads(2)

LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4
CPU = torch.device("cpu")
ALL = sorted(ARCHS)


def _batch(cfg, b=2, s=24, seed=0):
    """tokens / labels (labels -100 on the first row's first 3), a vision
    model's prefix_embeds and an encoder-decoder's src_embeds (20
    frames), numpy."""
    rng = np.random.default_rng(seed)
    n_text = s - (cfg.n_prefix_tokens if cfg.frontend == "vision" else 0)
    out = {"tokens": rng.integers(0, cfg.vocab, (b, n_text)).astype(np.int32),
           "labels": rng.integers(0, cfg.vocab, (b, n_text)).astype(np.int32)}
    out["labels"][0, :3] = -100
    if cfg.frontend == "vision":
        out["prefix_embeds"] = 0.5 * rng.standard_normal(
            (b, cfg.n_prefix_tokens, cfg.d_model)).astype(np.float32)
    if cfg.is_encdec:
        out["src_embeds"] = 0.5 * rng.standard_normal(
            (b, 20, cfg.d_model)).astype(np.float32)
    return out


def _jax_grads(jcfg, jparams, batch, remat=False):
    model = jax_build(jcfg)
    fn = jax.jit(jax.value_and_grad(
        lambda p, b: model.loss(p, b, remat=remat), has_aux=True))
    (loss, mets), grads = fn(jparams, {k: jnp.asarray(v)
                                       for k, v in batch.items()})
    return float(loss), {k: float(v) for k, v in mets.items()}, grads


def _port_grads(pcfg, tparams, batch, remat=False):
    flat = [t.detach().requires_grad_() for t in leaves(tparams)]
    total, mets = build(pcfg, CPU).loss(
        unflatten(tparams, flat),
        {k: torch.from_numpy(v) for k, v in batch.items()}, remat=remat)
    grads = torch.autograd.grad(total, flat)
    return total.detach(), {k: float(v.detach()) for k, v in mets.items()}, \
        grads


@pytest.fixture(scope="module", params=ALL)
def arch(request):
    """(name, jax cfg, port cfg, JAX params, port params, batch)."""
    name = request.param
    jcfg = JAX_ARCHS[name].reduced(dtype="f32")
    pcfg = ARCHS[name].reduced(dtype="f32")
    jparams = jax.jit(jax_build(jcfg).init)(jax.random.PRNGKey(0))
    tparams = params_lib.from_jax(jax.tree.map(np.asarray, jparams), pcfg,
                                  "cpu")
    return name, jcfg, pcfg, jparams, tparams, _batch(pcfg)


def _hold_grads(name, tparams, got, want):
    want = [np.asarray(g) for g in jax.tree.leaves(want)]
    paths = [p for p, _ in items(tparams)]
    assert len(got) == len(want) == len(paths)
    scale = {p: float(np.abs(w).max()) for p, w in zip(paths, want)}
    for path, g, w in zip(paths, got, want):
        assert tuple(g.shape) == w.shape, path
        ref = scale[path]
        if path == "pairs/mlstm/b_i":          # see the module docstring
            ref = scale["pairs/mlstm/w_i"]
        assert ref > 0, f"{name} {path}: zero gradient"
        err = float(np.abs(g.numpy() - w).max())
        assert err <= GRAD_TOL * ref, (name, path, err, ref)


def test_loss_and_grads_match_jax(arch):
    name, jcfg, pcfg, jparams, tparams, batch = arch
    want_loss, want_mets, want_g = _jax_grads(jcfg, jparams, batch)
    got_loss, got_mets, got_g = _port_grads(pcfg, tparams, batch)
    assert abs(float(got_loss) - want_loss) <= LOSS_RTOL * abs(want_loss)
    assert got_mets["tokens"] == want_mets["tokens"] \
        == batch["labels"].size - 3
    assert abs(got_mets["aux"] - want_mets["aux"]) <= \
        LOSS_RTOL * max(1.0, abs(want_mets["aux"]))
    if pcfg.moe is not None:
        assert got_mets["aux"] > 0
    _hold_grads(name, tparams, got_g, want_g)


def test_remat_is_bit_identical(arch):
    """Checkpointed layers recompute the same values: the loss and every
    gradient equal without remat, bit for bit."""
    _, _, pcfg, _, tparams, batch = arch
    l0, m0, g0 = _port_grads(pcfg, tparams, batch, remat=False)
    l1, m1, g1 = _port_grads(pcfg, tparams, batch, remat=True)
    assert torch.equal(l0, l1) and m0 == m1
    for a, b in zip(g0, g1):
        assert torch.equal(a, b)


def test_forward_returns_moe_aux_as_jax():
    """`Model.forward` returns (logits, aux), aux summed over the layers
    as JAX's forward (granite, 4 MoE layers); prefill's outputs are
    unchanged by it (test_torch_moe holds them against JAX)."""
    jcfg = JAX_ARCHS["granite-moe-3b-a800m"].reduced(dtype="f32")
    pcfg = ARCHS["granite-moe-3b-a800m"].reduced(dtype="f32")
    jparams = jax.jit(jax_build(jcfg).init)(jax.random.PRNGKey(1))
    tparams = params_lib.from_jax(jax.tree.map(np.asarray, jparams), pcfg,
                                  "cpu")
    toks = _batch(pcfg, s=20, seed=4)["tokens"]
    want_logits, _, want_aux = jax_build(jcfg).forward(jparams,
                                                       jnp.asarray(toks))
    logits, aux = build(pcfg, CPU).forward(tparams, torch.from_numpy(toks))
    np.testing.assert_allclose(logits.numpy(), np.asarray(want_logits),
                               rtol=0, atol=2e-5)
    assert abs(float(aux) - float(want_aux)) <= 1e-5 * float(want_aux)


@pytest.mark.parametrize("case", [
    dict(s=3072, causal=True, window=0, prefix=0),
    dict(s=2100, causal=True, window=700, prefix=5),
    dict(s=2048 + 1024, causal=False, window=0, prefix=0),
])
def test_chunked_attention_matches_jax(case):
    """Past 2048 keys training's attention is the chunked online softmax
    (blocks of 1024, one block when S % 1024 != 0), as JAX's; it equals
    the full attention too."""
    rng = np.random.default_rng(case["s"])
    q = rng.standard_normal((1, case["s"], 4, 16)).astype(np.float32)
    k, v = (rng.standard_normal((1, case["s"], 2, 16)).astype(np.float32)
            for _ in range(2))
    kw = {n: case[n] for n in ("causal", "window", "prefix")}
    want = jax_attn.attention(*(jnp.asarray(x) for x in (q, k, v)), **kw)
    got = attn_lib.attention(*(torch.from_numpy(x) for x in (q, k, v)), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)
    full = attn_lib.full_attention(*(torch.from_numpy(x) for x in (q, k, v)),
                                   **kw)
    np.testing.assert_allclose(got.numpy(), full.numpy(), rtol=0, atol=1e-5)


def test_long_sequence_loss_and_grads_match_jax():
    """A narrow OLMo at S = 3072 (past the 2048 threshold): the chunked
    attention's loss and gradients against JAX's."""
    over = dict(dtype="f32", n_layers=2, d_model=32, n_heads=2,
                n_kv_heads=2, head_dim=16, d_ff=32, vocab=64)
    jcfg = JAX_ARCHS["olmo-1b"].reduced(**over)
    pcfg = ARCHS["olmo-1b"].reduced(**over)
    jparams = jax.jit(jax_build(jcfg).init)(jax.random.PRNGKey(2))
    tparams = params_lib.from_jax(jax.tree.map(np.asarray, jparams), pcfg,
                                  "cpu")
    batch = _batch(pcfg, b=1, s=3072, seed=9)
    want_loss, _, want_g = _jax_grads(jcfg, jparams, batch)
    got_loss, _, got_g = _port_grads(pcfg, tparams, batch)
    assert abs(float(got_loss) - want_loss) <= LOSS_RTOL * abs(want_loss)
    _hold_grads("olmo-3072", tparams, got_g, want_g)


def test_flash_refuses_tensors_that_require_grad():
    """The flash kernel has no backward: a differentiable input raises on
    every device, never silently detached; under no_grad it runs."""
    q = torch.randn(1, 2, 8, 16, requires_grad=True)
    k = torch.randn(1, 2, 8, 16)
    with pytest.raises(RuntimeError, match="no backward"):
        ops.flash_attention(q, k, k)
    with torch.no_grad():
        assert ops.flash_attention(q, k, k).shape == (1, 2, 8, 16)


def test_training_forward_never_launches_a_kernel(monkeypatch):
    """The training forward (impl="auto") attends in plain PyTorch: the
    loss reaches no kernel wrapper on any device (on the card the flash
    kernel would refuse the params' gradients)."""
    cfg = ARCHS["olmo-1b"].reduced(dtype="f32")
    model = build(cfg, CPU)
    calls = []
    for name in ("flash_attention", "decode_attention"):
        monkeypatch.setattr(ops, name,
                            lambda *a, name=name, **k: calls.append(name))
    b = _batch(cfg)
    model.loss(model.init(torch.Generator().manual_seed(0)),
               {k: torch.from_numpy(v) for k, v in b.items()})
    assert calls == []


@pytest.mark.parametrize("name", ["hymba-1.5b", "internvl2-76b"])
def test_unsharded_loss_slices_the_logits_bit_for_bit(name):
    """With no mesh `loss_fn` slices the forward's logits past the meta
    (hymba) or prefix (internvl2) positions, as it did before the sharded
    loss took its tail on the local blocks: the loss, its metrics and
    every gradient equal, bit for bit, the forward's logits sliced
    through `nll_loss` plus 0.01 aux."""
    from repro_torch.models import transformer as tf
    cfg = ARCHS[name].reduced(dtype="f32")
    params = build(cfg, CPU).init(torch.Generator().manual_seed(0))
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg).items()}
    n = batch["labels"].shape[1]

    def before(p):
        logits, aux = tf.forward(p, cfg, batch["tokens"], impl="auto",
                                 prefix_embeds=batch.get("prefix_embeds"),
                                 return_aux=True)
        assert logits.shape[1] > n
        loss, denom = tf.nll_loss(logits[:, -n:], batch["labels"])
        return loss + 0.01 * aux, {"loss": loss, "aux": aux,
                                   "tokens": denom}

    got, want = [], []
    for fn, out in ((lambda p: tf.loss_fn(p, cfg, batch), got),
                    (before, want)):
        flat = [t.detach().requires_grad_() for t in leaves(params)]
        total, mets = fn(unflatten(params, flat))
        out.append((total.detach(), {k: v.detach() for k, v in mets.items()},
                    torch.autograd.grad(total, flat)))
    (l0, m0, g0), (l1, m1, g1) = got[0], want[0]
    assert torch.equal(l0, l1)
    assert all(torch.equal(m0[k], m1[k]) for k in m1)
    assert all(torch.equal(a, b) for a, b in zip(g0, g1, strict=True))
