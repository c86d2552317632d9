"""The port's MoE (``repro_torch.models.moe``) against the JAX package, on
the CPU, on the ``moonshot_v1_16b_a3b`` smoke config (2 layers, 8 experts,
top 2, one shared expert, capacity factor 8), JAX weights carried across:

* ``router_topk`` (gates, the chosen experts, the Switch aux loss);
* ``moe_capacity`` at the smoke capacity factor and at one small enough
  that tokens are dropped; over the two halves of the experts (``e0``,
  ``n_local``), whose partial outputs add up to the whole; ``moe_ref``;
  ``moe_block`` dropless against ``moe_ref``: 2e-5;
* logits within 2e-5 (the whole sequence, dense and paged decode) and the
  engine's greedy tokens against the JAX engine's;
* three train steps within 1e-5, the aux loss among the metrics; the
  router's gradient at ``router_aux_weight`` 0.5 differs from its gradient
  at 0, and both equal the reference's (the aux term reaches it).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (ATOL, close, decode_errors, jax_engine_tokens,
                           jax_weights, prompts, to_torch, train_steps_match,
                           whole_sequence_error)
from repro import configs as jax_configs
from repro.data import batch_at as jax_batch_at
from repro.models import init_params as jax_init_params
from repro.models import moe as jmoe
from repro.models.transformer import init_caches as jax_init_caches
from repro.train.step import _loss_fn as jax_loss_fn
from repro_torch import configs
from repro_torch.models import cache_shapes
from repro_torch.models import moe as tmoe
from repro_torch.serve import ServeEngine
from repro_torch.train.step import _loss_fn
from repro_torch.tree import leaves, unflatten_as

ARCH = "moonshot_v1_16b_a3b"
T = 48   # tokens of the MoE-level tests


@pytest.fixture(scope="module")
def model():
    return jax_weights(ARCH)


@pytest.fixture(scope="module")
def ffn():
    """One MoE FFN's JAX params (its own spec, seed 3), carried across, and
    tokens (T, d) from numpy."""
    jcfg, cfg = jax_configs.smoke_config(ARCH), configs.smoke_config(ARCH)
    jp = jax_init_params(jmoe.moe_spec(jcfg), jax.random.PRNGKey(3),
                         jnp.float32)
    x = np.random.RandomState(4).standard_normal(
        (T, cfg.d_model)).astype(np.float32)
    return jcfg, jp, cfg, to_torch(jp), x


def _with_factor(cfg, factor):
    """Either package's config with another capacity factor."""
    return cfg.with_(moe=dataclasses.replace(cfg.moe,
                                             capacity_factor=factor))


def test_router_topk(ffn):
    jcfg, jp, cfg, tp, x = ffn
    jg, ji, ja = jmoe.router_topk(jp, jcfg, jnp.asarray(x))
    tg, ti, ta = tmoe.router_topk(tp, cfg, torch.from_numpy(x))
    # the chosen experts first: a tie broken another way would show here
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    close(tg, jg)
    close(ta, ja, atol=1e-6)


def _drops(idx, capacity, n_experts):
    """Choices past their expert's capacity, counted the reference's way
    (token order, then choice order)."""
    seen = np.zeros(n_experts, np.int64)
    dropped = 0
    for j in range(idx.shape[1]):
        for e in idx[:, j]:
            dropped += seen[e] >= capacity
            seen[e] += 1
    return int(dropped)


@pytest.mark.parametrize("factor", [8.0, 0.5])
def test_moe_capacity(ffn, factor):
    """Factor 8 (the smoke config's) drops nothing; 0.5 drops tokens."""
    jcfg, jp, cfg, tp, x = ffn
    jcfg, cfg = _with_factor(jcfg, factor), _with_factor(cfg, factor)
    want, wa = jmoe.moe_capacity(jp, jcfg, jnp.asarray(x))
    got, ga = tmoe.moe_capacity(tp, cfg, torch.from_numpy(x))
    close(got, want)
    close(ga, wa, atol=1e-6)
    e = cfg.moe
    capacity = max(1, -(-int(e.top_k * T * factor) // e.n_experts))
    _, idx, _ = tmoe.router_topk(tp, cfg, torch.from_numpy(x))
    dropped = _drops(idx.numpy(), capacity, e.n_experts)
    assert (dropped > 0) == (factor < 1), dropped


@pytest.mark.parametrize("factor", [8.0, 0.5])
def test_moe_capacity_per_shard(ffn, factor):
    """Experts [0, 4) and [4, 8) alone: each half equals the reference's
    partial output, and the halves add up to the whole."""
    jcfg, jp, cfg, tp, x = ffn
    jcfg, cfg = _with_factor(jcfg, factor), _with_factor(cfg, factor)
    half = cfg.moe.n_experts // 2
    whole, _ = tmoe.moe_capacity(tp, cfg, torch.from_numpy(x))
    parts = []
    for e0 in (0, half):
        want, _ = jmoe.moe_capacity(jp, jcfg, jnp.asarray(x), e0=e0,
                                    n_local=half)
        got, _ = tmoe.moe_capacity(tp, cfg, torch.from_numpy(x), e0=e0,
                                   n_local=half)
        close(got, want)
        parts.append(got)
    close(parts[0] + parts[1], whole.numpy(), atol=1e-5)


def test_moe_ref(ffn):
    jcfg, jp, cfg, tp, x = ffn
    want, wa = jmoe.moe_ref(jp, jcfg, jnp.asarray(x))
    got, ga = tmoe.moe_ref(tp, cfg, torch.from_numpy(x))
    close(got, want)
    close(ga, wa, atol=1e-6)


@pytest.mark.parametrize("factor", [8.0, 0.5])
def test_moe_block_dropless_matches_ref(ffn, factor):
    """Dropless (capacity = tokens) whatever the factor: equal to the dense
    reference, the shared expert added to both; and to JAX's block."""
    jcfg, jp, cfg, tp, x = ffn
    jcfg, cfg = _with_factor(jcfg, factor), _with_factor(cfg, factor)
    xb = x.reshape(4, T // 4, -1)
    got, _ = tmoe.moe_block(tp, cfg, torch.from_numpy(xb), dropless=True)
    ref, _ = tmoe.moe_block(tp, cfg, torch.from_numpy(xb), impl="ref")
    want, _ = jmoe.moe_block(jp, jcfg, jnp.asarray(xb), dropless=True)
    close(got, ref.numpy())
    close(got, want)


def test_cache_layouts_match_reference(model):
    jcfg, _, cfg, _ = model
    want = jax.tree.map(lambda a: a.shape,
                        jax_init_caches(jcfg, 3, 48, jnp.float32))
    got = jax.tree.map(lambda a: tuple(a.shape),
                       cache_shapes(cfg, 3, 48, torch.float32))
    assert got == want


def test_whole_sequence_logits(model):
    tokens = np.random.RandomState(0).randint(0, 512, (2, 96))
    err, _ = whole_sequence_error(model, tokens)
    assert err <= ATOL


@pytest.mark.parametrize("paged", [False, True])
def test_decode_logits(model, paged):
    """Per-slot decode (the MoE dropless), chunked and flash."""
    errs = decode_errors(model, paged=paged, kernels=("chunked", "flash"),
                         steps=24, start=(0, 3), max_len=32)
    assert max(errs.values()) <= ATOL, errs


REQS = [(f"m{i}", p, 5) for i, p in enumerate(prompts(11, [4, 7, 5, 9]))]


@pytest.fixture(scope="module")
def engine_reference(model):
    jcfg, jparams, _, _ = model
    return jax_engine_tokens(jcfg, jparams, REQS, max_len=64)


@pytest.mark.parametrize("kw", [dict(decode_kernel="chunked"),
                                dict(decode_kernel="flash", paged=True,
                                     page_size=16)])
def test_engine_matches_reference(model, engine_reference, kw):
    _, _, cfg, params = model
    eng = ServeEngine(cfg, params, n_slots=2, max_len=64, device="cpu", **kw)
    out = eng.run_until_drained(list(REQS))
    for rid, _, _ in REQS:
        assert out[rid] == engine_reference[rid], rid


def test_train_steps_match_reference():
    jm = train_steps_match(ARCH)
    assert float(jm["aux_loss"]) > 0


def test_router_gradient_carries_the_aux_loss(model):
    """``forward`` keeps the aux loss in the graph: the router's gradient
    at aux weight 0.5 differs from that at 0, and each equals jax.grad of
    the reference's loss."""
    jcfg, jparams, cfg, params = model
    batch = jax_batch_at(jcfg, 0, 0, batch=2, seq=32)
    grads = {}
    for w in (0.0, 0.5):
        jg = jax.grad(lambda p: jax_loss_fn(
            p, jcfg, {k: jnp.asarray(v) for k, v in batch.items()}, None,
            "none", w)[0])(jparams)
        flat = [p.detach().clone().requires_grad_(True)
                for p in leaves(params)]
        loss, _ = _loss_fn(unflatten_as(params, flat), cfg,
                           {k: torch.from_numpy(v) for k, v in batch.items()},
                           w)
        tg = unflatten_as(params, list(torch.autograd.grad(loss, flat)))
        router = tg["periods"]["0"]["ffn"]["router"]
        close(router, jg["periods"]["0"]["ffn"]["router"], atol=1e-6)
        grads[w] = router
    assert float((grads[0.5] - grads[0.0]).abs().max()) > 1e-4
