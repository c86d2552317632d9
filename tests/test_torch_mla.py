"""The port's MLA (``repro_torch.models.mla``) against the JAX package, on
the CPU, on the ``deepseek_v3_671b`` smoke config (2 layers of MLA and the
MoE: q rank 32, latent 16, RoPE 8, nope 16, v 16), JAX weights carried
across:

* ``_project_q`` and ``_compress_kv``; the materialized block; the absorbed
  decode with a scalar and with a per-slot ``cache_index``, cache written
  in place: 2e-5;
* decode logits against JAX's (2e-5), and against the port's own
  whole-sequence logits on the same tokens (the absorbed identity);
* the dense engine's greedy tokens against the JAX engine's;
* ``init_paged_caches`` and a ``paged=True`` engine raise
  ``NotImplementedError``, as the reference's do;
* three train steps within 1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (ATOL, close, decode_errors, jax_engine_tokens,
                           jax_weights, prompts, to_torch, train_steps_match,
                           whole_sequence_error)
from repro import configs as jax_configs
from repro.models import init_params as jax_init_params
from repro.models import mla as jmla
from repro.models.attention import _expand_positions as jax_positions
from repro.models.transformer import init_caches as jax_init_caches
from repro.models.transformer import init_paged_caches as jax_init_paged
from repro.serve import ServeEngine as JaxEngine
from repro_torch import configs
from repro_torch.models import cache_shapes, forward
from repro_torch.models import mla as tmla
from repro_torch.models.attention import _expand_positions
from repro_torch.models.transformer import init_caches, init_paged_caches
from repro_torch.serve import ServeEngine

ARCH = "deepseek_v3_671b"
B, S, CACHE = 2, 24, 32


@pytest.fixture(scope="module")
def model():
    return jax_weights(ARCH)


@pytest.fixture(scope="module")
def block():
    """One MLA block's JAX params (its own spec, seed 3), carried across,
    and an input (B, S, d) from numpy."""
    jcfg, cfg = jax_configs.smoke_config(ARCH), configs.smoke_config(ARCH)
    jp = jax_init_params(jmla.mla_spec(jcfg), jax.random.PRNGKey(3),
                         jnp.float32)
    x = np.random.RandomState(4).standard_normal(
        (B, S, cfg.d_model)).astype(np.float32)
    return jcfg, jp, cfg, to_torch(jp), x


@pytest.mark.parametrize("fn", ["_project_q", "_compress_kv"])
def test_projections(block, fn):
    """At ragged per-slot positions (the RoPE halves)."""
    jcfg, jp, cfg, tp, x = block
    start = np.asarray([5, 9], np.int32)
    want = getattr(jmla, fn)(jp, jcfg, jnp.asarray(x),
                             jax_positions(jnp.asarray(start), B, S))
    got = getattr(tmla, fn)(tp, cfg, torch.from_numpy(x),
                            _expand_positions(torch.from_numpy(start), B, S,
                                              torch.device("cpu")))
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        close(g, w)


def test_materialized_block(block):
    jcfg, jp, cfg, tp, x = block
    want, wc = jmla.mla_block(jp, jcfg, jnp.asarray(x))
    got, gc = tmla.mla_block(tp, cfg, torch.from_numpy(x))
    assert wc is None and gc is None
    close(got, want)


@pytest.mark.parametrize("index", ["scalar", "per_slot"])
@pytest.mark.parametrize("tokens", [1, 5])
def test_absorbed_decode(block, index, tokens):
    """From a cache holding 7 (scalar) or 7 and 11 (per slot) earlier
    tokens' latents, ``tokens`` more at once: output and the cache written
    in place."""
    jcfg, jp, cfg, tp, x = block
    rng = np.random.RandomState(5)
    m = cfg.mla
    cache = {"c_kv": rng.standard_normal((B, CACHE, m.kv_lora_rank)),
             "k_rope": rng.standard_normal((B, CACHE, m.rope_head_dim))}
    cache = {k: v.astype(np.float32) for k, v in cache.items()}
    idx = np.asarray(7, np.int32) if index == "scalar" \
        else np.asarray([7, 11], np.int32)
    xs = x[:, :tokens]
    want, wc = jmla.mla_block(jp, jcfg, jnp.asarray(xs),
                              positions=jnp.asarray(idx),
                              cache={k: jnp.asarray(v)
                                     for k, v in cache.items()},
                              cache_index=jnp.asarray(idx))
    tc = {k: torch.from_numpy(v.copy()) for k, v in cache.items()}
    held = dict(tc)
    got, gc = tmla.mla_block(tp, cfg, torch.from_numpy(xs),
                             positions=torch.from_numpy(idx), cache=tc,
                             cache_index=torch.from_numpy(idx))
    assert gc is tc and all(gc[k] is held[k] for k in held)
    close(got, want)
    for k in cache:
        close(gc[k], wc[k])


def test_cache_layouts_and_no_paged_mla(model):
    jcfg, _, cfg, _ = model
    want = jax.tree.map(lambda a: a.shape,
                        jax_init_caches(jcfg, 3, 48, jnp.float32))
    got = jax.tree.map(lambda a: tuple(a.shape),
                       cache_shapes(cfg, 3, 48, torch.float32))
    assert got == want
    with pytest.raises(NotImplementedError):
        jax_init_paged(jcfg, 3, 48, jnp.float32, page_size=8)
    with pytest.raises(NotImplementedError):
        init_paged_caches(cfg, 3, 48, torch.float32, page_size=8,
                          device="cpu")


def test_paged_engine_raises_as_the_reference(model):
    jcfg, jparams, cfg, params = model
    with pytest.raises(NotImplementedError):
        JaxEngine(jcfg, jparams, n_slots=2, max_len=32, paged=True,
                  page_size=8)
    with pytest.raises(NotImplementedError):
        ServeEngine(cfg, params, n_slots=2, max_len=32, paged=True,
                    page_size=8, device="cpu")


def test_whole_sequence_logits(model):
    tokens = np.random.RandomState(0).randint(0, 512, (2, 96))
    err, _ = whole_sequence_error(model, tokens)
    assert err <= ATOL


def test_decode_logits(model):
    """Per-slot absorbed decode against JAX's."""
    errs = decode_errors(model, paged=False, kernels=("chunked",), steps=24,
                         start=(0, 3), max_len=32)
    assert errs["chunked"] <= ATOL, errs


def test_absorbed_decode_equals_materialized(model):
    """Token by token through the latent caches from position 0, the
    logits equal the whole-sequence forward's on the same tokens: the
    absorbed identity (the MoE is dropless at decode and drops nothing at
    the smoke capacity factor)."""
    _, _, cfg, params = model
    tokens = np.random.RandomState(3).randint(0, cfg.vocab_size, (2, 20))
    whole, _, _ = forward(params, cfg, {"tokens": torch.from_numpy(tokens)})
    caches = init_caches(cfg, 2, 32, torch.float32, "cpu")
    for t in range(tokens.shape[1]):
        got, caches, _ = forward(
            params, cfg, {"tokens": torch.from_numpy(tokens[:, t:t + 1])},
            caches=caches, cache_index=torch.full((2,), t, dtype=torch.int32))
        close(got[:, 0], whole[:, t].numpy())


REQS = [(f"d{i}", p, 5) for i, p in enumerate(prompts(12, [6, 4, 8]))]


def test_engine_matches_reference(model):
    """Three requests on two slots: a reused slot's latent cache is masked
    by position, not zeroed."""
    jcfg, jparams, cfg, params = model
    want = jax_engine_tokens(jcfg, jparams, REQS, max_len=64)
    eng = ServeEngine(cfg, params, n_slots=2, max_len=64, device="cpu")
    out = eng.run_until_drained(list(REQS))
    for rid, _, _ in REQS:
        assert out[rid] == want[rid], rid


def test_train_steps_match_reference():
    train_steps_match(ARCH)
