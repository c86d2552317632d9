"""The port's RG-LRU slice (``repro_torch.models.rglru``, the ``rglru`` layer
kind) against the JAX package, on the CPU, on the ``recurrentgemma_2b``
smoke config (one period of (rglru, rglru, local) and a tail of two rglru
layers; 4 query heads on one KV head; window 32), JAX weights carried
across:

* ``_causal_conv`` with and without a state, ``_gates``, ``rglru_scan`` at
  chunks 512, 8 and 7 (S = 32: one chunk, four, and five with padding),
  with and without ``h0``, ``rglru_step``, and ``rglru_block`` over a whole
  sequence, several tokens with a cache and one token: 2e-5;
* logits within 2e-5: the whole sequence, per-slot decode over dense ring
  caches (chunked and flash), over paged caches (the local layers' pools at
  ``max_len`` = window), and a prefill then a decode step;
* three train steps within 1e-5;
* the port's engine's greedy tokens equal the JAX engine's: the hybrid
  case of ``tests/test_serving.py`` and the recurrent flash case of
  ``tests/test_serve.py`` (more requests than slots: a reused slot's
  recurrent state is reset).
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
from repro.models import rglru as jrg
from repro.models.transformer import init_caches as jax_init_caches
from repro.train.step import make_prefill_step as jax_prefill
from repro.train.step import make_serve_step as jax_serve
from repro_torch import configs
from repro_torch.models import cache_shapes
from repro_torch.models import rglru as trg
from repro_torch.models.params import init_params
from repro_torch.models.transformer import init_paged_caches
from repro_torch.serve import ServeEngine
from repro_torch.train import (make_decode_caches, make_prefill_step,
                               make_serve_step)

ARCH = "recurrentgemma_2b"


@pytest.fixture(scope="module")
def model():
    return jax_weights(ARCH)


@pytest.fixture(scope="module")
def block():
    """One rglru block's JAX params (its own spec, seed 3), carried across,
    and an input (B=2, S=32, d) from numpy."""
    jcfg, cfg = jax_configs.smoke_config(ARCH), configs.smoke_config(ARCH)
    jp = jax_init_params(jrg.rglru_spec(jcfg), jax.random.PRNGKey(3),
                         jnp.float32)
    x = np.random.RandomState(4).standard_normal(
        (2, 32, cfg.d_model)).astype(np.float32)
    return jcfg, jp, cfg, to_torch(jp), x


def _lru_input(block):
    """The scan's input: the block's in-projection of x."""
    jcfg, jp, cfg, tp, x = block
    return x @ np.asarray(jp["w_x"])


@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv(block, with_state):
    jcfg, jp, cfg, tp, x = block
    u = _lru_input(block)
    state = None
    if with_state:
        state = np.random.RandomState(5).standard_normal(
            (2, 3, u.shape[2])).astype(np.float32)
    want, want_state = jrg._causal_conv(
        jnp.asarray(u), jp["conv_w"], jp["conv_b"],
        None if state is None else jnp.asarray(state))
    got, got_state = trg._causal_conv(
        torch.from_numpy(u), tp["conv_w"], tp["conv_b"],
        None if state is None else torch.from_numpy(state))
    close(got, want)
    close(got_state, want_state)


def test_gates(block):
    jcfg, jp, cfg, tp, x = block
    u = _lru_input(block)
    want_a, want_x = jrg._gates(jp, jcfg, jnp.asarray(u))
    got_a, got_x = trg._gates(tp, cfg, torch.from_numpy(u))
    assert got_a.dtype == got_x.dtype == torch.float32
    close(got_a, want_a)
    close(got_x, want_x)


def test_softplus_has_no_linear_cut_off():
    """jax.nn.softplus has no threshold; F.softplus returns x above 20."""
    x = torch.tensor([-30.0, 0.0, 19.5, 20.5, 40.0])
    want = np.asarray(jax.nn.softplus(jnp.asarray(x.numpy())))
    close(trg._softplus(x), want, atol=1e-6)


@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("chunk", [512, 8, 7])
def test_rglru_scan(block, chunk, with_h0):
    jcfg, jp, cfg, tp, x = block
    u = _lru_input(block)
    h0 = None
    if with_h0:
        h0 = np.random.RandomState(6).standard_normal(
            (2, u.shape[2])).astype(np.float32)
    want_seq, want_h = jrg.rglru_scan(
        jp, jcfg, jnp.asarray(u), chunk=chunk,
        h0=None if h0 is None else jnp.asarray(h0))
    got_seq, got_h = trg.rglru_scan(
        tp, cfg, torch.from_numpy(u), chunk=chunk,
        h0=None if h0 is None else torch.from_numpy(h0))
    assert got_seq.shape == u.shape and got_h.dtype == torch.float32
    close(got_seq, want_seq)
    close(got_h, want_h)


def test_rglru_step(block):
    jcfg, jp, cfg, tp, x = block
    u = _lru_input(block)[:, :1]
    h = np.random.RandomState(7).standard_normal(
        (2, u.shape[2])).astype(np.float32)
    want_y, want_h = jrg.rglru_step(jp, jcfg, jnp.asarray(u), jnp.asarray(h))
    got_y, got_h = trg.rglru_step(tp, cfg, torch.from_numpy(u),
                                  torch.from_numpy(h))
    close(got_y, want_y)
    close(got_h, want_h)


@pytest.mark.parametrize("mode", ["whole", "cached_tokens", "one_token"])
def test_rglru_block(block, mode):
    """The cached modes start from a nonzero state; the port writes it in
    place and returns the same dict."""
    jcfg, jp, cfg, tp, x = block
    if mode == "whole":
        want, wc = jrg.rglru_block(jp, jcfg, jnp.asarray(x))
        got, gc = trg.rglru_block(tp, cfg, torch.from_numpy(x))
        assert wc is None and gc is None
        close(got, want)
        return
    xs = x[:, :1] if mode == "one_token" else x[:, :12]
    rng = np.random.RandomState(8)
    h = rng.standard_normal((2, cfg.rglru.lru_width)).astype(np.float32)
    conv = rng.standard_normal((2, 3, cfg.rglru.lru_width)).astype(
        np.float32)
    want, wc = jrg.rglru_block(jp, jcfg, jnp.asarray(xs),
                               cache={"h": jnp.asarray(h),
                                      "conv": jnp.asarray(conv)})
    cache = {"h": torch.from_numpy(h.copy()),
             "conv": torch.from_numpy(conv.copy())}
    h_t, conv_t = cache["h"], cache["conv"]
    got, gc = trg.rglru_block(tp, cfg, torch.from_numpy(xs), cache=cache)
    assert gc is cache and gc["h"] is h_t and gc["conv"] is conv_t
    close(got, want)
    close(gc["h"], wc["h"])
    close(gc["conv"], wc["conv"])


def test_cache_layouts_match_reference(model):
    jcfg, _, cfg, _ = model
    want = jax.tree.map(lambda a: a.shape,
                        jax_init_caches(jcfg, 3, 48, jnp.float32))
    shapes = cache_shapes(cfg, 3, 48, torch.bfloat16)
    assert jax.tree.map(lambda a: tuple(a.shape), shapes) == want
    # the recurrent state stays float32 in a bf16 model, as in the reference
    assert shapes["tail"]["0"]["h"].dtype == torch.float32
    assert shapes["tail"]["0"]["conv"].dtype == torch.bfloat16
    paged = init_paged_caches(cfg, 3, 32, torch.float32, page_size=8,
                              device="cpu")
    assert set(paged["periods"]["2"]) == {"pool_k", "pool_v"}
    assert set(paged["periods"]["0"]) == {"h", "conv"}


def test_whole_sequence_logits(model):
    """S = 128: four windows of the local layer (the banded path) and the
    scan's one chunk."""
    tokens = np.random.RandomState(0).randint(0, 512, (2, 128))
    err, _ = whole_sequence_error(model, tokens)
    assert err <= ATOL


def test_decode_logits_ring(model):
    """max_len 48 > window 32: the local layer's ring wraps; slot 1 starts
    at position 3."""
    errs = decode_errors(model, paged=False, kernels=("chunked", "flash"),
                         steps=40, start=(0, 3), max_len=48)
    assert max(errs.values()) <= ATOL, errs


def test_decode_logits_paged(model):
    """max_len 32 = window: the local layer's cache is a page pool, the
    rglru layers keep their dense state."""
    errs = decode_errors(model, paged=True, kernels=("chunked", "flash"),
                         steps=28, start=(0, 3), max_len=32)
    assert max(errs.values()) <= ATOL, errs


def test_prefill_then_decode(model):
    """A 40-token prompt through ``make_prefill_step`` (the scan from the
    caches' zero state, the conv window kept, a ring that wraps), then one
    flash decode step."""
    jcfg, jparams, cfg, params = model
    tokens = np.random.RandomState(2).randint(0, cfg.vocab_size, (2, 40))
    want, jc = jax.jit(jax_prefill(jcfg))(
        jparams, {"tokens": jnp.asarray(tokens, jnp.int32)},
        jax_init_caches(jcfg, 2, 48, jnp.float32))
    got, tc = make_prefill_step(cfg)(
        params, {"tokens": torch.from_numpy(tokens)},
        make_decode_caches(cfg, 2, 48, "cpu"))
    close(got, want)
    for name in ("h", "conv"):
        close(tc["tail"]["1"][name], jc["tail"]["1"][name])
    nxt = np.asarray(want).argmax(-1)[:, None].astype(np.int32)
    pos = np.full((2,), 40, np.int32)
    want, want_ids, _ = jax.jit(jax_serve(jcfg))(
        jparams, jnp.asarray(nxt), jc, jnp.asarray(pos))
    got, got_ids, _ = make_serve_step(cfg, decode_kernel="flash")(
        params, torch.from_numpy(nxt), tc, torch.from_numpy(pos))
    close(got, want)
    np.testing.assert_array_equal(got_ids.numpy(), np.asarray(want_ids))


def test_train_steps_match_reference():
    train_steps_match(ARCH)


# ---------------------------------------------------------------------------
# the serving engine
# ---------------------------------------------------------------------------

REQS = {
    # tests/test_serving.py::test_engine_hybrid_arch: two requests
    "hybrid": [(rid, p, 4) for rid, p in zip("xy", prompts(2, [5, 8]))],
    # tests/test_serve.py::test_flash_engine_recurrent_arch: four requests
    # on two slots
    "recurrent": [(f"r{i}", p, 4)
                  for i, p in enumerate(prompts(6, [5 + i
                                                     for i in range(4)]))],
}


@pytest.fixture(scope="module")
def engine_reference(model):
    jcfg, jparams, _, _ = model
    reqs = REQS["hybrid"] + REQS["recurrent"]
    return jax_engine_tokens(jcfg, jparams, reqs)


@pytest.mark.parametrize("case,kw", [
    ("hybrid", dict()),
    ("recurrent", dict(decode_kernel="flash")),
    ("recurrent", dict(decode_kernel="flash", paged=True, page_size=16,
                       max_len=32)),
])
def test_engine_matches_reference(model, engine_reference, case, kw):
    """Greedy tokens equal the JAX engine's; on two slots, so the four
    recurrent requests reuse slots (lazy admission zeroes their state)."""
    _, _, cfg, params = model
    kw = dict(dict(n_slots=2, max_len=96), **kw)
    eng = ServeEngine(cfg, params, device="cpu", **kw)
    out = eng.run_until_drained(list(REQS[case]))
    assert set(out) == {rid for rid, _, _ in REQS[case]}
    for rid, _, _ in REQS[case]:
        assert out[rid] == engine_reference[rid], rid


def test_init_params_draws_the_recurrent_leaves(model):
    """The port's own initialisation: lambda in the reference's range and
    the conv bias zero, in the target dtype."""
    _, _, cfg, _ = model
    from repro_torch.models import model_spec
    p = init_params(model_spec(cfg), torch.Generator().manual_seed(0),
                    torch.bfloat16, "cpu")
    mix = p["tail"]["0"]["mix"]
    assert mix["lam"].dtype == torch.bfloat16
    a = torch.exp(-cfg.rglru.c * trg._softplus(mix["lam"].float()))
    assert float(a.min()) > 0.89 and float(a.max()) < 1.0
    assert not mix["conv_b"].any()
