"""The port's model core against the JAX reference, on the CPU.

* ``model_spec`` of both packages has the same keys and shapes for every
  config the port covers (full size and smoke), and the others raise.
* A JAX ``init_params`` tree, carried across with ``tree_to_torch``, runs
  through the port's ``forward``: logits within atol 2e-5 of JAX's for
  whole-sequence, dense-decode, ring-decode and paged-decode, on the
  ``stablelm_1_6b`` and ``gemma3_1b`` smoke configs in float32; and on the
  ``mamba2_130m`` smoke config (Mamba-2 SSD layers, no MLP) for the whole
  sequence, prefill into the caches and decode steps (``ssd_step`` with the
  conv state).
* The port's ``init_params`` draws in the target dtype on the target
  device, deterministically per generator.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jax_configs
from repro.models import count_params as jax_count_params
from repro.models import init_params as jax_init_params
from repro.models import model_spec as jax_model_spec
from repro.models.transformer import forward as jax_forward
from repro.models.transformer import init_caches as jax_init_caches
from repro.models.transformer import init_paged_caches as jax_init_paged
from repro_torch import configs
from repro_torch.convert import tree_to_torch
from repro_torch.models import (cache_shapes, count_params, forward,
                                init_params, model_spec, param_shapes)
from repro_torch.models.layers import unembed
from repro_torch.models.params import spec_leaves
from repro_torch.models.transformer import init_caches, init_paged_caches
from repro_torch.serve import PageAllocator

ATOL = 2e-5
PORTED = ("stablelm_1_6b", "gemma3_1b", "gemma3_4b", "internlm2_1_8b",
          "mamba2_130m")
NOT_YET = tuple(a for a in jax_configs.ARCHS if a not in PORTED)


def _spec_shapes(tree, leaf):
    """{key path: shape} of a spec tree, either package's."""
    out = {}

    def walk(node, path):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, path + (k,))
        else:
            out[path] = tuple(leaf(node))
    walk(tree, ())
    return out


@pytest.mark.parametrize("arch", PORTED)
@pytest.mark.parametrize("size", ["config", "smoke_config"])
def test_model_spec_matches_reference(arch, size):
    cfg = getattr(configs, "get_config" if size == "config"
                  else "smoke_config")(arch)
    jcfg = getattr(jax_configs, "get_config" if size == "config"
                   else "smoke_config")(arch)
    # field by field, nested configs (SSMConfig, ...) included
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    got = _spec_shapes(model_spec(cfg), lambda s: s.shape)
    want = _spec_shapes(jax_model_spec(jcfg), lambda s: s.shape)
    assert got == want
    jax_axes = _spec_shapes(jax_model_spec(jcfg), lambda s: s.axes)
    assert _spec_shapes(model_spec(cfg), lambda s: s.axes) == jax_axes
    assert count_params(model_spec(cfg)) == \
        jax_count_params(jax_model_spec(jcfg))


@pytest.mark.parametrize("arch", NOT_YET)
def test_unported_architectures_raise(arch):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        model_spec(configs.get_config(arch))


def test_init_params_dtype_device_and_determinism():
    cfg = configs.smoke_config("gemma3_1b")
    spec = model_spec(cfg)
    a = init_params(spec, torch.Generator().manual_seed(7), torch.bfloat16,
                    "cpu")
    b = init_params(spec, torch.Generator().manual_seed(7), torch.bfloat16,
                    "cpu")
    shapes = _spec_shapes(param_shapes(spec, torch.bfloat16),
                          lambda t: t.shape)
    assert _spec_shapes(a, lambda t: t.shape) == shapes
    for path in shapes:
        la, lb = a, b
        for k in path:
            la, lb = la[k], lb[k]
        assert la.dtype == torch.bfloat16 and la.device.type == "cpu"
        assert torch.equal(la, lb), path
    emb = a["embed"]["embedding"]
    assert 0.015 < float(emb.float().std()) < 0.025       # normal, 0.02
    assert torch.equal(a["final_norm"]["scale"],
                       torch.ones_like(a["final_norm"]["scale"]))
    assert sum(int(np.prod(s)) for s in shapes.values()) == \
        count_params(spec) == sum(int(np.prod(s.shape))
                                  for s in spec_leaves(spec))


def test_unembed_reads_the_tied_table_in_place():
    """``.to(dtype)`` of the tied table in its own dtype is the table."""
    cfg = configs.smoke_config("gemma3_1b")
    params = init_params(model_spec(cfg), torch.Generator().manual_seed(0),
                         torch.float32, "cpu")
    table = params["embed"]["embedding"]
    assert table.to(torch.float32) is table
    x = torch.randn(2, 3, cfg.d_model)
    torch.testing.assert_close(unembed(params["embed"], cfg, x),
                               x @ table.T, atol=1e-6, rtol=1e-6)


# ---------------------------------------------------------------------------
# logits parity on JAX weights
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module",
                params=["stablelm_1_6b", "gemma3_1b", "mamba2_130m"])
def model(request):
    arch = request.param
    jcfg = jax_configs.smoke_config(arch)
    jparams = jax_init_params(jax_model_spec(jcfg), jax.random.PRNGKey(1),
                              jnp.float32)
    params = tree_to_torch(jax.tree.map(np.asarray, jparams), "cpu")
    return arch, jcfg, jparams, configs.smoke_config(arch), params, {}


def test_whole_sequence_logits(model):
    """S=128 > kv_chunk: the chunked loop, and for gemma3's local layers
    the banded path; for mamba2, four SSD chunks of 32."""
    _, jcfg, jparams, cfg, params, _ = model
    tokens = np.random.RandomState(0).randint(0, cfg.vocab_size, (2, 128))
    want, _, _ = jax_forward(jparams, jcfg,
                             {"tokens": jnp.asarray(tokens, jnp.int32)})
    got, caches, _ = forward(params, cfg, {"tokens": torch.from_numpy(tokens)})
    assert caches is None
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


STEPS, MAX_LEN, PAGE_SIZE = 40, 48, 8
START = np.array([0, 3], np.int32)   # ragged: slot 1 starts at position 3


def _schedule(cfg, paged):
    """Per step: tokens (2, 1), per-slot positions and the page table."""
    tokens = np.random.RandomState(1).randint(0, cfg.vocab_size, (2, STEPS))
    alloc = PageAllocator(2 * (MAX_LEN // PAGE_SIZE) + 1, PAGE_SIZE, 2,
                          MAX_LEN // PAGE_SIZE)
    for t in range(STEPS):
        pos = START + t
        table = None
        if paged:
            for i in range(2):
                assert alloc.ensure(i, int(pos[i]))
            table = alloc.table.copy()
        yield tokens[:, t:t + 1], pos, table


def _jax_decode(model, paged):
    """The JAX reference's logits at every step (chunked, jitted), once per
    model and layout. At MAX_LEN 48 gemma3's local layers (window 32) are
    rings that wrap."""
    _, jcfg, jparams, cfg, _, memo = model
    if paged not in memo:
        if paged:
            caches = jax_init_paged(jcfg, 2, MAX_LEN, jnp.float32,
                                    page_size=PAGE_SIZE)
        else:
            caches = jax_init_caches(jcfg, 2, MAX_LEN, jnp.float32)

        @jax.jit
        def step(p, tok, caches, idx, pages):
            logits, new, _ = jax_forward(p, jcfg, {"tokens": tok},
                                         caches=caches, cache_index=idx,
                                         pages=pages)
            return logits, new

        out = []
        for tok, pos, table in _schedule(cfg, paged):
            logits, caches = step(jparams, jnp.asarray(tok, jnp.int32),
                                  caches, jnp.asarray(pos),
                                  None if table is None
                                  else jnp.asarray(table))
            out.append(np.asarray(logits))
        memo[paged] = out
    return memo[paged]


def _decode_error(model, *, paged, kernel):
    """Max |port - JAX| over the logits of every decode step."""
    _, _, _, cfg, params, _ = model
    want = _jax_decode(model, paged)
    if paged:
        caches = init_paged_caches(cfg, 2, MAX_LEN, torch.float32,
                                   page_size=PAGE_SIZE, device="cpu")
    else:
        caches = init_caches(cfg, 2, MAX_LEN, torch.float32, "cpu")
    tcfg = cfg.with_(decode_kernel=kernel)
    err = 0.0
    for (tok, pos, table), w in zip(_schedule(cfg, paged), want):
        got, caches, _ = forward(params, tcfg,
                                 {"tokens": torch.from_numpy(tok)},
                                 caches=caches,
                                 cache_index=torch.from_numpy(pos),
                                 pages=None if table is None
                                 else torch.from_numpy(table))
        err = max(err, float(np.abs(got.numpy() - w).max()))
    return err


@pytest.mark.parametrize("kernel", ["chunked", "flash"])
def test_decode_logits_dense_and_ring(model, kernel):
    """stablelm: dense decode; gemma3: ring decode on its local layers and
    dense decode on its global layers."""
    assert _decode_error(model, paged=False, kernel=kernel) <= ATOL


@pytest.mark.parametrize("kernel", ["chunked", "flash"])
def test_decode_logits_paged(model, kernel):
    assert _decode_error(model, paged=True, kernel=kernel) <= ATOL


def test_cache_layouts_match_reference(model):
    _, jcfg, _, cfg, _, _ = model
    want = jax.tree.map(lambda a: a.shape, jax_init_caches(jcfg, 3, 48,
                                                           jnp.float32))
    got = jax.tree.map(lambda a: tuple(a.shape),
                       cache_shapes(cfg, 3, 48, torch.float32))
    assert got == want
    want = jax.tree.map(lambda a: a.shape, jax_init_paged(
        jcfg, 3, 48, jnp.float32, page_size=8))
    got = jax.tree.map(lambda a: tuple(a.shape), init_paged_caches(
        cfg, 3, 48, torch.float32, page_size=8, device="cpu"))
    assert got == want


def test_prefill_then_decode_matches_reference(model):
    """``make_prefill_step`` writes a 40-token prompt into the caches (for
    gemma3 more than its 32-row rings hold), then one decode step."""
    from repro.train.step import make_prefill_step as jax_prefill
    from repro.train.step import make_serve_step as jax_serve
    from repro_torch.train import (make_decode_caches, make_prefill_step,
                                   make_serve_step)
    _, jcfg, jparams, cfg, params, _ = model
    tokens = np.random.RandomState(2).randint(0, cfg.vocab_size, (2, 40))
    want, jc = jax.jit(jax_prefill(jcfg))(
        jparams, {"tokens": jnp.asarray(tokens, jnp.int32)},
        jax_init_caches(jcfg, 2, MAX_LEN, jnp.float32))
    got, tc = make_prefill_step(cfg)(
        params, {"tokens": torch.from_numpy(tokens)},
        make_decode_caches(cfg, 2, MAX_LEN, "cpu"))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    nxt = np.asarray(want).argmax(-1)[:, None].astype(np.int32)
    pos = np.full((2,), 40, np.int32)
    want, want_ids, _ = jax.jit(jax_serve(jcfg))(
        jparams, jnp.asarray(nxt), jc, jnp.asarray(pos))
    got, got_ids, _ = make_serve_step(cfg, decode_kernel="flash")(
        params, torch.from_numpy(nxt), tc, torch.from_numpy(pos))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    np.testing.assert_array_equal(got_ids.numpy(), np.asarray(want_ids))


def test_mamba2_blocks_have_no_mlp():
    """The reference's ``_has_mlp`` rule: an ``ssd`` block with d_ff = 0
    has no ``norm2``/``ffn``; attention blocks always have them."""
    from repro_torch.models import block_spec
    cfg = configs.get_config("mamba2_130m")
    assert set(block_spec(cfg, "ssd")) == {"norm1", "mix"}
    assert {"norm2", "ffn"} <= set(block_spec(configs.get_config(
        "stablelm_1_6b"), "attn"))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        block_spec(configs.get_config("recurrentgemma_2b"), "rglru")
