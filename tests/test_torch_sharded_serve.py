"""The port's sharded serving path on CPU worlds of gloo ranks, held to the
JAX reference's single-device ``forward`` and to the port's single-device
prefill and serve steps.

The reference's own sharded program cannot be the oracle here (its
``tests/island_check_opt.py`` runs on no test, and ``tests/island_check.py``
stops in ``repro/models/layers.py:96`` on this jax, ``ROADMAP.md`` Queue
3): the port's sharded prefill and decode are held to JAX's single-device
``forward`` over the whole sequence, as ``island_check_opt.py::
check_flash_decode`` holds the reference's (its limit 5e-2), and to the
port's single-device steps.

Two worlds of 8 ranks (``tests/_torch_sharded_worker.py``), each started
once: world A on ``island_check_opt.py``'s (data=2, model=4) mesh, where
stablelm's and moonshot's KV heads split over ``model`` and gemma3-1b's,
internlm2's (2 KV heads) and deepseek's latent caches split on the
sequence; world B on (pod=2, data=2, model=2). In each, every one of the
ten configs' smoke models (the port's weights of seed 2, carried to JAX)
takes a prefill of 24 tokens (internvl2: after its 8 patches) and then 16
greedy tokens, under the default flags and under ``{"flash_decode"}``;
hubert (encoder-only) takes its prefill. gemma3's local layers decode
through 32-row ring caches (the cache is 40 rows), which never take the
island; nor do caches cut on their KV heads, which have nothing to merge.
Per case:

* the greedy tokens equal the port's single-device steps';
* every step's logits within 1e-4 of JAX's ``forward`` over the generated
  sequence at that position (float32 smoke configs), and of the port's
  single-device step.

World A also runs gemma3-1b's paged serve step (pools replicated over the
mesh, the prompt fed a token a step), held to the single-device paged step.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_sharded_worker import spawn_world
from repro import configs as jax_configs
from repro.models.transformer import forward as jax_forward
from repro_torch import configs
from repro_torch.launch.mesh import smoke_axes
from repro_torch.models import init_params, model_spec
from repro_torch.models.transformer import init_caches, init_paged_caches
from repro_torch.train import make_prefill_step, make_serve_step

ATOL = 1e-4
B, PROMPT, NEW = 4, 24, 16
FLAGS = {"default": (), "flash_decode": ("flash_decode",)}
WORLD_TIMEOUT = 600.0
PAGED = dict(arch="gemma3_1b", prompt=8, page_size=8)


def _inputs(cfg, seed=2):
    """(prompt tokens (B, PROMPT) int32, frontend embeds or None)."""
    rng = np.random.RandomState(seed)
    tokens = torch.from_numpy(rng.randint(0, cfg.vocab_size, (B, PROMPT))
                              .astype(np.int32))
    embeds = None
    if cfg.frontend is not None:
        n = PROMPT if cfg.encoder_only else cfg.frontend.n_positions
        embeds = torch.from_numpy(rng.randn(B, n, cfg.frontend.input_dim)
                                  .astype(np.float32))
    return tokens, embeds


def _mask_pad(cfg, logits):
    if cfg.padded_vocab != cfg.vocab_size:
        logits = logits.masked_fill(
            torch.arange(cfg.padded_vocab) >= cfg.vocab_size, -1e30)
    return logits


def _single_device(cfg, params, tokens, embeds):
    """The port's single-device prefill and greedy decode: (every step's
    logits, tokens (B, NEW))."""
    if cfg.encoder_only:
        return [make_prefill_step(cfg)(params, {"embeds": embeds,
                                                "tokens": tokens})], None
    n_pre = embeds.shape[1] if embeds is not None else 0
    caches = init_caches(cfg, B, n_pre + PROMPT + NEW, torch.float32, "cpu")
    batch = {"tokens": tokens}
    if embeds is not None:
        batch["embeds"] = embeds
    logits, caches = make_prefill_step(cfg)(params, batch, caches)
    logits = _mask_pad(cfg, logits)
    nxt = torch.argmax(logits, -1).to(torch.int32)
    out, toks = [logits], [nxt]
    serve = make_serve_step(cfg)
    for t in range(NEW - 1):
        logits, nxt, caches = serve(params, nxt[:, None], caches,
                                    torch.tensor(n_pre + PROMPT + t,
                                                 dtype=torch.int32))
        out.append(logits)
        toks.append(nxt)
    return out, torch.stack(toks, 1)


def _jax_logits(jcfg, jparams, tokens, embeds, generated):
    """JAX's single-device forward over the prompt and the generated tokens:
    the logits that predict each generated token, (NEW, B, V); an encoder's
    (B, S, V)."""
    batch = {}
    if embeds is not None:
        batch["embeds"] = jnp.asarray(embeds.numpy())
    if jcfg.encoder_only:
        logits, _, _ = jax.jit(lambda p, b: jax_forward(p, jcfg, b))(
            jparams, batch)
        return np.asarray(logits)
    seq = torch.cat([tokens, generated[:, :-1]], 1)
    batch["tokens"] = jnp.asarray(seq.numpy())
    logits, _, _ = jax.jit(lambda p, b: jax_forward(p, jcfg, b))(jparams,
                                                                  batch)
    logits = np.asarray(logits)[:, PROMPT - 1:]
    return np.moveaxis(logits, 1, 0)


def _paged_single(cfg, params, tokens, pages):
    """The single-device paged serve step, the prompt fed a token a step."""
    p = PAGED["prompt"]
    caches = init_paged_caches(cfg, B, p + NEW, torch.float32,
                               page_size=PAGED["page_size"], device="cpu")
    serve = make_serve_step(cfg, paged=True)
    out, toks = [], []
    for t in range(p + NEW - 1):
        tok = tokens[:, t:t + 1] if t < p else nxt[:, None]
        logits, nxt, caches = serve(params, tok, caches,
                                    torch.full((B,), t, dtype=torch.int32),
                                    pages)
        if t >= p - 1:
            out.append(logits)
            toks.append(nxt)
    return out, torch.stack(toks, 1)


def _pages():
    per = -(-(PAGED["prompt"] + NEW) // PAGED["page_size"])
    return torch.arange(1, 1 + B * per, dtype=torch.int32).reshape(B, per)


@pytest.fixture(scope="module")
def references():
    """Per arch: the case a world runs and what it is held to."""
    refs = {}
    for arch in configs.ARCHS:
        jcfg, cfg = jax_configs.smoke_config(arch), configs.smoke_config(arch)
        params = init_params(model_spec(cfg), torch.Generator().manual_seed(2),
                             torch.float32, "cpu")
        jparams = jax.tree.map(lambda t: jnp.asarray(t.numpy()), params)
        tokens, embeds = _inputs(cfg)
        logits, generated = _single_device(cfg, params, tokens, embeds)
        n_pre = 0 if embeds is None or cfg.encoder_only else embeds.shape[1]
        refs[arch] = {
            "case": {"kind": "serve", "arch": arch, "params": params,
                     "prompt": tokens, "embeds": embeds, "new": NEW,
                     "max_len": n_pre + PROMPT + NEW},
            "logits": logits, "tokens": generated,
            "jax": _jax_logits(jcfg, jparams, tokens, embeds, generated)}
    cfg = configs.smoke_config(PAGED["arch"])
    params = refs[PAGED["arch"]]["case"]["params"]
    tokens = refs[PAGED["arch"]]["case"]["prompt"][:, :PAGED["prompt"]]
    logits, generated = _paged_single(cfg, params, tokens, _pages())
    refs["paged"] = {
        "case": {"kind": "serve", "arch": PAGED["arch"], "params": params,
                 "prompt": tokens, "new": NEW, "paged": True,
                 "max_len": PAGED["prompt"] + NEW,
                 "page_size": PAGED["page_size"], "pages": _pages()},
        "logits": logits, "tokens": generated}
    return refs


def _world(axes, refs, tmp_path_factory, paged):
    cases = {(arch, f): dict(refs[arch]["case"], flags=flags)
             for arch in configs.ARCHS for f, flags in FLAGS.items()}
    if paged:
        cases[("paged", "default")] = refs["paged"]["case"]
    return spawn_world(axes, cases, tmp_path_factory.mktemp("world"),
                       timeout=WORLD_TIMEOUT)


@pytest.fixture(scope="module")
def world_a(references, tmp_path_factory):
    return _world(smoke_axes(2, 4), references, tmp_path_factory, True)


@pytest.fixture(scope="module")
def world_b(references, tmp_path_factory):
    return _world(smoke_axes(2, 2, pods=2), references, tmp_path_factory,
                  False)


def _check(got, ref, arch):
    if ref["tokens"] is not None:
        assert torch.equal(got["tokens"], ref["tokens"])
    assert len(got["logits"]) == len(ref["logits"])
    for step, (g, want) in enumerate(zip(got["logits"], ref["logits"])):
        torch.testing.assert_close(g, want, atol=ATOL, rtol=0,
                                   msg=lambda m: f"step {step}: {m}")
        if "jax" in ref:
            np.testing.assert_allclose(
                g.numpy(), ref["jax"] if configs.smoke_config(
                    arch).encoder_only else ref["jax"][step], atol=ATOL,
                err_msg=f"step {step} against JAX")


@pytest.mark.parametrize("flags", sorted(FLAGS))
@pytest.mark.parametrize("arch", configs.ARCHS)
def test_world_a_serves_as_one_device(world_a, references, arch, flags):
    _check(world_a[(arch, flags)], references[arch], arch)


@pytest.mark.parametrize("flags", sorted(FLAGS))
@pytest.mark.parametrize("arch", configs.ARCHS)
def test_world_b_serves_as_one_device(world_b, references, arch, flags):
    _check(world_b[(arch, flags)], references[arch], arch)


def test_paged_step_with_replicated_pools(world_a, references):
    _check(world_a[("paged", "default")], references["paged"], "gemma3_1b")
