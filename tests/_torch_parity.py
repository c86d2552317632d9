"""Helpers the port's model-family parity tests share (CPU only; imports
both packages): JAX smoke weights carried across, the per-slot decode
schedule of ``tests/test_torch_models.py`` (dense, ring and paged), the
JAX engine's greedy tokens, and three train steps of both packages.
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro import configs as jax_configs
from repro.data import batch_at as jax_batch_at
from repro.models import init_params as jax_init_params
from repro.models import model_spec as jax_model_spec
from repro.models.transformer import forward as jax_forward
from repro.models.transformer import init_caches as jax_init_caches
from repro.models.transformer import init_paged_caches as jax_init_paged
from repro.optim import OptimizerConfig as JaxOptimizerConfig
from repro.serve import ServeEngine as JaxEngine
from repro.train import init_train_state as jax_init_train_state
from repro.train import make_train_step as jax_make_train_step
from repro_torch import configs
from repro_torch.convert import tree_to_torch
from repro_torch.models import forward
from repro_torch.models.transformer import init_caches, init_paged_caches
from repro_torch.optim import OptimizerConfig
from repro_torch.serve import PageAllocator
from repro_torch.train import TrainState, make_train_step
from repro_torch.tree import leaves

ATOL = 2e-5          # logits, as tests/test_torch_models.py
STEP_ATOL = 1e-5     # three train steps, as tests/test_torch_train.py
# tests/test_torch_train.py::STEP_OPT (eps 1e-5: see the note there)
STEP_OPT = dict(lr=2e-3, eps=1e-5, warmup_steps=2, total_steps=10,
                weight_decay=0.1, schedule="cosine")


def to_torch(tree):
    return tree_to_torch(jax.tree.map(np.asarray, tree), "cpu")


def close(got, want, atol=ATOL):
    """A port tensor against a JAX (or numpy) array."""
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=atol)


def prompts(seed, lengths, vocab=512):
    """Request prompts of the given lengths (the smoke configs' vocab)."""
    rng = np.random.RandomState(seed)
    return [[int(t) for t in rng.randint(0, vocab, n)] for n in lengths]


def jax_weights(arch, seed=1):
    """(JAX smoke config, JAX float32 weights, port config, the weights
    carried across)."""
    jcfg = jax_configs.smoke_config(arch)
    jparams = jax_init_params(jax_model_spec(jcfg), jax.random.PRNGKey(seed),
                              jnp.float32)
    return jcfg, jparams, configs.smoke_config(arch), to_torch(jparams)


def whole_sequence_error(model, tokens):
    jcfg, jparams, cfg, params = model
    want, _, jaux = jax_forward(jparams, jcfg,
                                {"tokens": jnp.asarray(tokens, jnp.int32)})
    got, caches, aux = forward(params, cfg,
                               {"tokens": torch.from_numpy(tokens)})
    assert caches is None
    np.testing.assert_allclose(float(aux), float(jaux), atol=1e-6)
    return float(np.abs(got.numpy() - np.asarray(want)).max()), got


def schedule(vocab, steps, start, max_len, page_size, paged, seed=1):
    """Per step: tokens (2, 1), per-slot positions and the page table
    (``tests/test_torch_models.py``'s, with ragged starts ``start``)."""
    tokens = np.random.RandomState(seed).randint(0, vocab, (2, steps))
    alloc = PageAllocator(2 * (max_len // page_size) + 1, page_size, 2,
                          max_len // page_size)
    for t in range(steps):
        pos = np.asarray(start, np.int32) + t
        table = None
        if paged:
            for i in range(2):
                assert alloc.ensure(i, int(pos[i]))
            table = alloc.table.copy()
        yield tokens[:, t:t + 1], pos, table


def decode_errors(model, *, paged, kernels, steps, start, max_len,
                  page_size=8):
    """Max |port - JAX| over the logits of every decode step, per port
    decode kernel; the JAX side jitted, chunked."""
    jcfg, jparams, cfg, params = model
    sched = list(schedule(cfg.vocab_size, steps, start, max_len, page_size,
                          paged))
    if paged:
        jc = jax_init_paged(jcfg, 2, max_len, jnp.float32,
                            page_size=page_size)
    else:
        jc = jax_init_caches(jcfg, 2, max_len, jnp.float32)

    @jax.jit
    def step(p, tok, caches, idx, pages):
        logits, new, _ = jax_forward(p, jcfg, {"tokens": tok}, caches=caches,
                                     cache_index=idx, pages=pages)
        return logits, new

    want = []
    for tok, pos, table in sched:
        logits, jc = step(jparams, jnp.asarray(tok, jnp.int32), jc,
                          jnp.asarray(pos),
                          None if table is None else jnp.asarray(table))
        want.append(np.asarray(logits))
    errs = {}
    for kernel in kernels:
        if paged:
            caches = init_paged_caches(cfg, 2, max_len, torch.float32,
                                       page_size=page_size, device="cpu")
        else:
            caches = init_caches(cfg, 2, max_len, torch.float32, "cpu")
        tcfg = cfg.with_(decode_kernel=kernel)
        err = 0.0
        for (tok, pos, table), w in zip(sched, want):
            got, caches, _ = forward(params, tcfg,
                                     {"tokens": torch.from_numpy(tok)},
                                     caches=caches,
                                     cache_index=torch.from_numpy(pos),
                                     pages=None if table is None
                                     else torch.from_numpy(table))
            err = max(err, float(np.abs(got.numpy() - w).max()))
        errs[kernel] = err
    return errs


def jax_engine_tokens(jcfg, jparams, reqs, max_len=96):
    """The JAX engine's greedy tokens (chunked decode, 8 slots)."""
    eng = JaxEngine(jcfg, jparams, n_slots=8, max_len=max_len,
                    decode_kernel="chunked")
    out = eng.run_until_drained([(rid, list(p), n) for rid, p, n in reqs])
    assert set(out) == {rid for rid, _, _ in reqs}
    return out


def train_steps_match(arch, steps=3, batch=4, seq=64):
    """Three ``make_train_step`` steps of both packages from one
    JAX-initialised state, held within STEP_ATOL: the metrics (the MoE's
    aux loss among them) at every step, then every param and optimizer
    leaf."""
    jcfg, cfg = jax_configs.smoke_config(arch), configs.smoke_config(arch)
    jo, o = JaxOptimizerConfig(**STEP_OPT), OptimizerConfig(**STEP_OPT)
    js = jax_init_train_state(jcfg, jo, jax.random.PRNGKey(0))
    ts = TrainState(to_torch(js.params), to_torch(js.opt),
                    torch.tensor(int(js.step), dtype=torch.int32))
    jstep = jax.jit(jax_make_train_step(jcfg, jo))
    tstep = make_train_step(cfg, o)
    for s in range(steps):
        b = jax_batch_at(jcfg, 0, s, batch=batch, seq=seq)
        js, jm = jstep(js, jax.tree.map(jnp.asarray, b))
        ts, tm = tstep(ts, {k: torch.from_numpy(v) for k, v in b.items()})
        for k in ("loss", "grad_norm", "lr", "ce", "z_loss", "aux_loss"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                       atol=STEP_ATOL, rtol=STEP_ATOL,
                                       err_msg=k)
    assert int(ts.step) == steps
    for (name, a), b in zip(jax.tree_util.tree_flatten_with_path(
            (js.params, js.opt))[0], leaves((ts.params, ts.opt))):
        np.testing.assert_allclose(b.detach().float().numpy(), np.asarray(a),
                                   atol=STEP_ATOL, err_msg=str(
                                       jax.tree_util.keystr(name)))
    return jm
