"""Activation checkpointing (``remat``) in the port against the JAX
reference, on the CPU.

* Per policy ("full", "dots", "dots_no_batch") and smoke config (gemma3:
  two 3-layer periods and two tail layers; mamba2: the SSD scan; moonshot:
  the MoE's aux loss leaving each checkpointed period): the loss and every
  gradient against ``jax.grad`` of the reference's ``_loss_fn`` with the
  same policy, and one ``make_train_step`` step (metrics and every param
  and optimizer leaf) against the reference's AdamW update of those
  gradients, at ``tests/test_torch_train.py``'s 1e-5.
* The bytes that one gemma3 forward leaves alive for its backward (every
  storage an op makes, followed by weak reference): "full" <=
  "dots_no_batch" <= "dots" < "none".
* An unknown policy raises ``KeyError``, as the reference's lookup does.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.multiprocessing.reductions import StorageWeakRef
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from repro import configs as jax_configs
from repro.data import batch_at as jax_batch_at
from repro.optim import OptimizerConfig as JaxOptimizerConfig
from repro.optim import adamw_update as jax_adamw_update
from repro.optim import lr_at_step as jax_lr_at_step
from repro.train import init_train_state as jax_init_train_state
from repro.train.step import _loss_fn as jax_loss_fn
from repro_torch import configs
from repro_torch.convert import tree_to_torch
from repro_torch.models import forward
from repro_torch.optim import OptimizerConfig
from repro_torch.train import TrainState, make_train_step
from repro_torch.train.step import _loss_fn
from repro_torch.tree import leaves, unflatten_as

# tests/test_torch_train.py::STEP_OPT (eps 1e-5: see the note there)
STEP_OPT = dict(lr=2e-3, eps=1e-5, warmup_steps=2, total_steps=10,
                weight_decay=0.1, schedule="cosine")
ATOL = 1e-5
POLICIES = ("full", "dots", "dots_no_batch")
ARCHS = ("gemma3_1b", "mamba2_130m", "moonshot_v1_16b_a3b")


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _setup(arch):
    jcfg, cfg = jax_configs.smoke_config(arch), configs.smoke_config(arch)
    jo, o = JaxOptimizerConfig(**STEP_OPT), OptimizerConfig(**STEP_OPT)
    js = jax_init_train_state(jcfg, jo, jax.random.PRNGKey(0))
    ts = TrainState(tree_to_torch(jax.tree.map(np.asarray, js.params), "cpu"),
                    tree_to_torch(jax.tree.map(np.asarray, js.opt), "cpu"),
                    torch.tensor(int(js.step), dtype=torch.int32))
    b = jax_batch_at(jcfg, 0, 0, batch=4, seq=64)
    return jcfg, cfg, jo, o, js, ts, b


def test_gemma3_smoke_has_periods_and_a_tail():
    cfg = configs.smoke_config("gemma3_1b")
    assert (cfg.n_periods, cfg.period, cfg.n_remainder) == (2, 3, 2)


@functools.lru_cache(maxsize=None)
def _reference(arch, policy):
    """The reference's loss, metrics and gradients under ``policy`` (one
    jitted ``value_and_grad`` of its ``_loss_fn``) and its train step's
    AdamW update on them, as ``make_train_step`` composes them."""
    jcfg, cfg, jo, _, js, _, b = _setup(arch)
    aux_w = cfg.moe.router_aux_weight if cfg.moe is not None else 0.0
    jb = jax.tree.map(jnp.asarray, b)
    (jloss, jm), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jax_loss_fn(p, jcfg, jb, None, policy, aux_w),
        has_aux=True))(js.params)
    lr = jax_lr_at_step(js.step, base_lr=jo.lr, warmup_steps=jo.warmup_steps,
                        total_steps=jo.total_steps, schedule=jo.schedule)
    params, opt, stats = jax_adamw_update(js.params, jgrads, js.opt, jo, lr)
    return dict(jm, loss=jloss, **stats), jgrads, (params, opt)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("policy", POLICIES)
def test_remat_loss_and_grads_match_reference(arch, policy):
    _, cfg, _, _, _, ts, b = _setup(arch)
    jm, jgrads, _ = _reference(arch, policy)
    aux_w = cfg.moe.router_aux_weight if cfg.moe is not None else 0.0
    flat = [p.detach().requires_grad_(True) for p in leaves(ts.params)]
    loss, metrics = _loss_fn(unflatten_as(ts.params, flat), cfg,
                             {k: torch.from_numpy(v) for k, v in b.items()},
                             aux_w, remat=policy)
    grads = torch.autograd.grad(loss, flat, allow_unused=True,
                                materialize_grads=True)
    np.testing.assert_allclose(float(loss.detach()), float(jm["loss"]),
                               atol=ATOL, rtol=ATOL)
    np.testing.assert_allclose(float(metrics["aux_loss"].detach()),
                               float(jm["aux_loss"]), atol=ATOL)
    for (name, want), got in zip(jax.tree_util.tree_flatten_with_path(
            jgrads)[0], grads):
        np.testing.assert_allclose(_np(got), _np(want), atol=ATOL,
                                   err_msg=jax.tree_util.keystr(name))


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("policy", POLICIES)
def test_remat_train_step_matches_reference(arch, policy):
    _, cfg, _, o, _, ts, b = _setup(arch)
    jm, _, jstate = _reference(arch, policy)
    ts, tm = make_train_step(cfg, o, remat=policy)(
        ts, {k: torch.from_numpy(v) for k, v in b.items()})
    for k in ("loss", "grad_norm", "lr", "ce", "z_loss", "aux_loss"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), atol=ATOL,
                                   rtol=ATOL, err_msg=k)
    for (name, a), t in zip(jax.tree_util.tree_flatten_with_path(
            jstate)[0], leaves((ts.params, ts.opt))):
        np.testing.assert_allclose(_np(t), _np(a), atol=ATOL,
                                   err_msg=jax.tree_util.keystr(name))


class _Allocations(TorchDispatchMode):
    """Every storage an op outputs while the mode is on, by weak
    reference: after the forward, the ones still alive are what the
    forward left for the backward (saved tensors, a checkpoint's inputs,
    a selective checkpoint's cache) besides its outputs."""

    def __init__(self):
        super().__init__()
        self.refs = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in tree_leaves(out):
            if isinstance(t, torch.Tensor) and t.device.type == "cpu":
                st = t.untyped_storage()
                self.refs[st.data_ptr()] = (StorageWeakRef(st), st.nbytes())
        return out

    def alive(self) -> int:
        return sum(n for ref, n in self.refs.values() if not ref.expired())


def _saved_bytes(policy: str) -> int:
    """Bytes one gemma3 smoke forward keeps alive for its backward. (A
    ``saved_tensors_hooks`` pack hook alone cannot count them: inside a
    checkpointed region the checkpoint's own hooks take over, and a
    selective checkpoint caches its saved outputs outside the hooks.)"""
    from repro_torch.models.params import init_params
    from repro_torch.models.transformer import model_spec
    cfg = configs.smoke_config("gemma3_1b")
    gen = torch.Generator().manual_seed(0)
    params = init_params(model_spec(cfg), gen, torch.float32, "cpu")
    flat = [p.requires_grad_(True) for p in leaves(params)]
    tokens = torch.randint(0, cfg.vocab_size, (4, 64), generator=gen)
    mode = _Allocations()
    with mode:
        logits, _, _ = forward(unflatten_as(params, flat), cfg,
                               {"tokens": tokens}, remat=policy)
    held = mode.alive() - logits.untyped_storage().nbytes()
    logits.float().square().mean().backward()
    return held


def test_remat_saves_fewer_bytes():
    got = {p: _saved_bytes(p) for p in ("none", "full", "dots_no_batch",
                                        "dots")}
    print("saved bytes for the backward:", got)
    assert got["full"] <= got["dots_no_batch"] <= got["dots"] < got["none"]
    assert got["full"] < got["none"]


def test_unknown_remat_policy_raises_key_error():
    cfg, o = configs.smoke_config("gemma3_1b"), OptimizerConfig()
    with pytest.raises(KeyError):
        make_train_step(cfg, o, remat="everything")
    with pytest.raises(KeyError):
        forward({}, cfg, {"tokens": torch.zeros((1, 4), dtype=torch.int32)},
                remat="everything")
