"""The port's sharded train step on CPU worlds of gloo ranks, held to the
port's single-device step and to the JAX reference's single-device loss.

The reference's own sharded program cannot be the oracle here (its
``tests/island_check.py`` stops in ``repro/models/layers.py:96`` on this
jax, ``ROADMAP.md`` Queue 3). One world of 8 ranks on island_check's
(pod=2, data=2, model=2) mesh runs its eight archs; one of 4 ranks on
(data=2, model=2) runs moonshot, so that the single-FSDP-axis branch runs
too. The ranks are processes spawned by ``tests/_torch_sharded_worker.py``
(a ``FileStore`` under the test's temporary directory; every world has its
own timeout). Per arch, on island_check's batch (4 x 32) and the JAX
state of ``PRNGKey(0)``:

* the sharded loss within 1e-5 relative of the port's single-device loss
  and of JAX's (island_check's own limit is 2e-3). A MoE's router aux loss
  is, in the sharded program as in the reference's island, the mean over
  the batch shards of each shard's aux (``repro/sharding/context.py:153``),
  not the aux of the whole batch: for the two MoE archs the comparison with
  the single-device steps is of the cross-entropy and z-loss, and the whole
  loss is held to the single-device port on that definition
  (:func:`_shard_reference`);
* the params and optimizer state after one step, gathered, against the
  single-device step on the same loss at ``tests/test_torch_train.py``'s
  1e-5 (its Adam eps 1e-5);
* every rank's local shard shapes exactly as ``resolve_spec`` gives them,
  and the elements each rank holds their sum: no rank holds the whole tree;
* one step with ``remat="full"`` and ``microbatch=2`` together.

A world of one rank runs the single-device step's operations in the same
order, so there bf16 params with a float32 master (what a user trains
with) are held to the single-device port bit for bit over three steps: a
bf16 step rounds every param from its master, so a float32 rounding
difference in a gradient grows into a loss difference after a step or two
(a loss island computed apart from ``lm_loss`` once drifted so on the
card). The MoE archs are left out there: even on one rank their float32
gradients differ from the single-device step's by about 1e-7 relative.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_sharded_worker import spawn_world
from repro import configs as jax_configs
from repro.train import init_train_state as jax_init_train_state
from repro.train.step import _loss_fn as jax_loss_fn
from repro_torch import configs
from repro_torch.convert import tree_to_torch
from repro_torch.launch.mesh import smoke_axes
from repro_torch.models import forward
from repro_torch.optim import OptimizerConfig, adamw_update, lr_at_step
from repro_torch.sharding import DistContext
from repro_torch.train import (TrainState, init_train_state, lm_loss,
                               make_train_step)
from repro_torch.tree import leaves, unflatten_as

# tests/test_torch_train.py::STEP_OPT (eps 1e-5: see the note there)
STEP_OPT = dict(lr=2e-3, eps=1e-5, warmup_steps=2, total_steps=10,
                weight_decay=0.1, schedule="cosine")
ATOL = 1e-5
ARCHS = ("moonshot_v1_16b_a3b", "gemma3_1b", "mamba2_130m",
         "recurrentgemma_2b", "deepseek_v3_671b", "hubert_xlarge",
         "internvl2_1b", "stablelm_1_6b")        # tests/island_check.py's
KNOBS = {"step": {}, "remat_microbatch": {"remat": "full", "microbatch": 2}}
BF16_ARCHS = tuple(a for a in ARCHS
                   if configs.smoke_config(a).moe is None)
BF16_STEPS = 3
B, S = 4, 32
WORLD_TIMEOUT = 600.0


def _batch(cfg, seed=0):
    """tests/island_check.py's batch (its seed 0)."""
    rng = np.random.RandomState(seed)
    if cfg.frontend is not None and cfg.frontend.kind == "audio_frames":
        out = {"embeds": rng.randn(B, S, cfg.frontend.input_dim),
               "labels": rng.randint(0, cfg.vocab_size, (B, S))}
    elif cfg.frontend is not None:
        out = {"embeds": rng.randn(B, cfg.frontend.n_positions,
                                   cfg.frontend.input_dim),
               "tokens": rng.randint(0, cfg.vocab_size, (B, S)),
               "labels": rng.randint(0, cfg.vocab_size, (B, S))}
    else:
        out = {"tokens": rng.randint(0, cfg.vocab_size, (B, S)),
               "labels": rng.randint(0, cfg.vocab_size, (B, S))}
    return {k: torch.from_numpy(v.astype(np.float32 if k == "embeds"
                                         else np.int32))
            for k, v in out.items()}


def _jax_state(arch):
    jcfg = jax_configs.smoke_config(arch)
    from repro.optim import OptimizerConfig as JaxOptimizerConfig
    return jcfg, jax_init_train_state(jcfg, JaxOptimizerConfig(**STEP_OPT),
                                      jax.random.PRNGKey(0))


def _port_state(js) -> TrainState:
    return TrainState(tree_to_torch(jax.tree.map(np.asarray, js.params),
                                    "cpu"),
                      tree_to_torch(jax.tree.map(np.asarray, js.opt), "cpu"),
                      torch.tensor(int(js.step), dtype=torch.int32))


def _n_shards(axes: dict, batch: int) -> int:
    """How many shards the sharded program cuts a batch of ``batch`` rows
    into (its batch_spec)."""
    spec = DistContext(axes).batch_pspec(2, batch)[0]
    names = () if spec is None else ((spec,) if isinstance(spec, str)
                                     else spec)
    n = 1
    for a in names:
        n *= axes[a]
    return n


def _shard_reference(cfg, ocfg, state, batch, axes, microbatch):
    """The single-device port on the loss the sharded program defines:
    each microbatch's logits from the forward of each of its batch shards
    (a MoE's capacity and aux are per shard), the cross-entropy over the
    microbatch, the aux the mean of the shards'; then the train step's
    AdamW update. Returns (loss, new params and opt)."""
    aux_w = cfg.moe.router_aux_weight if cfg.moe is not None else 0.0
    flat = [p.detach().requires_grad_(True) for p in leaves(state.params)]
    params = unflatten_as(state.params, flat)
    mb = microbatch or 1
    total, grads = 0.0, None
    for part in range(mb):
        rows = {k: v.chunk(mb)[part] for k, v in batch.items()}
        n = _n_shards(axes, rows["labels"].shape[0])
        outs = [forward(params, cfg, {k: v.chunk(n)[i]
                                      for k, v in rows.items()})
                for i in range(n)]
        logits = torch.cat([o[0] for o in outs])
        aux = sum(o[2] for o in outs) / n
        loss, _ = lm_loss(logits, rows["labels"])
        loss = loss + aux_w * aux
        g = torch.autograd.grad(loss, flat, allow_unused=True,
                                materialize_grads=True)
        grads = g if grads is None else [a + b for a, b in zip(grads, g)]
        total = total + float(loss.detach())
    grads = unflatten_as(state.params, [g / mb for g in grads])
    lr = lr_at_step(state.step, base_lr=ocfg.lr,
                    warmup_steps=ocfg.warmup_steps,
                    total_steps=ocfg.total_steps, schedule=ocfg.schedule)
    new_p, new_opt, _ = adamw_update(state.params, grads, state.opt, ocfg,
                                     lr)
    return total / mb, (new_p, new_opt)


def _run_world(axes, archs, tmp_path_factory):
    cases, refs = {}, {}
    for arch in archs:
        jcfg, js = _jax_state(arch)
        cfg, st = configs.smoke_config(arch), _port_state(js)
        batch = _batch(cfg)
        aux_w = cfg.moe.router_aux_weight if cfg.moe is not None else 0.0
        jloss, jm = jax.jit(lambda p, b: jax_loss_fn(
            p, jcfg, b, None, "none", aux_w))(
            js.params, jax.tree.map(jnp.asarray, {
                k: v.numpy() for k, v in batch.items()}))
        o = OptimizerConfig(**STEP_OPT)
        _, single = make_train_step(cfg, o)(st, batch)
        for kname, knobs in KNOBS.items():
            cases[(arch, kname)] = {"arch": arch, "state": st,
                                    "batch": batch, "knobs": knobs,
                                    "opt": STEP_OPT}
            loss, new = _shard_reference(cfg, o, st, batch, axes,
                                         knobs.get("microbatch"))
            refs[(arch, kname)] = {
                "jax": {"loss": float(jloss), "ce": float(jm["ce"]),
                        "z_loss": float(jm["z_loss"])},
                "single": {k: float(v) for k, v in single.items()},
                "shard_loss": loss, "state": new}
    got = spawn_world(axes, cases, tmp_path_factory.mktemp("world"),
                      timeout=WORLD_TIMEOUT)
    return got, refs


@pytest.fixture(scope="module")
def world8(tmp_path_factory):
    return _run_world(smoke_axes(2, 2, pods=2), ARCHS, tmp_path_factory)


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    return _run_world(smoke_axes(2, 2), ("moonshot_v1_16b_a3b",),
                      tmp_path_factory)


def _rel(a, b):
    return abs(a - b) / max(abs(b), 1e-9)


def _check_loss(got, ref, arch):
    m = got["metrics"]
    keys = ("ce", "z_loss") if configs.smoke_config(arch).moe is not None \
        else ("loss", "ce", "z_loss")
    for k in keys:
        assert _rel(m[k], ref["single"][k]) <= ATOL, (k, m[k],
                                                      ref["single"][k])
        assert _rel(m[k], ref["jax"][k]) <= ATOL, (k, m[k], ref["jax"][k])
    assert _rel(m["loss"], ref["shard_loss"]) <= ATOL


def _check_state(got, ref):
    for a, b in zip(leaves((got["params"], got["opt"])), leaves(ref["state"])):
        np.testing.assert_allclose(a.numpy(), b.detach().numpy(), atol=ATOL)


def _check_shards(got):
    for bad, _ in got["ranks"]:
        assert bad == []
    held = [n for _, n in got["ranks"]]
    assert all(n == got["want_resident"] for n in held)
    assert max(held) < got["whole"]


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_loss_matches_single_device_and_jax(world8, arch):
    got, refs = world8
    _check_loss(got[(arch, "step")], refs[(arch, "step")], arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_step_params_match_single_device(world8, arch):
    got, refs = world8
    _check_state(got[(arch, "step")], refs[(arch, "step")])


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_state_stays_sharded(world8, arch):
    _check_shards(world8[0][(arch, "step")])


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_remat_microbatch_step(world8, arch):
    got, refs = world8
    g, r = got[(arch, "remat_microbatch")], refs[(arch, "remat_microbatch")]
    assert _rel(g["metrics"]["loss"], r["shard_loss"]) <= ATOL
    _check_state(g, r)


@pytest.mark.parametrize("knobs", sorted(KNOBS))
def test_four_rank_world_moonshot(world4, knobs):
    got, refs = world4
    g, r = got[("moonshot_v1_16b_a3b", knobs)], \
        refs[("moonshot_v1_16b_a3b", knobs)]
    if knobs == "step":
        _check_loss(g, r, "moonshot_v1_16b_a3b")
    assert _rel(g["metrics"]["loss"], r["shard_loss"]) <= ATOL
    _check_state(g, r)
    _check_shards(g)


@pytest.fixture(scope="module")
def world1_bf16(tmp_path_factory):
    """BF16_STEPS steps of bf16 params with a float32 master on a world of
    one rank, beside the single-device port's steps from the same state."""
    o = OptimizerConfig(**STEP_OPT)
    cases, refs = {}, {}
    for arch in BF16_ARCHS:
        cfg = configs.smoke_config(arch).with_(dtype="bfloat16")
        st = init_train_state(cfg, o, torch.Generator().manual_seed(0),
                              "cpu")
        batches = [_batch(cfg, seed) for seed in range(BF16_STEPS)]
        cases[arch] = {"arch": arch, "cfg": {"dtype": "bfloat16"},
                       "state": st, "batches": batches, "knobs": {},
                       "opt": STEP_OPT}
        step, new, losses = make_train_step(cfg, o), st, []
        for b in batches:
            new, m = step(new, b)
            losses.append(float(m["loss"]))
        refs[arch] = {"losses": losses, "state": (new.params, new.opt)}
    got = spawn_world({"data": 1, "model": 1}, cases,
                      tmp_path_factory.mktemp("world1"),
                      timeout=WORLD_TIMEOUT)
    return got, refs


@pytest.mark.parametrize("arch", BF16_ARCHS)
def test_world_of_one_bf16_steps_equal_single_device(world1_bf16, arch):
    got, refs = world1_bf16
    g, r = got[arch], refs[arch]
    assert g["losses"] == r["losses"]
    assert "master" in g["opt"]
    got_leaves, want_leaves = leaves((g["params"], g["opt"])), \
        leaves(r["state"])
    assert len(got_leaves) == len(want_leaves)
    for a, b in zip(got_leaves, want_leaves):
        assert a.dtype == b.dtype and torch.equal(a, b)
