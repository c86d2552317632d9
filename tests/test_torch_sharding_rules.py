"""The port's sharding rules, state axes and train knobs against the
reference's, exactly, with no process group.

Every config of ``configs.ARCHS`` at full size, on the two production
meshes — (data=16, model=16) and (pod=2, data=16, model=16) — and the
(pod=2, data=2, model=2) smoke mesh of ``tests/island_check.py``. The JAX
side runs on ``jax.sharding.AbstractMesh`` (pure: no devices), the port's
on the same axis name → size mapping (``repro_torch.launch.mesh``):

* ``resolve_spec`` of every leaf of the train state under
  ``optimizer_for(cfg)`` (deepseek's factored bf16 moments without a
  master copy among them), through ``state_axes`` and ``param_shardings``;
* ``params_axes``, ``state_axes`` and ``cache_axes`` leaf by leaf;
* ``batch_spec`` at batch sizes 1, 4 and 256;
* ``train_knobs``, ``resolve_knobs``, ``optimizer_for`` and
  ``optimizer_analytic_costs``;
* ``to_placements`` on specs with a dim over two mesh axes.
"""
import dataclasses

import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import AbstractMesh

from repro import configs as jax_configs
from repro.launch import specs as jax_specs
from repro.models.transformer import cache_shapes as jax_cache_shapes
from repro.sharding import DistContext as JaxDistContext
from repro.sharding import cache_axes as jax_cache_axes
from repro.sharding import params_axes as jax_params_axes
from repro.sharding import state_axes as jax_state_axes
from repro.sharding.rules import batch_spec as jax_batch_spec
from repro.sharding.rules import resolve_spec as jax_resolve_spec
from repro.train.step import train_state_shapes as jax_train_state_shapes
from repro_torch import configs
from repro_torch.launch import mesh_axes, smoke_axes
from repro_torch.launch import specs
from repro_torch.models.transformer import cache_shapes
from repro_torch.sharding import (DistContext, P, batch_spec, cache_axes,
                                  params_axes, resolve_spec, state_axes,
                                  to_placements)
from repro_torch.train import train_state_shapes
from repro_torch.tree import flatten_up_to, leaves

MESHES = {
    "single_pod": mesh_axes(multi_pod=False),
    "multi_pod": mesh_axes(multi_pod=True),
    "smoke": smoke_axes(2, 2, pods=2),
}
CASES = [(a, m) for a in configs.ARCHS for m in MESHES]


def _jax_mesh(axes: dict) -> AbstractMesh:
    return AbstractMesh(tuple(axes.values()), tuple(axes))


def _dists(mesh_name):
    axes = MESHES[mesh_name]
    return JaxDistContext(_jax_mesh(axes)), DistContext(axes)


def _state_pairs(arch):
    """(port shape leaves, port axes leaves, JAX shape leaves, JAX axes
    leaves) of the train state under ``optimizer_for``."""
    cfg, jcfg = configs.get_config(arch), jax_configs.get_config(arch)
    ocfg, jocfg = specs.optimizer_for(cfg), jax_specs.optimizer_for(jcfg)
    shapes = train_state_shapes(cfg, ocfg)
    jshapes = jax_train_state_shapes(jcfg, jocfg)
    jleaves, jdef = jax.tree.flatten(jshapes)
    return (leaves(shapes), flatten_up_to(shapes, state_axes(cfg, ocfg)),
            jleaves, jdef.flatten_up_to(jax_state_axes(jcfg, jocfg)))


@pytest.mark.parametrize("arch,mesh", CASES)
def test_state_specs_match_reference(arch, mesh):
    jd, d = _dists(mesh)
    shapes, axes, jshapes, jaxes = _state_pairs(arch)
    assert len(shapes) == len(jshapes)
    assert [tuple(s.shape) for s in shapes] == [tuple(s.shape)
                                                for s in jshapes]
    assert [None if a is None else tuple(a) for a in axes] == \
        [None if a is None else tuple(a) for a in jaxes]
    got = [
        P() if a is None else resolve_spec(tuple(a), tuple(s.shape), d.mesh,
                                           fsdp_axes=d.fsdp_axes)
        for s, a in zip(shapes, axes)]
    want = [() if a is None else jax_resolve_spec(
        tuple(a), tuple(s.shape), jd.mesh, fsdp_axes=jd.fsdp_axes)
        for s, a in zip(jshapes, jaxes)]
    assert got == want
    # the same through DistContext.param_shardings
    cfg = configs.get_config(arch)
    ocfg = specs.optimizer_for(cfg)
    tree = d.param_shardings(train_state_shapes(cfg, ocfg),
                             state_axes(cfg, ocfg))
    from repro_torch.sharding.context import _spec_leaves
    assert _spec_leaves(tree) == got


@pytest.mark.parametrize("arch", configs.ARCHS)
def test_params_and_cache_axes_match_reference(arch):
    cfg, jcfg = configs.get_config(arch), jax_configs.get_config(arch)
    got = flatten_up_to(train_state_shapes(cfg, specs.optimizer_for(cfg))
                        .params, params_axes(cfg))
    jtree = jax_params_axes(jcfg)
    want = jax.tree.leaves(jtree, is_leaf=lambda x: isinstance(x, tuple))
    assert [tuple(a) for a in got] == [tuple(a) for a in want]
    caches = cache_shapes(cfg, 2, 64, torch.float32)
    got = flatten_up_to(caches, cache_axes(caches))
    jcaches = jax_cache_shapes(jcfg, 2, 64, jnp.float32)
    want = jax.tree.leaves(jax_cache_axes(jcaches),
                           is_leaf=lambda x: isinstance(x, tuple))
    assert [tuple(a) for a in got] == [tuple(a) for a in want]


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("batch", [1, 4, 256])
def test_batch_spec_matches_reference(mesh, batch):
    jd, d = _dists(mesh)
    for ndim in (1, 2, 3, 4):
        want = jax_batch_spec(ndim, jd.batch_axes, batch, jd.mesh)
        got = batch_spec(ndim, d.batch_axes, batch, d.mesh)
        assert got == want
        assert d.batch_pspec(ndim, batch) == jd.batch_pspec(ndim, batch)
    assert (d.fsdp_axes, d.batch_axes, d.tp_size, d.n_devices) == \
        (jd.fsdp_axes, jd.batch_axes, jd.tp_size, jd.n_devices)


@pytest.mark.parametrize("arch,mesh", CASES)
def test_knobs_and_optimizer_match_reference(arch, mesh):
    jd, d = _dists(mesh)
    cfg, jcfg = configs.get_config(arch), jax_configs.get_config(arch)
    assert specs.train_knobs(cfg) == jax_specs.train_knobs(jcfg)
    for gb in (1, 8, 32, 256):
        assert specs.resolve_knobs(cfg, d, gb) == \
            jax_specs.resolve_knobs(jcfg, jd, gb)
    assert specs.resolve_knobs(cfg, d, 256, {"microbatch": 3}) == \
        jax_specs.resolve_knobs(jcfg, jd, 256, {"microbatch": 3})
    ocfg, jocfg = specs.optimizer_for(cfg), jax_specs.optimizer_for(jcfg)
    assert dataclasses.asdict(ocfg) == dataclasses.asdict(jocfg)
    for accum in ("float32", "bfloat16"):
        assert specs.optimizer_analytic_costs(cfg, ocfg, accum, d.n_devices) \
            == jax_specs.optimizer_analytic_costs(jcfg, jocfg, accum,
                                                  jd.n_devices)
    batch = specs.batch_specs(cfg, 256, 4096)
    jbatch = jax_specs.batch_specs(jcfg, 256, 4096)
    assert {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
            for k, v in batch.items()} == \
        {k: (tuple(v.shape), str(v.dtype)) for k, v in jbatch.items()}
    got = specs.batch_shardings(d, batch, 256)
    assert got == {k: jd.batch_pspec(v.ndim, 256) for k, v in jbatch.items()}
    assert specs.reduced_depth(cfg, 2).n_layers == \
        jax_specs.reduced_depth(jcfg, 2).n_layers


def test_to_placements():
    from torch.distributed.tensor import Replicate, Shard
    names = ("pod", "data", "model")
    assert to_placements(P(("pod", "data"), None, "model"), names) == (
        Shard(0), Shard(0), Shard(2))
    assert to_placements(P(None, ("pod", "data")), names) == (
        Shard(1), Shard(1), Replicate())
    assert to_placements(P("data", "model"), ("data", "model")) == (
        Shard(0), Shard(1))
    assert to_placements(P(), names) == (Replicate(),) * 3
    with pytest.raises(ValueError):
        to_placements(P(("data", "pod")), names)


def test_partition_spec_compares_with_jax():
    from jax.sharding import PartitionSpec as JP
    assert P(("pod", "data"), None, "model") == JP(("pod", "data"), None,
                                                   "model")
    assert JP("model", None) == P("model", None)
    assert P() == JP()


def test_dist_context_refuses_flags_it_does_not_run():
    """Each of the reference's opt-in flags is taken (their islands are
    held in tests/test_torch_dist_flags.py); a name the reference does not
    know is an error."""
    axes = MESHES["smoke"]
    assert not DistContext(axes).has("chunked_ce")
    for flag in ("flash_decode", "chunked_ce", "fp8_gather",
                 "weight_stationary"):
        assert DistContext(axes, flags=frozenset({flag})).has(flag)
    with pytest.raises(ValueError):
        DistContext(axes, flags=frozenset({"chunked_cee"}))
