"""The port's cells (``repro_torch.launch.specs.make_cell``) and dry-run
(``repro_torch.launch.dryrun``) against the reference's, with no world.

All 33 (arch x shape) cells of ``configs.cells_for`` on both production
meshes, (data=16, model=16) and (pod=2, data=16, model=16). The reference
builds its cells on ``jax.sharding.AbstractMesh`` (no devices), the port on
the same axis name -> size map:

* ``cache_sharding_tree`` leaf by leaf, for the decode caches of every
  decode and prefill cell;
* ``make_cell``: every argument's shape and dtype, the in and out
  placements leaf by leaf, donation and ``static_notes``;
* the dry-run's per-device argument bytes against the JAX shard shapes of
  every argument times its item size;
* ``model_flops`` exactly. ``repro.launch.dryrun`` sets ``XLA_FLAGS`` when
  it is imported; the import here restores the environment after it, so
  no later JAX subprocess of the same worker sees the setting.

The dry-run's costing: its count extrapolated from two reduced depths
equals a direct count at full depth (smoke widths, depth raised so that
the extrapolation is not trivial: gemma3-1b with remainder layers,
stablelm); and ``python -m repro_torch.launch.dryrun`` writes a record for
each cell it is given.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
from jax.sharding import AbstractMesh

from repro import configs as jax_configs
from repro.launch import specs as jax_specs
from repro.sharding import DistContext as JaxDistContext
from repro_torch import configs
from repro_torch.launch import dryrun, mesh_axes, specs
from repro_torch.sharding import DistContext
from repro_torch.sharding.context import _spec_leaves
from repro_torch.tree import leaves

MESHES = {"single_pod": mesh_axes(multi_pod=False),
          "multi_pod": mesh_axes(multi_pod=True)}
CELLS = [(a, s.name, m) for a in configs.ARCHS for s in configs.cells_for(a)
         for m in MESHES]
ROOT = Path(__file__).resolve().parents[1]


def _jax_model_flops():
    saved = dict(os.environ)
    try:
        from repro.launch.dryrun import model_flops
    finally:
        os.environ.clear()
        os.environ.update(saved)
    return model_flops


def _cells(arch, shape, mesh):
    axes = MESHES[mesh]
    jd = JaxDistContext(AbstractMesh(tuple(axes.values()), tuple(axes)))
    return (specs.make_cell(arch, configs.SHAPES[shape], DistContext(axes)),
            jax_specs.make_cell(arch, jax_configs.SHAPES[shape], jd), axes)


def _spec(entries, ndim):
    out = tuple(entries)
    return out + (None,) * (ndim - len(out))


def _shardings(tree):
    """The NamedShardings of a JAX tree (its None entries dropped)."""
    return jax.tree.leaves(tree)


def _arg_leaves(args):
    return [t for t in leaves(args) if hasattr(t, "shape")]


def test_thirty_three_cells():
    assert len(CELLS) == 66 and len({(a, s) for a, s, _ in CELLS}) == 33


@pytest.mark.parametrize("arch,shape,mesh", CELLS)
def test_cell_matches_reference(arch, shape, mesh):
    cell, jcell, axes = _cells(arch, shape, mesh)
    got, want = _arg_leaves(cell.args), jax.tree.leaves(jcell.args)
    assert len(got) == len(want)
    for t, w in zip(got, want):
        assert tuple(t.shape) == tuple(w.shape)
        assert str(t.dtype).replace("torch.", "") == str(w.dtype)
    for mine, ref in ((cell.in_shardings, jcell.in_shardings),
                      (cell.out_shardings, jcell.out_shardings)):
        got_s, want_s = _spec_leaves(mine), _shardings(ref)
        assert len(got_s) == len(want_s)
    dims = [t.dim() for t in got]
    got_s, want_s = _spec_leaves(cell.in_shardings), \
        _shardings(jcell.in_shardings)
    for g, w, n in zip(got_s, want_s, dims):
        assert _spec(g, n) == _spec(w.spec, n), (g, w.spec)
    assert cell.donate_argnums == jcell.donate_argnums
    assert cell.static_notes == jcell.static_notes
    # the dry-run's per-device argument bytes: the JAX shard shapes
    want_b = sum(int(np.prod(s.shard_shape(w.shape))) * w.dtype.itemsize
                 for w, s in zip(want, want_s))
    got_b = sum(dryrun.tree_bytes(a, s, axes)
                for a, s in zip(cell.args, cell.in_shardings))
    assert got_b == want_b


@pytest.mark.parametrize("arch,shape,mesh", CELLS)
def test_out_shardings_match_reference(arch, shape, mesh):
    cell, jcell, _ = _cells(arch, shape, mesh)
    got_s, want_s = _spec_leaves(cell.out_shardings), \
        _shardings(jcell.out_shardings)
    for g, w in zip(got_s, want_s):
        n = max(len(g), len(w.spec))
        assert _spec(g, n) == _spec(w.spec, n)


@pytest.mark.parametrize("arch", [a for a in configs.ARCHS
                                  if not configs.get_config(a).encoder_only])
@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_cache_sharding_tree_matches_reference(arch, mesh):
    axes = MESHES[mesh]
    jd = JaxDistContext(AbstractMesh(tuple(axes.values()), tuple(axes)))
    for batch, max_len in ((128, 32768), (1, 524288), (32, 4096)):
        cfg, jcfg = configs.get_config(arch), jax_configs.get_config(arch)
        shapes = specs.decode_cache_shapes(cfg, batch, max_len)
        jshapes = jax_specs.decode_cache_shapes(jcfg, batch, max_len)
        got = _spec_leaves(specs.cache_sharding_tree(DistContext(axes), cfg,
                                                     shapes, batch))
        want = _shardings(jax_specs.cache_sharding_tree(jd, jcfg, jshapes,
                                                        batch))
        ts = leaves(shapes)
        assert len(got) == len(want) == len(ts)
        for t, j in zip(ts, jax.tree.leaves(jshapes)):
            assert tuple(t.shape) == tuple(j.shape)
        for g, w, t in zip(got, want, ts):
            assert _spec(g, t.dim()) == _spec(w.spec, t.dim())


@pytest.mark.parametrize("arch", configs.ARCHS)
def test_model_flops_equal_reference(arch):
    jax_model_flops = _jax_model_flops()
    for shape in configs.cells_for(arch):
        assert dryrun.model_flops(configs.get_config(arch), shape) == \
            jax_model_flops(jax_configs.get_config(arch),
                            jax_configs.SHAPES[shape.name])


@pytest.mark.parametrize("arch,layers,shape", [
    # 5 periods of 3 and 2 tail layers; 4 microbatches of 16
    ("gemma3_1b", 17, configs.Shape("train_small", 128, 64, "train")),
    ("gemma3_1b", 17, configs.Shape("decode_small", 256, 8, "decode")),
    ("stablelm_1_6b", 6, configs.Shape("prefill_small", 256, 4, "prefill"))],
    ids=lambda v: getattr(v, "name", str(v)))
def test_extrapolated_flops_equal_full_depth_count(monkeypatch, arch,
                                                   layers, shape):
    cfg = configs.smoke_config(arch).with_(n_layers=layers)
    monkeypatch.setattr(configs, "get_config", lambda name: cfg)
    monkeypatch.setattr(dryrun, "get_config", lambda name: cfg)
    dist = DistContext(MESHES["single_pod"])
    got = dryrun.costed_flops(arch, shape, dist)
    assert got["costing_periods"] == [2, 4] and cfg.n_periods > 4
    assert got["microbatch"] == (4 if shape.step == "train" else 1)
    full = dryrun.count_flops(specs.make_cell(
        arch, shape, dist, costing_periods=cfg.n_periods))
    assert full > 0
    assert got["flops_total"] == pytest.approx(full * got["microbatch"],
                                               rel=1e-9)


def test_dryrun_cli_writes_a_record_per_cell(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--single-pod",
         "--arch", "gemma3_1b", "--shape", "decode_32k", "--out",
         str(tmp_path)], env=env, capture_output=True, text=True,
        timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    recs = [json.loads(p.read_text()) for p in tmp_path.glob("*.json")]
    assert len(recs) == 1 and recs[0]["ok"]
    rec = recs[0]
    assert rec["memory"]["temp_bytes"] is None
    assert rec["roofline"]["device"] == dryrun.DEVICE
    assert rec["roofline"]["model_flops_total"] == _jax_model_flops()(
        jax_configs.get_config("gemma3_1b"), jax_configs.SHAPES["decode_32k"])
