"""The port's training slice against the JAX package, on the CPU.

* ``lm_loss``, ``lr_at_step`` (every schedule) and ``adamw_update`` (each
  of ``moment_dtype``, ``factored_v``, ``master_dtype``) on the same inputs.
* ``make_train_step``: three steps on the mamba2, stablelm, gemma3 (local
  and global layers through the flash-attention wrapper), hubert (audio
  frames, bidirectional) and internvl2 (image patches) smoke configs from
  JAX-initialised state; loss, grad norm and params within 1e-5 in
  float32, and with ``microbatch=2``.
* ``batch_at`` gives identical arrays.
* Checkpoints in both directions, for mamba2 and gemma3: the port writes
  and JAX restores, JAX writes and the port restores, with the same
  manifest names; bfloat16 leaves keep their bits.
* The port's ``TrainCampaign`` through its ``KsaCluster``: 12 steps with a
  checkpoint at 12, and a crash mid-chunk that recovers with the
  uninterrupted run's loss (the counterparts of
  ``tests/test_fault_tolerance.py``); and a campaign on the gemma3 smoke
  config.
"""
import json
import threading
import time
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jax_configs
from repro.checkpoint import restore_checkpoint as jax_restore
from repro.checkpoint import save_checkpoint as jax_save
from repro.data import batch_at as jax_batch_at
from repro.optim import OptimizerConfig as JaxOptimizerConfig
from repro.optim import adamw_init as jax_adamw_init
from repro.optim import adamw_update as jax_adamw_update
from repro.optim import lr_at_step as jax_lr_at_step
from repro.train import init_train_state as jax_init_train_state
from repro.train import lm_loss as jax_lm_loss
from repro.train import make_train_step as jax_make_train_step
from repro_torch import configs
from repro_torch.checkpoint import (CheckpointManager, restore_checkpoint,
                                    save_checkpoint)
from repro_torch.convert import tree_to_torch
from repro_torch.data import batch_at
from repro_torch.optim import (OptimizerConfig, adamw_init, adamw_update,
                               lr_at_step)
from repro_torch.train import (TrainState, init_train_state, lm_loss,
                               make_prefill_step, make_serve_step,
                               make_train_step, train_state_shapes)
from repro_torch.tree import leaves, paths


def _np(x):
    """A leaf of either package as numpy; bfloat16 as float32."""
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32) if x.dtype == jnp.bfloat16
                      else x)


def _to_port_state(js) -> TrainState:
    return TrainState(tree_to_torch(jax.tree.map(np.asarray, js.params), "cpu"),
                      tree_to_torch(jax.tree.map(np.asarray, js.opt), "cpu"),
                      torch.tensor(int(js.step), dtype=torch.int32))


# ---------------------------------------------------------------------------
# loss, schedule, optimizer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("weighted", [False, True])
def test_lm_loss_matches_reference(weighted):
    rng = np.random.RandomState(0)
    logits = rng.randn(2, 7, 33).astype(np.float32) * 3
    labels = rng.randint(0, 33, (2, 7)).astype(np.int32)
    w = (rng.rand(2, 7) > 0.3).astype(np.float32) if weighted else None
    want, wm = jax_lm_loss(jnp.asarray(logits), jnp.asarray(labels),
                           None if w is None else jnp.asarray(w))
    got, gm = lm_loss(torch.from_numpy(logits), torch.from_numpy(labels),
                      None if w is None else torch.from_numpy(w))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    for k in ("ce", "z_loss", "tokens"):
        np.testing.assert_allclose(float(gm[k]), float(wm[k]), rtol=1e-6)


@pytest.mark.parametrize("schedule,warmup,total", [
    ("cosine", 5, 40), ("cosine", 0, 40), ("constant", 5, 40),
    ("constant", 0, 40), ("cosine", 10, 10)])
def test_lr_at_step_matches_reference(schedule, warmup, total):
    for step in range(0, 50, 3):
        want = jax_lr_at_step(jnp.asarray(step, jnp.int32), base_lr=3e-4,
                              warmup_steps=warmup, total_steps=total,
                              schedule=schedule)
        got = lr_at_step(torch.tensor(step, dtype=torch.int32), base_lr=3e-4,
                         warmup_steps=warmup, total_steps=total,
                         schedule=schedule)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


OPT_VARIANTS = {
    "default": {},
    "bf16_moments": {"moment_dtype": "bfloat16"},
    "factored_v": {"factored_v": True},
    "no_master": {"master_dtype": "none"},
    "no_clip_no_decay": {"grad_clip": 0.0, "weight_decay": 0.0},
}


@pytest.mark.parametrize("variant", sorted(OPT_VARIANTS))
def test_adamw_update_matches_reference(variant):
    kw = dict(lr=1e-2, **OPT_VARIANTS[variant])
    jcfg, cfg = JaxOptimizerConfig(**kw), OptimizerConfig(**kw)
    rng = np.random.RandomState(1)
    params = {"w": rng.randn(6, 5).astype(np.float32),
              "stack": rng.randn(2, 4, 3).astype(np.float32),
              "b": rng.randn(5).astype(np.float32)}
    jp = jax.tree.map(jnp.asarray, params)
    tp = tree_to_torch(params, "cpu")
    js, ts = jax_adamw_init(jp, jcfg), adamw_init(tp, cfg)
    assert [n for n, _ in paths(ts)] == \
        [jax.tree_util.keystr(k) for k, _ in
         jax.tree_util.tree_flatten_with_path(js)[0]]
    for step in range(3):
        grads = jax.tree.map(lambda p: rng.randn(*p.shape).astype(
            np.float32) * 5, params)
        lr = 1e-2 * (step + 1)
        jp, js, jst = jax_adamw_update(jp, jax.tree.map(jnp.asarray, grads),
                                       js, jcfg, jnp.asarray(lr, jnp.float32))
        tp, ts, tst = adamw_update(tp, tree_to_torch(grads, "cpu"), ts, cfg,
                                   torch.tensor(lr, dtype=torch.float32))
        np.testing.assert_allclose(float(tst["grad_norm"]),
                                   float(jst["grad_norm"]), rtol=1e-6)
        for a, b in zip(jax.tree.leaves((jp, js)), leaves((tp, ts))):
            assert str(a.dtype) == str(b.dtype).replace("torch.", "")
            np.testing.assert_allclose(_np(b), _np(a), atol=1e-6, rtol=1e-5)


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------

# Adam's first steps divide each element by its own gradient, so on an
# element whose gradient is near zero, the ~1e-7 difference that a different
# summation order leaves becomes a difference of order lr in the update
# (eps = 1e-8 lets that through: 1e-3 in the params after 3 steps). An eps
# of 1e-5 bounds that amplification; the optimizer itself is held to the
# reference at eps = 1e-8 above, on equal gradients.
STEP_OPT = dict(lr=2e-3, eps=1e-5, warmup_steps=2, total_steps=10,
                weight_decay=0.1, schedule="cosine")


TRAIN_ARCHS = ["mamba2_130m", "stablelm_1_6b", "gemma3_1b", "hubert_xlarge",
               "internvl2_1b"]


@pytest.mark.parametrize("microbatch", [None, 2])
@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_train_steps_match_reference(arch, microbatch):
    jcfg, cfg = jax_configs.smoke_config(arch), configs.smoke_config(arch)
    jo, o = JaxOptimizerConfig(**STEP_OPT), OptimizerConfig(**STEP_OPT)
    js = jax_init_train_state(jcfg, jo, jax.random.PRNGKey(0))
    ts = _to_port_state(js)
    jstep = jax.jit(jax_make_train_step(jcfg, jo, microbatch=microbatch))
    tstep = make_train_step(cfg, o, microbatch=microbatch)
    for s in range(3):
        b = jax_batch_at(jcfg, 0, s, batch=4, seq=64)
        js, jm = jstep(js, jax.tree.map(jnp.asarray, b))
        ts, tm = tstep(ts, {k: torch.from_numpy(v) for k, v in b.items()})
        for k in ("loss", "grad_norm", "lr", "ce", "z_loss"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), atol=1e-5,
                                       rtol=1e-5, err_msg=k)
    assert int(ts.step) == 3
    for (name, a), b in zip(jax.tree_util.tree_flatten_with_path(
            (js.params, js.opt))[0], leaves((ts.params, ts.opt))):
        np.testing.assert_allclose(_np(b), _np(a), atol=1e-5, err_msg=str(
            jax.tree_util.keystr(name)))


def test_train_step_rejects_what_is_not_ported():
    """remat and dist are ported for the train step (tests/test_torch_remat.py,
    tests/test_torch_sharded_step.py); dist in the prefill and serve steps
    is not yet."""
    cfg, o = configs.smoke_config("mamba2_130m"), OptimizerConfig()
    make_train_step(cfg, o, remat="full")
    with pytest.raises(KeyError):
        make_train_step(cfg, o, remat="unknown")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        make_prefill_step(cfg, dist=object())
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        make_serve_step(cfg, dist=object())


def test_init_and_shapes_agree_with_reference():
    for arch in TRAIN_ARCHS:
        jcfg, cfg = jax_configs.smoke_config(arch), configs.smoke_config(arch)
        want = jax.eval_shape(lambda: jax_init_train_state(
            jcfg, JaxOptimizerConfig(), jax.random.PRNGKey(0)))
        got = train_state_shapes(cfg, OptimizerConfig())
        real = init_train_state(cfg, OptimizerConfig(),
                                torch.Generator().manual_seed(0), "cpu")
        wp = [(jax.tree_util.keystr(k), tuple(v.shape), str(v.dtype))
              for k, v in jax.tree_util.tree_flatten_with_path(want)[0]]
        for tree in (got, real):
            tp = [(n, tuple(v.shape), str(v.dtype).replace("torch.", ""))
                  for n, v in paths(tree)]
            assert tp == wp


def test_batch_at_is_identical():
    for arch in TRAIN_ARCHS:
        for step in (0, 17):
            want = jax_batch_at(jax_configs.smoke_config(arch), 3, step,
                                batch=4, seq=32)
            got = batch_at(configs.smoke_config(arch), 3, step, batch=4,
                           seq=32)
            assert want.keys() == got.keys()
            for k in want:
                np.testing.assert_array_equal(got[k], want[k])


# ---------------------------------------------------------------------------
# checkpoints across the two packages
# ---------------------------------------------------------------------------


def _bits(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint16)
        return x.numpy()
    a = np.asarray(x)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


def _bf16_state(arch="mamba2_130m"):
    """A bfloat16 TrainState (fp32 master, m, v) a step in, both packages."""
    jcfg = jax_configs.smoke_config(arch).with_(dtype="bfloat16")
    jo = JaxOptimizerConfig(lr=1e-3)
    js = jax_init_train_state(jcfg, jo, jax.random.PRNGKey(2))
    b = jax.tree.map(jnp.asarray, jax_batch_at(jcfg, 0, 0, batch=2, seq=32))
    js, _ = jax.jit(jax_make_train_step(jcfg, jo))(js, b)
    cfg = configs.smoke_config(arch).with_(dtype="bfloat16")
    return jcfg, jo, js, cfg, _to_port_state(js)


CKPT_ARCHS = ["mamba2_130m", "gemma3_1b"]


@pytest.mark.parametrize("arch", CKPT_ARCHS)
def test_checkpoint_port_writes_jax_restores(tmp_path, arch):
    jcfg, jo, js, cfg, ts = _bf16_state(arch)
    assert ts.params["embed"]["embedding"].dtype == torch.bfloat16
    path = save_checkpoint(tmp_path / "port", 5, ts, extra={"loss": 1.5})
    jpath = jax_save(tmp_path / "jax", 5, js, extra={"loss": 1.5})
    mine = json.loads((tmp_path / "port" / "ckpt_00000005" /
                       "manifest.json").read_text())
    theirs = json.loads((tmp_path / "jax" / "ckpt_00000005" /
                         "manifest.json").read_text())
    assert mine.keys() == theirs.keys()
    strip = [{k: v for k, v in e.items() if k != "crc"}
             for e in mine["leaves"]]
    assert strip == [{k: v for k, v in e.items() if k != "crc"}
                     for e in theirs["leaves"]]
    assert [e["crc"] for e in mine["leaves"]] == \
        [e["crc"] for e in theirs["leaves"]]     # the same bytes
    like = jax.eval_shape(lambda: js)
    restored, extra = jax_restore(path, like)
    assert extra == {"loss": 1.5}
    for a, b in zip(jax.tree.leaves(restored), leaves(ts)):
        np.testing.assert_array_equal(_bits(a), _bits(b))
    assert str(jpath).endswith("ckpt_00000005")


@pytest.mark.parametrize("arch", CKPT_ARCHS)
def test_checkpoint_jax_writes_port_restores(tmp_path, arch):
    jcfg, jo, js, cfg, ts = _bf16_state(arch)
    path = jax_save(tmp_path, 9, js, extra={"arch": "x"})
    like = train_state_shapes(cfg, OptimizerConfig(lr=1e-3))
    restored, extra = restore_checkpoint(path, like, device="cpu")
    assert extra == {"arch": "x"} and isinstance(restored, TrainState)
    for a, b in zip(jax.tree.leaves(js), leaves(restored)):
        assert b.device.type == "cpu"
        np.testing.assert_array_equal(_bits(b), _bits(a))
    with pytest.raises(ValueError, match="device"):
        restore_checkpoint(path, like)


def test_checkpoint_corruption_and_retention(tmp_path):
    _, _, _, _, ts = _bf16_state()
    mgr = CheckpointManager(tmp_path, keep=2)
    for s in (1, 2, 3):
        mgr.save(s, ts)
    assert mgr.steps() == [2, 3]
    h = mgr.async_save(4, ts)
    assert h.result(timeout=60).endswith("ckpt_00000004")
    assert mgr.latest()[0] == 4
    shard = next(iter(sorted((tmp_path / "ckpt_00000004").glob("*.zst"))))
    raw = bytearray(shard.read_bytes())
    raw[len(raw) // 2] ^= 0xFF
    shard.write_bytes(bytes(raw))
    with pytest.raises(Exception):
        restore_checkpoint(mgr.latest()[1], ts)


# ---------------------------------------------------------------------------
# the fault-tolerant campaign through the port's KsaCluster
# ---------------------------------------------------------------------------


def _cluster():
    from repro_torch.cluster import KsaCluster
    from repro_torch.train import trainer  # noqa: F401 - registers the task
    return KsaCluster(prefix="tt", task_timeout_s=4.0, max_attempts=4,
                      session_timeout_s=1.0, default_partitions=2,
                      agent_kw=dict(heartbeat_interval_s=0.2))


@pytest.fixture
def cluster():
    with _cluster() as c:
        yield c


def _campaign(c, ckpt_dir, total=12, chunk=4, arch="mamba2_130m"):
    from repro_torch.train.trainer import TrainCampaign
    return TrainCampaign(c.broker, c.submitter, c.monitor,
                         arch=arch, ckpt_dir=str(ckpt_dir),
                         total_steps=total, chunk_steps=chunk, batch=4,
                         seq=32, timeout_s=90.0, device="cpu")


def test_training_campaign_completes(cluster, tmp_path):
    cluster.add_worker(slots=1)
    camp = _campaign(cluster, tmp_path / "ckpts")
    out = camp.run(wait_timeout=240.0)
    assert out["final_step"] == 12 and out["chunks"] == 3
    assert np.isfinite(out["final_loss"])
    assert CheckpointManager(tmp_path / "ckpts").latest()[0] == 12
    # the chunk params are the reference's, plus the device asked for
    entry = cluster.monitor.task("train-mamba2_130m-s000004")
    assert entry.task.params["device"] == "cpu"
    assert "smoke" not in entry.task.params
    assert (entry.task.resources.gpus, entry.task.resources.mem_mb) == \
        (0, 1024)


def test_restored_state_released_after_first_step(cluster, tmp_path,
                                                  monkeypatch):
    """A chunk that starts from a checkpoint keeps no reference to the
    restored state once its first step has replaced it: on the card that
    state would stay resident beside every later step's (14 GB more for
    gemma3-1b at full width)."""
    from repro_torch.train import trainer as tr
    restored: list = []
    real_restore = CheckpointManager.restore_latest

    def restore(self, like, **kw):
        out = real_restore(self, like, **kw)
        restored.extend(weakref.ref(t) for t in leaves(out[1]))
        return out
    alive: list = []
    real_make = tr.make_train_step

    def make(cfg, ocfg, **kw):
        step = real_make(cfg, ocfg, **kw)

        def counted(state, batch):
            alive.append(sum(r() is not None for r in restored))
            return step(state, batch)
        return counted
    monkeypatch.setattr(CheckpointManager, "restore_latest", restore)
    monkeypatch.setattr(tr, "make_train_step", make)
    monkeypatch.setattr(tr.TrainChunkComputing, "_step_cache", {})
    cluster.add_worker(slots=1)
    out = _campaign(cluster, tmp_path / "ckpts", total=4,
                    chunk=2).run(wait_timeout=240.0)
    assert out["final_step"] == 4 and out["chunks"] == 2
    # steps 0-1 cold, step 2 from the restored state, step 3 after it
    assert alive[2] == len(restored) > 0 and alive[3] == 0, alive


def test_gemma3_campaign_completes(cluster, tmp_path):
    """The training main path's model (local and global attention layers
    through the flash-attention wrapper) as a campaign on the CPU: 8 steps
    in 2 chunks, restored from the step-4 checkpoint, with the loss of the
    same 8 steps run in one process."""
    from repro_torch.train.trainer import _ocfg_from_params
    cluster.add_worker(slots=1)
    out = _campaign(cluster, tmp_path / "ckpts", total=8, chunk=4,
                    arch="gemma3_1b").run(wait_timeout=240.0)
    assert out["final_step"] == 8 and out["chunks"] == 2
    assert CheckpointManager(tmp_path / "ckpts").latest()[0] == 8
    cfg, ocfg = configs.smoke_config("gemma3_1b"), _ocfg_from_params({})
    state = init_train_state(cfg, ocfg, torch.Generator().manual_seed(0),
                             "cpu")
    step = make_train_step(cfg, ocfg)
    for s in range(8):
        state, m = step(state, {k: torch.from_numpy(v) for k, v in
                                batch_at(cfg, 0, s, batch=4, seq=32).items()})
    np.testing.assert_allclose(out["final_loss"], float(m["loss"]),
                               rtol=1e-6)


def test_campaign_chunk_requests():
    """Defaults send the reference's params; ``smoke``/``device`` are
    forwarded, and a CUDA device asks for a GPU."""
    from repro_torch.train.trainer import TrainCampaign

    class Recorder:
        def submit(self, script, **kw):
            self.last = (script, kw)
            return kw["task_id"]
    sub = Recorder()
    TrainCampaign(None, sub, None, arch="mamba2_130m", ckpt_dir="d",
                  total_steps=10, chunk_steps=4)._submit_chunk(8)
    script, kw = sub.last
    assert script == "train_chunk" and kw["task_id"] == \
        "train-mamba2_130m-s000008"
    assert kw["params"] == {"arch": "mamba2_130m", "ckpt_dir": "d",
                            "start_step": 8, "n_steps": 2, "batch": 8,
                            "seq": 64, "data_seed": 0}
    assert (kw["gpus"], kw["mem_mb"]) == (0, 1024)
    TrainCampaign(None, sub, None, arch="mamba2_130m", ckpt_dir="d",
                  total_steps=10, chunk_steps=4, smoke=False,
                  device="cuda", mem_mb=4096)._submit_chunk(0)
    _, kw = sub.last
    assert kw["params"]["smoke"] is False and \
        kw["params"]["device"] == "cuda"
    assert (kw["gpus"], kw["mem_mb"]) == (1, 4096)


def test_agent_crash_midchunk_campaign_recovers(cluster, tmp_path):
    """Kill the only agent during chunk 2; bring up a replacement; the
    monitor's watchdog resubmits and the campaign finishes with the same
    loss and checkpoint as an uninterrupted run."""
    a1 = cluster.add_worker(slots=1)
    box = {}

    def drive():
        box["out"] = _campaign(cluster, tmp_path / "ckpts").run(
            wait_timeout=240.0)
    t = threading.Thread(target=drive, daemon=True)
    t.start()
    deadline = time.time() + 120
    e = None
    while time.time() < deadline:
        e = cluster.monitor.task("train-mamba2_130m-s000004")
        if e is not None and e.status == "RUNNING":
            break
        time.sleep(0.02)
    assert e is not None, "second chunk never started"
    a1.crash()
    cluster.add_worker(slots=1)
    t.join(timeout=300)
    assert "out" in box, "campaign did not finish after recovery"
    assert box["out"]["final_step"] == 12
    assert cluster.monitor.resubmissions >= 1

    # the control runs on a cluster of its own: the chunks' task ids are
    # derived from (arch, start step), so this monitor already has them
    with _cluster() as c2:
        c2.add_worker(slots=1)
        ctl = _campaign(c2, tmp_path / "control").run(wait_timeout=240.0)
    assert ctl["final_step"] == 12 and c2.monitor.resubmissions == 0
    np.testing.assert_allclose(box["out"]["final_loss"], ctl["final_loss"],
                               rtol=1e-5)
    like = train_state_shapes(configs.smoke_config("mamba2_130m"),
                              OptimizerConfig())
    got, _ = restore_checkpoint(CheckpointManager(
        tmp_path / "ckpts").latest()[1], like, device="cpu")
    want, _ = restore_checkpoint(CheckpointManager(
        tmp_path / "control").latest()[1], like, device="cpu")
    for a, b in zip(leaves(got), leaves(want)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                   atol=1e-6)
