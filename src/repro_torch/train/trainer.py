"""The fault-tolerant trainer as a KSA task — the paper's technique applied
to training. Port of ``repro/train/trainer.py``.

A training run is a campaign of **step-chunk tasks** on the ``PREFIX-new``
topic: chunk k = "advance from checkpoint at step s_k by n steps, write a
checkpoint, report metrics". Chunks are idempotent (deterministic data via
``repro_torch.data.synthetic``; state via ``repro_torch.checkpoint``), so
the KSA at-least-once machinery — watchdog timeout → resubmit, attempt
fencing at the monitor — gives end-to-end fault tolerance: kill any agent
mid-chunk and the campaign completes with the same results.

``TrainChunkComputing`` (script ``train_chunk``, in the port's own
registry) runs on ``params["device"]`` (default ``"cuda"``; the tests pass
``"cpu"``) and reads ``params["smoke"]`` as the reference does: absent or
true means the reduced smoke config.

``TrainCampaign`` takes keyword arguments the reference's lacks: ``smoke``
and ``device``, forwarded into each chunk's params, and ``mem_mb``, the
chunk tasks' memory request (an agent revokes a task whose host memory
grows past it, and a full-width chunk holds a checkpoint's worth of host
buffers). A CUDA ``device`` also asks for one GPU, so the chunks route to
GPU workers. Left at their defaults (``None``, ``None``, 1024) the chunk
params and resources are the reference's unchanged (and the reference
trains the smoke config, since it never sends ``smoke``). ``smoke=False``
is the one way to ask a campaign for the full published width.
"""
from __future__ import annotations

import time
from typing import Any

import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.convert import resolve_device
from repro_torch.core import (Broker, ClusterComputing, MonitorAgent,
                              Submitter, register_script)
from repro_torch.data import batch_at
from repro_torch.models.config import ModelConfig
from repro_torch.optim import OptimizerConfig
from .step import init_train_state, make_train_step, train_state_shapes


def _cfg_from_params(params: dict) -> ModelConfig:
    # looked up at call time: chip_smoke.py's _depth_cut rebinds this name
    # to cut a campaign's depth while keeping its full width
    from repro_torch.configs import get_config, smoke_config
    if params.get("smoke", True):
        return smoke_config(params["arch"])
    return get_config(params["arch"])


def _ocfg_from_params(params: dict) -> OptimizerConfig:
    o = params.get("optimizer", {})
    return OptimizerConfig(lr=o.get("lr", 2e-3),
                           warmup_steps=o.get("warmup_steps", 0),
                           total_steps=o.get("total_steps", 1000),
                           schedule=o.get("schedule", "constant"),
                           weight_decay=o.get("weight_decay", 0.0),
                           grad_clip=o.get("grad_clip", 1.0))


@register_script("train_chunk")
class TrainChunkComputing(ClusterComputing):
    """params: arch, ckpt_dir, start_step, n_steps, batch, seq, data_seed,
    smoke (reduced config), device, optimizer{...}. Result: final_step,
    ckpt_path, loss, throughput."""

    # the step function, kept across chunks within one agent process
    _step_cache: dict = {}

    def run(self) -> Any:
        p = self.params
        cfg = _cfg_from_params(p)
        ocfg = _ocfg_from_params(p)
        dev = resolve_device(p.get("device", "cuda"))
        start = int(p["start_step"])
        n_steps = int(p["n_steps"])
        batch_size = int(p.get("batch", 8))
        seq = int(p.get("seq", 64))
        seed = int(p.get("data_seed", 0))
        mgr = CheckpointManager(p["ckpt_dir"], keep=int(p.get("keep", 3)))

        key = (cfg, ocfg, seq, batch_size, str(dev))
        if key not in self._step_cache:
            self._step_cache[key] = make_train_step(cfg, ocfg)
        step_fn = self._step_cache[key]

        # restore (or cold start) — never trust start_step blindly: the
        # chunk must begin from a checkpoint at exactly `start`.
        if start > 0:
            restored = mgr.restore_latest(train_state_shapes(cfg, ocfg),
                                          device=dev)
            if restored is None:
                raise RuntimeError(f"chunk starts at {start} but no "
                                   f"checkpoint exists")
            ck_step, state, _ = restored
            # the tuple would keep the restored state resident beside every
            # later step's (a second full train state on the device)
            del restored
            if ck_step != start:
                # redelivered stale chunk: resume from what actually exists
                start = ck_step
        else:
            gen = torch.Generator(device=dev).manual_seed(seed)
            state = init_train_state(cfg, ocfg, gen, dev)
        t0 = time.time()
        loss = float("nan")
        metrics: dict = {}
        for s in range(start, start + n_steps):
            self.check_cancel()
            b = {k: torch.from_numpy(v).to(dev)
                 for k, v in batch_at(cfg, seed, s, batch=batch_size,
                                      seq=seq).items()}
            state, metrics = step_fn(state, b)
            if (s - start) % max(n_steps // 4, 1) == 0:
                loss = float(metrics["loss"])
                self.send_status("RUNNING", step=s, loss=loss)
        loss = float(metrics["loss"])
        final_step = start + n_steps
        handle = mgr.async_save(final_step, state,
                                extra={"loss": loss, "arch": cfg.name})
        # no 120 s cap on the wait, unlike the reference: a full-width
        # gemma3-1b checkpoint (12.7 GB at about 100 MB/s) takes longer;
        # the chunk's own lease timeout bounds a save that never ends
        ckpt_path = handle.result()
        dt = time.time() - t0
        return {
            "final_step": final_step,
            "ckpt_path": ckpt_path,
            "loss": loss,
            "steps_per_s": n_steps / max(dt, 1e-9),
        }


class TrainCampaign:
    """The submitter side: chains step-chunks through the broker until
    ``total_steps`` is reached. Tolerant of agent death (monitor resubmits)
    and of its own restart (progress is derived from the monitor table).

    ``smoke`` and ``device``, when given, are forwarded into every chunk's
    params; ``mem_mb`` is the chunks' memory request (see the module
    docstring)."""

    def __init__(self, broker: Broker, submitter: Submitter,
                 monitor: MonitorAgent, *, arch: str, ckpt_dir: str,
                 total_steps: int, chunk_steps: int, batch: int = 8,
                 seq: int = 64, data_seed: int = 0,
                 timeout_s: float = 120.0, smoke: bool | None = None,
                 device: str | None = None, mem_mb: int = 1024):
        self.submitter = submitter
        self.monitor = monitor
        self.arch = arch
        self.ckpt_dir = ckpt_dir
        self.total_steps = total_steps
        self.chunk_steps = chunk_steps
        self.batch = batch
        self.seq = seq
        self.data_seed = data_seed
        self.timeout_s = timeout_s
        self.smoke = smoke
        self.device = device
        self.mem_mb = mem_mb
        self.chunk_results: list[dict] = []

    def _submit_chunk(self, start: int) -> str:
        n = min(self.chunk_steps, self.total_steps - start)
        params = {"arch": self.arch, "ckpt_dir": self.ckpt_dir,
                  "start_step": start, "n_steps": n, "batch": self.batch,
                  "seq": self.seq, "data_seed": self.data_seed}
        if self.smoke is not None:
            params["smoke"] = self.smoke
        if self.device is not None:
            params["device"] = self.device
        return self.submitter.submit(
            "train_chunk",
            task_id=f"train-{self.arch}-s{start:06d}",
            params=params, mem_mb=self.mem_mb,
            gpus=int(self.device is not None
                     and torch.device(self.device).type == "cuda"),
            timeout_s=self.timeout_s)

    def run(self, wait_timeout: float = 300.0) -> dict:
        start = 0
        while start < self.total_steps:
            tid = self._submit_chunk(start)
            ok = self.monitor.wait_all([tid], timeout=wait_timeout)
            if not ok:
                raise TimeoutError(f"chunk {tid} did not complete")
            entry = self.monitor.task(tid)
            res = entry.result
            self.chunk_results.append(res)
            start = int(res["final_step"])
        return {"final_step": start,
                "final_loss": self.chunk_results[-1]["loss"],
                "chunks": len(self.chunk_results)}
