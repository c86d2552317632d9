"""Serving with continuous batching, driven through the KSA broker.

Port of ``repro/serve/engine.py``. The reference's ``jax.jit`` of the step
becomes a plain call: PyTorch runs the step eagerly (a CUDA graph around it
is later work, ``ROADMAP.md``). The engine takes a ``device`` (default
``"cuda"``, through :func:`repro_torch.convert.resolve_device`); the serving
tasks use their engine's. The decode step writes the caches in place, so
the stall rollback saves the stalled slots' per-slot lanes before the
device call and writes them back after (see :meth:`ServeEngine._step`).

This is the paper's AlphaKnot-2.0 deployment pattern (§4: "KSA is integrated
with the application's built-in web service … It manages all user requests
and performs the necessary computations behind the scenes") applied to LM
inference: requests arrive on ``PREFIX-new`` (script="serve_request"), a
serving agent owns the model and runs a **continuous-batching** loop —
slot-based KV caches, per-slot positions, join-on-arrival / leave-on-EOS —
and results flow back via ``PREFIX-done``.

The decode step is ``make_serve_step``'s; per-slot positions use the per-batch ``q_offset`` path of chunked attention,
or the fused flash-decode kernel with ``decode_kernel="flash"``.

Admission is token-level and never blocks the device:

* the device step runs **outside** the engine lock — ``step()`` assembles a
  snapshot under the lock, dispatches, then applies results under the lock,
  skipping any slot whose generation counter moved (admitted/evicted
  mid-flight);
* admission does O(pages-touched) work, not an O(cache) tree rebuild:
  attention KV needs no zeroing at all (position masking — dense ``end``
  masks, ring-buffer negative positions, paged table clamps — already hides
  stale lanes) and only the recurrent leaves (ssd/rglru ``h``/``conv``
  state) of the admitted slot are zeroed, deferred to the next assembly;
* with ``paged=True`` the full-context KV lives in fixed-size pages bound
  on demand (``serve.paged.PageAllocator``), so admission binds one page
  and completion frees O(pages-used) — slots never reserve ``max_len``;
* a slot that loses the page race **stalls in place**: its table row is
  cleared for that step (the garbage lane's writes clamp to the trash
  page) and its per-slot lanes are rolled back afterwards, so it resumes
  bit-exact once pages free up.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any

import numpy as np
import torch

from repro_torch.convert import resolve_device
from repro_torch.core import ClusterComputing, register_script
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import torch_dtype
from repro_torch.models.transformer import (init_caches, init_paged_caches,
                                            paged_layout)
from repro_torch.train.step import make_serve_step

from .paged import PageAllocator

_RECURRENT_KINDS = ("ssd", "rglru")
# positional caches are masked by k_valid/page-table logic; only recurrent
# state carries across steps unmasked and must be zeroed on admission.
_POSITIONAL_LEAVES = ("k", "v", "pool_k", "pool_v", "c_kv", "k_rope")


def _map_with_path(fn, tree: dict, path: tuple = ()) -> dict:
    """``fn(path, leaf)`` over a nested dict of tensors, same nesting; the
    path is the tuple of keys down to the leaf."""
    return {k: (_map_with_path(fn, v, path + (k,)) if isinstance(v, dict)
                else fn(path + (k,), v)) for k, v in tree.items()}


def _lane_index(path: tuple, rows) -> tuple:
    """Index of slot lanes ``rows`` in a per-slot cache leaf: stacked caches
    (under "periods") lead with the layer axis."""
    return (slice(None),) * (1 if "periods" in path else 0) + (rows,)


@dataclass
class _Slot:
    request_id: str | None = None
    tokens: list[int] = field(default_factory=list)
    prompt: list[int] = field(default_factory=list)
    max_new: int = 16
    position: int = 0
    done: bool = True
    gen: int = 0              # bumped on admit/evict; stale steps skip apply
    arrival_ts: float = 0.0
    got_first_token: bool = False
    base_prompt_len: int = 0  # original prompt length (resume replays the
                              # generated prefix as extra prompt tokens)


class ServeEngine:
    """Slot-based continuous batching around a single decode step.

    All slots advance together each step (one ``serve_step`` call); finished
    slots are refilled from the queue without stalling the others — the
    property that keeps utilization high under ragged request lengths.

    ``step()`` must be driven by a single thread (the replica driver);
    ``add_request`` / ``evict`` may be called concurrently from any thread
    and only touch host state under the admission lock.
    """

    def __init__(self, cfg: ModelConfig, params: Any, *, n_slots: int = 4,
                 max_len: int = 512, eos_id: int | None = None,
                 paged: bool = False, page_size: int = 64,
                 n_pages: int | None = None,
                 decode_kernel: str | None = None,
                 admission: str = "lazy",
                 registry: Any = None, replica: str = "0",
                 step_latency_s: float = 0.0,
                 device: str | torch.device = "cuda"):
        if decode_kernel is not None:
            cfg = cfg.with_(decode_kernel=decode_kernel)
        if admission not in ("lazy", "reset_full"):
            raise ValueError(f"unknown admission mode {admission!r}")
        if admission == "reset_full" and paged:
            # the full-lane zero indexes leaf dim 0 by slot, but paged
            # pool_k/pool_v lead with the *physical page* axis — zeroing
            # "slot i" there would wipe page i, which may hold another
            # request's KV. The legacy baseline is dense-cache only.
            raise ValueError("admission='reset_full' cannot be combined "
                             "with paged=True; use the default lazy "
                             "admission for paged caches")
        self.cfg = cfg
        self.params = params
        self.n_slots = n_slots
        self.max_len = max_len
        self.eos_id = eos_id
        self.paged = paged
        self.admission = admission
        self.replica = replica
        self.step_latency_s = step_latency_s
        self.device = resolve_device(device)
        dt = torch_dtype(cfg.dtype)
        if paged:
            pages_per_slot, pool_pages = paged_layout(max_len, page_size,
                                                      n_slots, n_pages)
            self.caches = init_paged_caches(cfg, n_slots, max_len, dt,
                                            page_size=page_size,
                                            n_pages=pool_pages,
                                            device=self.device)
            self.allocator: PageAllocator | None = PageAllocator(
                pool_pages, page_size, n_slots, pages_per_slot)
            self._serve = make_serve_step(cfg, paged=True)
        else:
            self.caches = init_caches(cfg, n_slots, max_len, dt, self.device)
            self.allocator = None
            self._serve = make_serve_step(cfg)
        self.slots = [_Slot() for _ in range(n_slots)]
        self._lock = threading.Lock()
        self._step_guard = threading.Lock()
        self._pending_reset: set[int] = set()
        self._has_recurrent = any(k in _RECURRENT_KINDS
                                  for k in cfg.layer_kinds())
        self._recent: deque = deque(maxlen=64)  # (ts, tokens) per step
        self.steps = 0
        self.tokens_out = 0
        self._m = None
        if registry is not None:
            from .metrics import register_serve_metrics
            fams = register_serve_metrics(registry)
            self._m = {name: fam.labels(replica=replica)
                       for name, fam in fams.items()
                       if name != "requests"}
            self._m_requests = fams["requests"]
            self._m["slots_total"].set(n_slots)
            if self.allocator is not None:
                self._m["pages_total"].set(self.allocator.capacity)

    def _event(self, event: str) -> None:
        if self._m is not None:
            self._m_requests.labels(replica=self.replica, event=event).inc()

    # -- request lifecycle ----------------------------------------------------

    def add_request(self, request_id: str, prompt: list[int],
                    max_new: int = 16, *, arrival_ts: float | None = None,
                    resume_tokens: list[int] | None = None) -> bool:
        """Claim a free slot; False if saturated or (paged) out of pages —
        the caller requeues. O(pages-touched): no device work beyond a
        deferred per-slot recurrent-state zero.

        ``resume_tokens`` re-admits an evicted request: the generated prefix
        is replayed as part of the prompt and greedy decoding continues
        deterministically from where it stopped.

        Raises ValueError for a request that can never fit: prompt feeding
        bypasses the max_len force-finish, so an oversized prompt would walk
        positions past the cache (and past the page table)."""
        total = len(prompt) + len(resume_tokens or [])
        if total >= self.max_len:
            raise ValueError(
                f"request {request_id!r} has {total} prompt tokens "
                f"(incl. resume) but max_len={self.max_len} leaves no "
                "decode position; it would never fit — truncate or raise "
                "max_len")
        now = time.time() if arrival_ts is None else arrival_ts
        with self._lock:
            for i, s in enumerate(self.slots):
                if not s.done:
                    continue
                if self.allocator is not None:
                    self.allocator.release(i)
                    if not self.allocator.ensure(i, 0):
                        return False  # page pool exhausted
                resumed = list(resume_tokens or [])
                self.slots[i] = _Slot(
                    request_id=request_id,
                    prompt=list(prompt) + resumed,
                    tokens=resumed, max_new=max_new,
                    position=0, done=False, gen=s.gen + 1,
                    arrival_ts=now,
                    got_first_token=bool(resumed),
                    base_prompt_len=len(prompt))
                if self.admission != "reset_full":
                    self._pending_reset.add(i)
                elif self._step_guard.locked():
                    # a step's device call may be in flight; its apply phase
                    # would clobber an eager zero with new_caches — defer to
                    # the next assembly, which runs under this lock.
                    self._pending_reset.add(i)
                else:
                    self._reset_slot_cache(i)
                if self._m is not None:
                    self._m["queue_wait"].observe(max(0.0, time.time() - now))
                self._event("admitted")
                return True
            return False

    def evict(self, request_id: str) -> dict | None:
        """Preempt a mid-generation request, freeing its slot (and pages)
        immediately. Returns the state needed to resume it elsewhere via
        ``add_request(..., resume_tokens=state["tokens"])``, or None if the
        request isn't active."""
        with self._lock:
            for i, s in enumerate(self.slots):
                if s.request_id == request_id and not s.done:
                    state = {"request_id": s.request_id,
                             "prompt": list(s.prompt[:s.base_prompt_len]),
                             "tokens": list(s.tokens),
                             "max_new": s.max_new}
                    s.done = True
                    s.gen += 1
                    if self.allocator is not None:
                        self.allocator.release(i)
                    self._event("evicted")
                    return state
            return None

    def _reset_slot_cache(self, i: int) -> None:
        """Legacy full-tree rebuild (admission="reset_full"): zeroes slot
        ``i``'s lane in *every* cache leaf — O(cache) device work per
        admission, kept as the benchmark baseline for the lazy path."""
        def zero_lane(path, c):
            c[_lane_index(path, slice(i, i + 1))] = 0
            return c
        self.caches = _map_with_path(zero_lane, self.caches)

    def _save_lanes(self, caches: dict, idx: list[int]) -> dict:
        """Copies of slot lanes ``idx`` of every per-slot cache leaf, taken
        before a step in which those slots stall. The step writes the caches
        in place, so the pre-step state must be copied out; JAX kept the
        whole pre-step tree for free. Physical page pools are skipped: their
        leading axis is the page, not the slot, and the cleared table rows
        clamp those writes to the trash page."""
        rows = torch.as_tensor(idx, dtype=torch.long, device=self.device)

        def save(path, c):
            if path[-1] in ("pool_k", "pool_v"):
                return None
            return c[_lane_index(path, rows)].clone()
        return _map_with_path(save, caches)

    def _restore_lanes(self, new: Any, saved: Any, idx: list[int]) -> Any:
        """Write the lanes :meth:`_save_lanes` copied back into ``new`` —
        undoing the garbage-lane advance of slots that stalled on page-pool
        exhaustion."""
        rows = torch.as_tensor(idx, dtype=torch.long, device=self.device)

        def restore(path, n):
            lane = saved
            for key in path:
                lane = lane[key]
            if lane is not None:
                n[_lane_index(path, rows)] = lane
            return n
        return _map_with_path(restore, new)

    def _apply_resets(self) -> None:
        """Zero the state of newly admitted slots, batched across admissions
        since the last step: in lazy mode only the recurrent leaves
        (ssd/rglru h/conv — positional caches are left alone, masking
        already hides stale entries); in reset_full mode the full lane of
        any admission deferred because a step was in flight."""
        if not self._pending_reset:
            return
        idx = sorted(self._pending_reset)
        self._pending_reset.clear()
        if self.admission == "reset_full":
            for i in idx:
                self._reset_slot_cache(i)
            return
        if not self._has_recurrent:
            return
        rows = torch.as_tensor(idx, dtype=torch.long, device=self.device)

        def zero_lane(path, c):
            if path[-1] not in _POSITIONAL_LEAVES:
                c[_lane_index(path, rows)] = 0
            return c
        self.caches = _map_with_path(zero_lane, self.caches)

    def _active(self) -> list[int]:
        return [i for i, s in enumerate(self.slots) if not s.done]

    # -- the core loop step -----------------------------------------------------

    def step(self) -> list[tuple[str, list[int]]]:
        """Advance every active slot by one token (prompt-feeding slots
        consume their next prompt token; generating slots append). Returns
        finished (request_id, tokens) pairs.

        Three phases: assemble (lock), device call (no lock — admissions
        proceed concurrently), apply (lock, generation-checked)."""
        if not self._step_guard.acquire(blocking=False):
            raise RuntimeError("ServeEngine.step is single-driver; a step "
                               "is already in flight")
        try:
            return self._step()
        finally:
            self._step_guard.release()

    def _step(self) -> list[tuple[str, list[int]]]:
        with self._lock:
            active = self._active()
            if not active:
                return []
            self._apply_resets()
            col = np.zeros((self.n_slots, 1), np.int32)
            pos = np.zeros((self.n_slots,), np.int32)
            stepped: list[int] = []
            stalled: list[int] = []
            gens: dict[int, int] = {}
            for i in active:
                s = self.slots[i]
                if self.allocator is not None and \
                        not self.allocator.ensure(i, s.position):
                    stalled.append(i)
                    continue  # pool exhausted: slot stalls, retries next step
                if s.position < len(s.prompt):
                    col[i, 0] = s.prompt[s.position]
                else:
                    col[i, 0] = s.tokens[-1] if s.tokens else s.prompt[-1]
                pos[i] = s.position
                stepped.append(i)
                gens[i] = s.gen
            if not stepped:
                return []
            caches = self.caches
            pages = None
            if self.allocator is not None:
                # a copy: admissions may rewrite the host table while the
                # device call runs
                table = self.allocator.table.copy()
                if stalled:
                    # a stalled slot still rides through the device call as a
                    # garbage lane (col=0, pos=0); clearing its row makes the
                    # K/V scatter clamp to the trash page instead of hitting
                    # its real, still-bound position-0 page.
                    table[stalled] = -1
                pages = torch.from_numpy(table).to(self.device)
            saved = self._save_lanes(caches, stalled) if stalled else None

        t0 = time.time()
        tokens = torch.from_numpy(col).to(self.device)
        positions = torch.from_numpy(pos).to(self.device)
        if pages is not None:
            logits, next_ids, new_caches = self._serve(
                self.params, tokens, caches, positions, pages)
        else:
            logits, next_ids, new_caches = self._serve(
                self.params, tokens, caches, positions)
        next_ids = next_ids.cpu().numpy()  # device sync, outside the lock
        if self.step_latency_s:
            # benchmark knob: emulate an accelerator-bound step on hosts
            # where the smoke model underruns real device latency.
            time.sleep(self.step_latency_s)
        dt = time.time() - t0

        with self._lock:
            if stalled:
                # the garbage lane also advanced per-slot state (recurrent
                # ssd/rglru h/conv, ring K/V at index 0) — roll those lanes
                # back to the pre-step copies so a stalled slot resumes
                # exactly where it paused.
                new_caches = self._restore_lanes(new_caches, saved, stalled)
            self.caches = new_caches
            self.steps += 1
            finished = []
            n_tokens = 0
            now = time.time()
            for i in stepped:
                s = self.slots[i]
                if s.done or s.gen != gens[i]:
                    continue  # evicted (and possibly re-filled) mid-flight
                s.position += 1
                if s.position < len(s.prompt):
                    continue  # still prefill-feeding
                tok = int(next_ids[i])
                s.tokens.append(tok)
                self.tokens_out += 1
                n_tokens += 1
                if not s.got_first_token:
                    s.got_first_token = True
                    if self._m is not None:
                        self._m["ttft"].observe(max(0.0, now - s.arrival_ts))
                if (len(s.tokens) >= s.max_new
                        or (self.eos_id is not None and tok == self.eos_id)
                        or s.position >= self.max_len - 1):
                    s.done = True
                    if self.allocator is not None:
                        self.allocator.release(i)
                    self._event("completed")
                    finished.append((s.request_id, list(s.tokens)))
            self._recent.append((now, n_tokens))
            if self._m is not None:
                self._m["step"].observe(dt)
                if n_tokens:
                    self._m["tokens"].inc(n_tokens)
                self._m["slots_active"].set(len(self._active()))
                if self.allocator is not None:
                    self._m["pages_used"].set(self.allocator.used_pages)
            return finished

    def throughput_tokens_s(self, window_s: float = 5.0) -> float:
        """Recent generation rate (host-side ring of per-step counts) —
        the router's fallback signal when the telemetry store is cold."""
        now = time.time()
        pts = [(t, n) for t, n in self._recent if t >= now - window_s]
        if len(pts) < 2:
            return 0.0
        span = pts[-1][0] - pts[0][0]
        return sum(n for _, n in pts) / max(span, 1e-6)

    def stats(self) -> dict:
        with self._lock:
            return {
                "replica": self.replica,
                "steps": self.steps,
                "tokens_out": self.tokens_out,
                "active_slots": len(self._active()),
                "n_slots": self.n_slots,
                "pages_used": (self.allocator.used_pages
                               if self.allocator else None),
                "pages_free": (self.allocator.free_pages
                               if self.allocator else None),
            }

    def run_until_drained(self, pending: list[tuple[str, list[int], int]],
                          max_steps: int = 10_000) -> dict[str, list[int]]:
        """Continuous batching over a request list: join-on-arrival."""
        results: dict[str, list[int]] = {}
        queue = deque(pending)  # popleft is O(1); list.pop(0) was O(n) per
        for _ in range(max_steps):  # admit, O(n²) over a long request log
            while queue and self.add_request(*queue[0]):
                queue.popleft()
            done = self.step()
            for rid, toks in done:
                results[rid] = toks
            if not queue and not self._active():
                break
        return results


@register_script("serve_request")
class ServeRequestComputing(ClusterComputing):
    """KSA task wrapper: one task = one generation request batch. Agents that
    own a ServeEngine process these; used by examples/serve_batch.py.

    Doubles as the *generate* stage of the serving pipeline: when run as a
    map stage, the tokenize stage's result arrives as ``params["upstream"]``
    and carries the request list."""

    engine: ServeEngine | None = None  # injected per-process

    def run(self) -> Any:
        if type(self).engine is None:
            raise RuntimeError("serving agent has no engine attached")
        requests = self.params.get("requests")
        if requests is None:
            requests = (self.params.get("upstream") or {}).get("requests", [])
        reqs = [(r["id"], list(r["prompt"]), int(r.get("max_new", 8)))
                for r in requests]
        t0 = time.time()
        results = type(self).engine.run_until_drained(reqs)
        dt = time.time() - t0
        return {"results": {k: v for k, v in results.items()},
                "tokens_per_s": sum(len(v) for v in results.values()) /
                                max(dt, 1e-9)}


# ---------------------------------------------------------------------------
# serving as a pipeline: tokenize → generate → post-process
# ---------------------------------------------------------------------------
#
# The same workload-agnostic DAG machinery that runs the knot campaign runs
# the serving path: raw texts fan out into tokenize batches (pure CPU), each
# tokenized batch maps 1:1 onto a generate task (the model-owning stage), and
# a join barrier assembles the response set. This is the AlphaKnot web-service
# pattern (§4) with the ParaFold-style CPU/accelerator stage split.

@register_script("serve_tokenize")
class ServeTokenizeComputing(ClusterComputing):
    """Pipeline stage 1 (source, fan-out): byte-level toy tokenizer.
    params: batch = [{"id", "text", "max_new"?}], vocab_size, max_new."""

    def run(self) -> Any:
        vocab = int(self.params.get("vocab_size", 256))
        default_max_new = int(self.params.get("max_new", 8))
        requests = []
        for r in self.params.get("batch", []):
            text = str(r.get("text", ""))
            prompt = [ord(c) % vocab for c in text] or [0]
            requests.append({"id": r["id"], "prompt": prompt,
                             "max_new": int(r.get("max_new",
                                                  default_max_new))})
        self.check_cancel()
        return {"requests": requests,
                "prompt_tokens": sum(len(r["prompt"]) for r in requests)}


@register_script("serve_postprocess")
class ServePostprocessComputing(ClusterComputing):
    """Pipeline stage 3 (join): merge every generate result into one
    response set with campaign-level throughput stats."""

    def run(self) -> Any:
        upstream = dict(self.params.get("upstream") or {})
        merged: dict[str, list[int]] = {}
        for r in upstream.get("generate", []):
            if r:
                merged.update(r.get("results", {}))
        self.check_cancel()
        return {
            "responses": {rid: {"tokens": toks, "n_tokens": len(toks)}
                          for rid, toks in sorted(merged.items())},
            "n_requests": len(merged),
            "total_tokens": sum(len(t) for t in merged.values()),
        }


def serve_pipeline(batch_size: int = 4, *, vocab_size: int = 256,
                   max_new: int = 8, max_in_flight: int | None = 1,
                   max_attempts: int = 3,
                   task_timeout_s: float | None = None):
    """Serving as a 3-stage DAG over raw-text items:
    tokenize (fan-out) → generate (map, model-owning pool) → post-process
    (join). ``max_in_flight`` defaults to 1 on generate so a single engine
    is never oversubscribed (backpressure at the stage level).

    The generate stage declares ``Resources(gpus=1)``, so under the default
    placement policy its tasks land on the ``-new.gpu`` class topic and only
    GPU-profiled (engine-owning) workers lease them, while tokenize and
    post-process drain on the CPU pool — the ParaFold split, wired through
    ``KsaCluster(gpu_workers=1, ...)`` or an explicit GPU ResourceProfile."""
    from repro_torch.core import Resources
    from repro_torch.pipeline import PipelineSpec, RetryPolicy, Stage

    retry = RetryPolicy(max_attempts=max_attempts, timeout_s=task_timeout_s)
    return PipelineSpec("serve", [
        Stage("tokenize", "serve_tokenize", fan_out=batch_size,
              params={"vocab_size": vocab_size, "max_new": max_new},
              resources=Resources(cpus=1), retry=retry),
        Stage("generate", "serve_request", depends_on=("tokenize",),
              resources=Resources(cpus=2, gpus=1, mem_mb=4096),
              max_in_flight=max_in_flight, retry=retry),
        Stage("postprocess", "serve_postprocess", depends_on=("generate",),
              join=True, retry=retry),
    ])
