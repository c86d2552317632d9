"""Replicated serving: N continuous-batching engines behind one router.

``ServeReplicaSet`` owns N :class:`~repro_torch.serve.engine.ServeEngine` replicas,
each driven by its own loop (a local thread via :meth:`start`, or a
long-running KSA task on a ``serve``-tainted worker pool via :meth:`deploy`
— the pool is exclusive, so batch work never steals serving cycles and vice
versa). Requests enter through :meth:`submit`:

* **routing** — least projected queue wait, where the projection divides the
  replica's queued work (prompt + generation tokens ahead) by its recent
  token rate. The rate comes from the telemetry plane when available
  (``TimeSeriesStore.rate("ksa_serve_tokens_total", {"replica": ...})``)
  and falls back to the engine's host-side ring buffer while the store is
  cold;
* **SLO-aware admission** — when a TTFT :class:`~repro_torch.obs.slo.SloSpec` is
  configured and even the best replica's projected wait exceeds the
  objective, the request is **shed** (rejected immediately, so the client
  can retry elsewhere) or **spilled** (handed to ``spill_to``, e.g. a
  federated remote site) instead of silently blowing the latency budget.

Admission into a slot is token-level (every driver iteration admits from
its queue before stepping), and the engines' lock discipline means a
client calling ``submit`` never blocks behind a jitted device call.

Request accounting is exact: every submitted request ends exactly one of
completed/shed/spilled, and double-resolution (a lost lease re-running a
generation) is counted in ``duplicates`` — the load-gen campaign asserts
both stay at zero lost / zero double-run.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable

from repro_torch.core import ClusterComputing, Resources, register_script
from repro_torch.core.scheduling import ResourceProfile

from .engine import ServeEngine

__all__ = ["PendingRequest", "ServeReplicaSet", "ServeReplicaComputing",
           "ServeLoadGenComputing", "ttft_slo"]


def ttft_slo(objective_s: float, q: float = 0.95):
    """A TTFT latency SLO for the serving tier: p``q`` of
    ``ksa_serve_ttft_seconds`` stays under ``objective_s``. Usable both for
    admission (:class:`ServeReplicaSet`) and alerting
    (:class:`~repro_torch.obs.slo.AlertEngine`)."""
    from repro_torch.obs.slo import SloSpec
    return SloSpec(name="serve-ttft", metric="ksa_serve_ttft_seconds",
                   objective=objective_s, kind="threshold", q=q)


@dataclass
class PendingRequest:
    """Client-side handle: resolves to the generated tokens (or a shed /
    spilled verdict) when the replica finishes."""
    request_id: str
    prompt: list[int]
    max_new: int
    arrival_ts: float
    status: str = "queued"      # queued | done | shed | spilled
    tokens: list[int] | None = None
    replica: int | None = None
    _event: threading.Event = field(default_factory=threading.Event)

    def wait(self, timeout: float | None = None) -> bool:
        return self._event.wait(timeout)

    @property
    def resolved(self) -> bool:
        return self._event.is_set()


class ServeReplicaSet:
    """N serving replicas, one router, exact request accounting."""

    def __init__(self, cfg, params, *, n_replicas: int = 2,
                 engine_kw: dict | None = None,
                 ttft_slo: Any = None, on_violation: str = "shed",
                 spill_to: Callable[[PendingRequest], None] | None = None,
                 registry: Any = None, store: Any = None,
                 rate_window_s: float = 10.0):
        if on_violation not in ("queue", "shed", "spill"):
            raise ValueError(f"unknown on_violation {on_violation!r}")
        kw = dict(engine_kw or {})
        self.engines = [ServeEngine(cfg, params, replica=f"r{i}",
                                    registry=registry, **kw)
                        for i in range(n_replicas)]
        self.n_replicas = n_replicas
        self.ttft_slo = ttft_slo
        self.on_violation = on_violation
        self.spill_to = spill_to
        self.store = store
        self.rate_window_s = rate_window_s
        self._queues: list[deque] = [deque() for _ in range(n_replicas)]
        self._pending: dict[str, PendingRequest] = {}
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._threads: list[threading.Thread] = []
        self._deployed: tuple | None = None
        self.submitted = 0
        self.completed = 0
        self.shed = 0
        self.spilled = 0
        self.duplicates = 0

    # -- routing / admission ----------------------------------------------

    def _rate_tokens_s(self, r: int) -> float:
        if self.store is not None:
            rate = self.store.rate("ksa_serve_tokens_total",
                                   {"replica": f"r{r}"}, self.rate_window_s)
            if rate > 0:
                return rate
        return self.engines[r].throughput_tokens_s()

    def projected_wait_s(self, r: int) -> float:
        """Estimated queue wait on replica ``r``: tokens of work already
        queued ahead, over the replica's recent token rate. 0 while the
        replica is cold (no rate signal yet — admit optimistically)."""
        with self._lock:
            queued = sum(len(p.prompt) + p.max_new for p in self._queues[r])
        if queued == 0:
            return 0.0
        rate = self._rate_tokens_s(r)
        if rate <= 0.0:
            return 0.0
        return queued / rate

    def submit(self, request_id: str, prompt: list[int],
               max_new: int = 16) -> PendingRequest:
        limit = min(e.max_len for e in self.engines)
        if len(prompt) >= limit:
            # reject in the client's thread: an unfittable request reaching
            # the driver loop would raise there and kill the replica.
            raise ValueError(
                f"request {request_id!r} prompt has {len(prompt)} tokens "
                f"but the replicas' max_len={limit} leaves no decode "
                "position")
        p = PendingRequest(request_id=request_id, prompt=list(prompt),
                           max_new=max_new, arrival_ts=time.time())
        waits = [self.projected_wait_s(r) for r in range(self.n_replicas)]
        best = min(range(self.n_replicas),
                   key=lambda r: (waits[r], len(self._queues[r])))
        with self._lock:
            if request_id in self._pending:
                raise ValueError(f"duplicate request id {request_id!r}")
            self.submitted += 1
            budget = (self.ttft_slo.objective
                      if self.ttft_slo is not None else None)
            if (budget is not None and waits[best] > budget
                    and self.on_violation != "queue"):
                if self.on_violation == "spill" and self.spill_to is not None:
                    p.status = "spilled"
                    self.spilled += 1
                    self.engines[best]._event("spilled")
                else:
                    p.status = "shed"
                    self.shed += 1
                    self.engines[best]._event("shed")
                self._pending[request_id] = p
                p._event.set()
            else:
                p.replica = best
                self._pending[request_id] = p
                self._queues[best].append(p)
        if p.status == "spilled":
            self.spill_to(p)
        return p

    # -- replica drivers ---------------------------------------------------

    def _drive_once(self, r: int) -> bool:
        """One driver iteration: admit from the queue, step, resolve.
        Returns True if there was any work."""
        eng = self.engines[r]
        q = self._queues[r]
        while True:
            with self._lock:
                if not q:
                    break
                head = q[0]
            if not eng.add_request(head.request_id, head.prompt,
                                   head.max_new,
                                   arrival_ts=head.arrival_ts):
                break
            with self._lock:
                if q and q[0] is head:
                    q.popleft()
        finished = eng.step()
        for rid, toks in finished:
            self._resolve(rid, toks)
        with self._lock:
            busy = bool(q) or bool(eng._active())
        return busy or bool(finished)

    def _resolve(self, rid: str, tokens: list[int]) -> None:
        with self._lock:
            p = self._pending.get(rid)
            if p is None:
                self.duplicates += 1
                return
            if p.resolved:
                self.duplicates += 1
                return
            p.tokens = tokens
            p.status = "done"
            self.completed += 1
            p._event.set()

    def _drive_loop(self, r: int,
                    check_cancel: Callable[[], None] | None = None) -> dict:
        while not self._stop.is_set():
            if check_cancel is not None:
                check_cancel()
            if not self._drive_once(r):
                time.sleep(0.002)
        return self.engines[r].stats()

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> "ServeReplicaSet":
        """Drive every replica with a local thread."""
        self._stop.clear()
        self._threads = [
            threading.Thread(target=self._drive_loop, args=(r,),
                             name=f"serve-replica-{r}", daemon=True)
            for r in range(self.n_replicas)]
        for t in self._threads:
            t.start()
        return self

    def deploy(self, cluster, *, taint: str = "serve") -> list[str]:
        """Run each replica driver as a long-lived KSA task on a
        ``taint``-tainted worker pool behind ``cluster``. The cluster must
        know the class: ``KsaCluster(placement=ResourceClassPolicy(
        extra_classes=("serve",)))``. One pool with ``n_replicas`` slots
        (not N single-slot pools: replica tasks are keyed records, and
        Kafka-style partition affinity can hash every driver onto one
        member's partitions — a saturated single-slot member would strand
        the rest forever). Returns the replica task ids (they complete when
        :meth:`stop` is called)."""
        ServeReplicaComputing.replica_set = self
        self._stop.clear()
        n = self.n_replicas
        cluster.add_worker(
            profile=ResourceProfile(cpus=n, mem_mb=1024 * n,
                                    labels=(taint,), taints=(taint,)),
            slots=n)
        ids = [cluster.submit("serve_replica", params={"replica": r},
                              resources=Resources(cpus=1, mem_mb=1024,
                                                  labels=(taint,)))
               for r in range(n)]
        self._deployed = (cluster, ids)
        return ids

    def stop(self, timeout: float = 30.0) -> None:
        self._stop.set()
        for t in self._threads:
            t.join(timeout)
        self._threads = []
        if self._deployed is not None:
            cluster, ids = self._deployed
            cluster.wait_all(ids, timeout=timeout)
            self._deployed = None

    def __enter__(self) -> "ServeReplicaSet":
        return self.start()

    def __exit__(self, *exc: Any) -> None:
        self.stop()

    # -- accounting --------------------------------------------------------

    def drain(self, timeout: float = 60.0) -> bool:
        """Wait until every submitted request has resolved."""
        deadline = time.time() + timeout
        with self._lock:
            pending = list(self._pending.values())
        for p in pending:
            if not p.wait(max(0.0, deadline - time.time())):
                return False
        return True

    @property
    def lost(self) -> int:
        """Requests unaccounted for (must be 0 after a clean drain)."""
        return self.submitted - self.completed - self.shed - self.spilled

    def describe(self) -> dict:
        return {
            "replicas": self.n_replicas,
            "submitted": self.submitted,
            "completed": self.completed,
            "shed": self.shed,
            "spilled": self.spilled,
            "duplicates": self.duplicates,
            "lost": self.lost,
            "engines": [e.stats() for e in self.engines],
        }


@register_script("serve_replica")
class ServeReplicaComputing(ClusterComputing):
    """One long-lived task = one replica driver, leased by a serve-tainted
    worker. The replica set is process-local state (the same injection
    pattern as ``ServeRequestComputing.engine``); the task pins the replica
    loop to the exclusive pool so the broker's lease/telemetry machinery
    sees the serving tier like any other workload."""

    replica_set: ServeReplicaSet | None = None  # injected by deploy()

    def run(self) -> Any:
        set_ = type(self).replica_set
        if set_ is None:
            raise RuntimeError("serve_replica task has no replica set "
                               "attached")
        r = int(self.params["replica"])
        return set_._drive_loop(r, check_cancel=self.check_cancel)


@register_script("serve_loadgen")
class ServeLoadGenComputing(ClusterComputing):
    """Load-generation client: submits ``n_requests`` deterministic prompts
    against the process-local replica set and waits for them all — run as a
    batch of concurrent tasks on the CPU pool, it is the campaign that
    drives the serving tier while the replicas run on their tainted pool.

    params: client (id), n_requests, prompt_len, max_new, vocab_size,
    inter_arrival_s."""

    replica_set: ServeReplicaSet | None = None  # injected per-process

    def run(self) -> Any:
        set_ = type(self).replica_set
        if set_ is None:
            raise RuntimeError("serve_loadgen task has no replica set "
                               "attached")
        client = str(self.params.get("client", "c0"))
        n = int(self.params.get("n_requests", 8))
        plen = int(self.params.get("prompt_len", 6))
        max_new = int(self.params.get("max_new", 8))
        vocab = int(self.params.get("vocab_size", 256))
        gap = float(self.params.get("inter_arrival_s", 0.0))
        timeout = float(self.params.get("timeout_s", 60.0))
        pending = []
        for j in range(n):
            prompt = [(17 * (j + 1) + 31 * k + len(client)) % vocab
                      for k in range(plen)]
            pending.append(set_.submit(f"{client}-{j}", prompt, max_new))
            if gap:
                time.sleep(gap)
            self.check_cancel()
        out = {"completed": 0, "shed": 0, "spilled": 0, "timed_out": 0,
               "tokens": 0}
        for p in pending:
            if not p.wait(timeout):
                out["timed_out"] += 1
                continue
            out[p.status if p.status != "done" else "completed"] += 1
            out["tokens"] += len(p.tokens or [])
        return out
