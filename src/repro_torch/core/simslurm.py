"""SimSlurm — a faithful, in-process simulator of the Slurm subset KSA uses.

The paper's ClusterAgent talks to Slurm exclusively through the unprivileged
command-line interface (``sbatch`` / ``squeue`` / ``scancel`` — §5 stresses
that no Slurm REST API, Kafka plugin, or C library is required). SimSlurm
models exactly that surface:

* a cluster of ``nodes × cpus_per_node`` (+ optional GPUs and per-node
  memory),
* a FIFO queue with per-job resource requests; jobs start when a node has
  free cpu/gpu slots *and* free memory (first-fit packing, like a
  single-partition Slurm with ``SelectType=cons_tres`` — memory is a packed
  resource, not a hint),
* job states ``PD`` (pending) → ``R`` (running) → ``CD`` (completed) /
  ``F`` (failed) / ``CA`` (cancelled) / ``TO`` (walltime timeout),
* ``scancel``, per-job walltime limits, and a global scheduler tick.

It runs submitted Python callables on a thread pool sized to the simulated
slot count, so "a Slurm job" really executes work — which is what lets the
oversubscription benchmark and the Celery-comparison benchmark (paper §2/§7)
measure real utilization numbers.
"""
from __future__ import annotations

import itertools
import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Any, Callable


@dataclass
class NodeState:
    name: str
    cpus: int
    gpus: int
    free_cpus: int
    free_gpus: int
    mem_mb: int = 0
    free_mem_mb: int = 0
    up_at: float = 0.0  # node boots at this wall-clock time (spin-up latency)

    @property
    def up(self) -> bool:
        return time.time() >= self.up_at


@dataclass
class Job:
    job_id: int
    name: str
    fn: Callable[[], Any]
    cpus: int
    gpus: int
    walltime_s: float | None
    user: str
    mem_mb: int = 0
    state: str = "PD"  # PD | R | CD | F | CA | TO
    node: str | None = None
    submitted_at: float = field(default_factory=time.time)
    started_at: float | None = None
    ended_at: float | None = None
    future: Future | None = None
    cancel_event: threading.Event = field(default_factory=threading.Event)

    @property
    def pending(self) -> bool:
        return self.state == "PD"

    @property
    def active(self) -> bool:
        return self.state in ("PD", "R")


class SimSlurm:
    """A single-partition simulated cluster.

    ``speedup`` scales simulated walltimes for fast tests/benchmarks: a task
    that declares ``duration`` sleeps ``duration / speedup`` wall seconds but
    is accounted at full duration in utilization stats.
    """

    def __init__(self, nodes: int = 4, cpus_per_node: int = 8,
                 gpus_per_node: int = 0, mem_mb_per_node: int | None = None,
                 scheduler_interval_s: float = 0.01,
                 spinup_s: float = 0.0):
        # default memory sizes the node to its cpu count at the control
        # plane's default request (1024 MB/task), so cpu-bound workloads
        # pack exactly as before memory became a packed resource.
        if mem_mb_per_node is None:
            mem_mb_per_node = 1024 * cpus_per_node
        # ``spinup_s`` models node provisioning latency (powering on a
        # drained partition / cloud-bursting a node): jobs queue PD until
        # the node is up, which is exactly the cold-start cost an elastic
        # autoscaler must weigh before scaling a Slurm pool to zero.
        up_at = time.time() + spinup_s
        self.spinup_s = spinup_s
        self.nodes = [
            NodeState(f"node{i:03d}", cpus_per_node, gpus_per_node,
                      cpus_per_node, gpus_per_node,
                      mem_mb_per_node, mem_mb_per_node, up_at=up_at)
            for i in range(nodes)
        ]
        self.total_cpus = nodes * cpus_per_node
        self._jobs: dict[int, Job] = {}
        self._ids = itertools.count(1)
        self._lock = threading.RLock()
        self._pool = ThreadPoolExecutor(max_workers=self.total_cpus,
                                        thread_name_prefix="simslurm")
        self._interval = scheduler_interval_s
        self._stop = threading.Event()
        self._sched = threading.Thread(target=self._scheduler_loop,
                                       name="simslurm-sched", daemon=True)
        self._busy_cpu_seconds = 0.0
        self._t0 = time.time()
        self._sched.start()

    # -- the unprivileged CLI surface ---------------------------------------

    def sbatch(self, fn: Callable[..., Any], *, name: str = "job",
               cpus: int = 1, gpus: int = 0, mem_mb: int = 0,
               walltime_s: float | None = None,
               user: str = "user") -> int:
        """Submit a job; returns the Slurm job id. ``fn`` may accept a
        ``cancel_event`` kwarg to observe scancel/timeout. ``mem_mb`` is
        packed per node like cpus/gpus (0 = no memory demand)."""
        with self._lock:
            job = Job(next(self._ids), name, fn, cpus, gpus, walltime_s,
                      user, mem_mb=mem_mb)
            self._jobs[job.job_id] = job
            return job.job_id

    def squeue(self, user: str | None = None,
               states: tuple[str, ...] | None = None) -> list[Job]:
        with self._lock:
            out = [j for j in self._jobs.values() if j.active]
            if user is not None:
                out = [j for j in out if j.user == user]
            if states is not None:
                out = [j for j in out if j.state in states]
            return sorted(out, key=lambda j: j.job_id)

    def scancel(self, job_id: int) -> bool:
        with self._lock:
            job = self._jobs.get(job_id)
            if job is None or not job.active:
                return False
            if job.state == "PD":
                job.state = "CA"
                job.ended_at = time.time()
            else:
                job.cancel_event.set()  # running: cooperative cancel
                job.state = "CA"
            return True

    def job(self, job_id: int) -> Job | None:
        with self._lock:
            return self._jobs.get(job_id)

    def sinfo(self) -> dict:
        with self._lock:
            return {
                "nodes": len(self.nodes),
                "nodes_up": sum(n.up for n in self.nodes),
                "total_cpus": self.total_cpus,
                "free_cpus": sum(n.free_cpus for n in self.nodes),
                "free_mem_mb": sum(n.free_mem_mb for n in self.nodes),
                "pending": sum(j.state == "PD" for j in self._jobs.values()),
                "running": sum(j.state == "R" for j in self._jobs.values()),
            }

    # -- scheduler ------------------------------------------------------------

    def _try_place(self, job: Job) -> NodeState | None:
        for node in self.nodes:  # first-fit over cpus, gpus, and memory
            if not node.up:
                continue  # still spinning up: jobs stay PD (cold start)
            if node.free_cpus >= job.cpus and node.free_gpus >= job.gpus \
                    and node.free_mem_mb >= job.mem_mb:
                return node
        return None

    def _scheduler_loop(self) -> None:
        while not self._stop.is_set():
            with self._lock:
                pending = [j for j in self._jobs.values() if j.state == "PD"]
                pending.sort(key=lambda j: j.job_id)  # FIFO
                for job in pending:
                    node = self._try_place(job)
                    if node is None:
                        continue
                    node.free_cpus -= job.cpus
                    node.free_gpus -= job.gpus
                    node.free_mem_mb -= job.mem_mb
                    job.state = "R"
                    job.node = node.name
                    job.started_at = time.time()
                    job.future = self._pool.submit(self._run_job, job)
                # walltime enforcement
                now = time.time()
                for job in self._jobs.values():
                    if (job.state == "R" and job.walltime_s is not None
                            and job.started_at is not None
                            and now - job.started_at > job.walltime_s):
                        job.cancel_event.set()
                        job.state = "TO"
            self._stop.wait(self._interval)

    def _run_job(self, job: Job) -> None:
        try:
            try:
                job.fn(cancel_event=job.cancel_event)  # type: ignore[call-arg]
            except TypeError as te:
                if "cancel_event" not in str(te):
                    raise
                job.fn()
            ok = True
        except Exception:
            ok = False
        with self._lock:
            if job.state == "R":  # not already CA/TO
                job.state = "CD" if ok else "F"
            job.ended_at = time.time()
            if job.started_at is not None:
                self._busy_cpu_seconds += (job.ended_at - job.started_at) * job.cpus
            node = next(n for n in self.nodes if n.name == job.node)
            node.free_cpus += job.cpus
            node.free_gpus += job.gpus
            node.free_mem_mb += job.mem_mb

    # -- accounting -------------------------------------------------------------

    def utilization(self) -> float:
        """busy cpu-seconds / available cpu-seconds since construction."""
        with self._lock:
            elapsed = max(time.time() - self._t0, 1e-9)
            running = sum(
                (time.time() - j.started_at) * j.cpus
                for j in self._jobs.values()
                if j.state == "R" and j.started_at is not None)
            return (self._busy_cpu_seconds + running) / (elapsed * self.total_cpus)

    def wait_all(self, timeout: float = 60.0) -> bool:
        deadline = time.time() + timeout
        while time.time() < deadline:
            with self._lock:
                if not any(j.active for j in self._jobs.values()):
                    return True
            time.sleep(self._interval)
        return False

    def shutdown(self) -> None:
        self._stop.set()
        self._sched.join(timeout=2.0)
        self._pool.shutdown(wait=False, cancel_futures=True)
