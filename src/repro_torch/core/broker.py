"""Embedded Kafka-like durable log — the communication layer of the KSA
control plane.

The paper uses an external Apache Kafka broker as the single piece of shared
infrastructure ("the only requirement is that an Apache Kafka broker be
exposed and accessible from every cluster node or workstation", §1). This
module provides an embedded broker with the same *semantics* so the framework
is dependency-free in this container while keeping the exact API shape of
kafka-python (``producer.send`` / ``consumer.poll`` / ``commit`` / ``seek``)
behind a transport seam — a real Kafka client can be substituted by
implementing the same five methods on :class:`Broker`.

Faithfully implemented Kafka semantics the paper relies on (§3, §6):

* topics split into **partitions**; records carry ``(topic, partition,
  offset)`` coordinates; keyed records hash to a stable partition,
* **consumer groups** with committed offsets per ``(group, topic, partition)``;
  two groups each see every record (broadcast — the paper's "multiple
  MonitorAgents, each receiving a copy"), members of one group load-balance
  partitions (the paper's "each result retrieved and handled by only one of
  the active MonitorAgents"),
* **cooperative rebalance** on membership change (agent joins/leaves/dies) with
  a bumped generation — this is what makes the agent pool *elastic*,
* **at-least-once** (commit after processing; redelivery after a crash) vs
  **exactly-once** (atomic process+produce+commit transaction) selected per
  consumer — the configurability the paper cites as the reason Kafka was
  chosen,
* optional **durability**: per-partition segment files (length-prefixed
  msgpack frames) with replay on restart, plus a committed-offset log; message
  retention is bounded by ``retention_records`` per partition (§6 mentions the
  broker-side retention policy) and can be overridden **per topic**
  (``create_topic(..., retention_records=None)`` pins a journal topic such as
  ``PREFIX-campaigns`` to infinite retention even under a broker-wide cap),
* **replay reads**: :meth:`Broker.read_from` scans a topic from an absolute
  offset outside any consumer group — the API the pipeline recovery path
  uses to fold the campaign journal after an orchestrator crash,
* **explicit prefix deletion**: :meth:`Broker.truncate_before` is the
  ``AdminClient.delete_records`` analogue journal compaction uses to drop
  snapshotted campaigns' events (durable logs persist a truncation marker),
* **incremental backlog counters**: :meth:`Broker.queue_stats` reports
  per-topic depth (produced − committed) for one consumer group from
  counters maintained on the produce/commit paths — the autoscaler's
  per-resource-class demand signal, with no O(records) scans,
* **task leases** (:mod:`repro_torch.core.lease`): every task record fetched
  through :meth:`Broker.lease_records` registers a :class:`~repro_torch.core.lease.Lease`
  (GRANTED → RUNNING → DONE/FAILED/REVOKED). :meth:`Broker.revoke_lease` is
  the single reclamation primitive — it fences the holder's commit, fires
  the task's ``cancel_event``, and (optionally) requeues the record onto
  the topic it was leased from, atomically under the task's lease-shard
  lock; every legacy stop-path (watchdog, drain, scancel/walltime, retry
  fencing, preemption, memory policing) routes through it.

Concurrency model — the sharded data plane
------------------------------------------

The broker used to serialize *every* operation (produce, fetch, grant,
commit, revoke, stats) under one ``threading.RLock``, which caps tasks/sec
far below partition-parallel Kafka. State is now sharded so independent
work never contends:

* **partition locks** (rank 2) — each partition log owns a lock protecting
  its record list, base/next offsets, and segment file. ``append``,
  ``fetch``, and ``truncate_before`` touch only the partition they
  address; ``produce`` never touches group state.
* **group locks** (rank 0) — each consumer group (``_Group.lock``)
  protects its membership, generation, assignment, committed offsets, and
  rebalances. Different groups never contend.
* **lease-shard locks** (rank 1) — the lease registry is a
  :class:`~repro_torch.core.lease.ShardedLeaseTable` hashed by task id;
  grant/claim/complete/revoke on different tasks proceed in parallel while
  every lifecycle op for one task serializes on its shard, preserving the
  per-task atomicity contracts (``complete_lease`` fencing,
  ``revoke_lease``'s fence+cancel+requeue critical section).
* **leaf locks** (unranked) — the registry lock (topic/group maps, member
  id sequence, holder-site tags), the offsets-file lock, and the waiter
  lock. Leaf critical sections are tiny and never acquire a ranked lock.

**Lock-acquisition order**: group (0) → lease shard (1) → partition (2);
a thread may only acquire a ranked lock whose rank is strictly above every
ranked lock it holds (two same-rank locks only in ascending key order —
which the code never needs: partition locks are taken one at a time).
The hot paths: ``lease_records`` holds the group lock while taking
partition locks one at a time for the atomic fetch+commit (0 → 2), then
*releases* the group lock and grants leases in one batched critical
section per lease shard; ``revoke_lease`` requeues the record by producing
inside the task's shard lock (1 → 2). Histogram observes and span appends
happen outside all broker locks (the obs layer has its own short locks).

``debug_locks=True`` wraps every ranked lock in an order-asserting wrapper
that raises :class:`LockOrderError` on a hierarchy violation (e.g. the
group lock acquired while a partition lock is held) — used by the
concurrency stress tests. ``single_lock=True`` is the escape hatch: every
lock aliases one master ``RLock`` and the data plane follows the original
per-record path (fixed-order assignment walk, per-record grants and
observes under the lock) — for debugging lock-sensitive issues and as the
legacy baseline in ``benchmarks/bench_broker.py``.

Blocking fetches use per-topic waiter events instead of one broker-wide
condition variable: a produce wakes only waiters subscribed to that topic
(consumers arm their waiter *before* re-checking, so no wakeup is lost);
rebalances broadcast to all waiters.
"""
from __future__ import annotations

import hashlib
import io
import os
import struct
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Iterable, Mapping, Sequence

from repro_torch.obs import (FlightRecorder, MetricsRegistry, NullSpanStore,
                       SpanStore, topic_class)

from .lease import ShardedLeaseTable


def _msgpack():
    """msgpack, imported only where the durable-log paths (``log_dir``)
    use it, so an in-memory broker runs where msgpack is not installed."""
    import msgpack
    return msgpack


# --------------------------------------------------------------------------
# Records
# --------------------------------------------------------------------------


@dataclass(frozen=True)
class Record:
    topic: str
    partition: int
    offset: int
    key: str | None
    value: Any
    timestamp: float


@dataclass(frozen=True)
class TopicPartition:
    topic: str
    partition: int


class BrokerError(RuntimeError):
    pass


class UnknownTopicError(BrokerError):
    pass


class FencedError(BrokerError):
    """Raised when a consumer from an old generation tries to commit."""


class LockOrderError(RuntimeError):
    """A ``debug_locks=True`` broker detected a lock-hierarchy violation:
    a ranked lock was acquired at or below the rank of one already held
    (e.g. the group lock inside a partition lock, or a second partition
    lock out of key order)."""


def _hash_key(key: str, n: int) -> int:
    h = hashlib.md5(key.encode("utf-8")).digest()
    return int.from_bytes(h[:4], "big") % n


# --------------------------------------------------------------------------
# Lock hierarchy (debug mode) + data waiters
# --------------------------------------------------------------------------

# ranks in the broker lock hierarchy (see module docstring)
_RANK_GROUP = 0
_RANK_SHARD = 1
_RANK_PARTITION = 2

_HELD = threading.local()  # per-thread stack of held _OrderedLocks


class _OrderedLock:
    """RLock wrapper that asserts the broker's lock-acquisition order.

    Acquiring is legal only when this lock's ``(rank, key)`` is strictly
    above every ranked lock the thread already holds (re-entrant
    re-acquisition of a held lock is always legal). Violations raise
    :class:`LockOrderError` *before* blocking, so the stress tests turn a
    potential deadlock into a deterministic failure."""

    __slots__ = ("_lock", "rank", "key")

    def __init__(self, rank: int, key: tuple) -> None:
        self._lock = threading.RLock()
        self.rank = rank
        self.key = key

    def __enter__(self) -> "_OrderedLock":
        stack = getattr(_HELD, "stack", None)
        if stack is None:
            stack = _HELD.stack = []
        if not any(held is self for _, _, held in stack):
            for rank, key, _held in stack:
                if rank > self.rank or (rank == self.rank
                                        and key >= self.key):
                    raise LockOrderError(
                        f"acquiring lock {self.rank}:{self.key} while "
                        f"holding {rank}:{key} violates the order "
                        "group(0) -> shard(1) -> partition(2)")
        self._lock.acquire()
        stack.append((self.rank, self.key, self))
        return self

    def __exit__(self, *exc) -> None:
        stack = _HELD.stack
        for i in range(len(stack) - 1, -1, -1):
            if stack[i][2] is self:
                del stack[i]
                break
        self._lock.release()


class _DataWaiter:
    """One consumer's registered wakeup slot: an event set by produces to
    any of ``topics`` (``None`` = any topic) and by rebalances. The owner
    arms (``clear``) *before* re-checking for data, then waits — a produce
    landing between the check and the wait is never lost."""

    __slots__ = ("_event", "topics")

    def __init__(self, topics: tuple | None) -> None:
        self._event = threading.Event()
        self.topics = topics

    def clear(self) -> None:
        self._event.clear()

    def set(self) -> None:
        self._event.set()

    def wait(self, timeout: float | None = None) -> bool:
        return self._event.wait(timeout)


# --------------------------------------------------------------------------
# Partition log (+ optional segment-file durability)
# --------------------------------------------------------------------------

_FRAME = struct.Struct("<I")

_UNSET = object()  # create_topic sentinel: "use the broker-wide retention"


class _PartitionLog:
    """Append-only in-memory log with an optional on-disk segment file.

    Owns its lock (rank 2 in the broker hierarchy): ``append``, ``fetch``,
    ``truncate_before`` and ``close`` are internally synchronized, so two
    partitions never contend with each other. ``end_offset`` reads a
    single int (GIL-atomic) lock-free — it is a monotonic counter, safe
    for the backlog math that clamps downstream."""

    def __init__(self, topic: str, partition: int, log_dir: str | None,
                 retention_records: int | None, fsync: bool,
                 lock: Any = None):
        self.topic = topic
        self.partition = partition
        self.lock = lock if lock is not None else threading.RLock()
        self.records: list[Record] = []
        self.base_offset = 0  # offset of records[0] after retention trimming
        self.next_offset = 0
        self.retention = retention_records
        self._fsync = fsync
        self._fh: io.BufferedWriter | None = None
        if log_dir is not None:
            os.makedirs(log_dir, exist_ok=True)
            path = os.path.join(log_dir, f"{topic}-{partition}.log")
            self._replay(path)
            self._fh = open(path, "ab")

    def _replay(self, path: str) -> None:
        if not os.path.exists(path):
            return
        with open(path, "rb") as fh:
            data = fh.read()
        pos = 0
        while pos + _FRAME.size <= len(data):
            (length,) = _FRAME.unpack_from(data, pos)
            pos += _FRAME.size
            if pos + length > len(data):
                break  # truncated tail frame (crash mid-write): drop it
            frame = _msgpack().unpackb(data[pos:pos + length], raw=False)
            pos += length
            if "trunc" in frame:  # truncation marker (see truncate_before)
                cut = int(frame["trunc"])
                self.records = [r for r in self.records if r.offset >= cut]
                self.base_offset = max(self.base_offset, cut)
                continue
            self.records.append(Record(
                topic=self.topic, partition=self.partition,
                offset=frame["o"], key=frame.get("k"), value=frame["v"],
                timestamp=frame.get("t", 0.0)))
        if self.records:
            self.base_offset = max(self.base_offset, self.records[0].offset)
            self.next_offset = self.records[-1].offset + 1
        else:
            self.next_offset = max(self.next_offset, self.base_offset)

    def append(self, key: str | None, value: Any, ts: float) -> Record:
        with self.lock:
            rec = Record(self.topic, self.partition, self.next_offset, key,
                         value, ts)
            self.records.append(rec)
            self.next_offset += 1
            if self._fh is not None:
                frame = _msgpack().packb(
                    {"o": rec.offset, "k": key, "v": value, "t": ts},
                    use_bin_type=True)
                self._fh.write(_FRAME.pack(len(frame)))
                self._fh.write(frame)
                self._fh.flush()
                if self._fsync:
                    os.fsync(self._fh.fileno())
            if self.retention is not None \
                    and len(self.records) > self.retention:
                drop = len(self.records) - self.retention
                self.records = self.records[drop:]
                self.base_offset = self.records[0].offset
            return rec

    def fetch(self, offset: int, max_records: int) -> list[Record]:
        """Records from ``offset`` (clamped to the retained base), at most
        ``max_records``. The slice is taken — and therefore *copied* —
        under the partition lock, so callers hold an immutable snapshot: a
        concurrent ``truncate_before`` or retention trim can never be
        observed mid-iteration."""
        with self.lock:
            offset = max(offset, self.base_offset)
            idx = offset - self.base_offset
            if idx >= len(self.records):
                return []
            return self.records[idx: idx + max_records]

    def end_offset(self) -> int:
        return self.next_offset  # single int read: GIL-atomic, lock-free

    def truncate_before(self, offset: int) -> int:
        """Drop every retained record with offset < ``offset`` (Kafka's
        ``deleteRecords`` semantics). Returns the number of records dropped.
        Durable logs append a truncation marker frame so a restart does not
        resurrect the deleted prefix."""
        with self.lock:
            offset = min(offset, self.next_offset)
            if offset <= self.base_offset:
                return 0
            drop = min(offset - self.base_offset, len(self.records))
            self.records = self.records[drop:]
            self.base_offset = offset
            if self._fh is not None and drop:
                frame = _msgpack().packb({"trunc": offset}, use_bin_type=True)
                self._fh.write(_FRAME.pack(len(frame)))
                self._fh.write(frame)
                self._fh.flush()
                if self._fsync:
                    os.fsync(self._fh.fileno())
            return drop

    def close(self) -> None:
        with self.lock:
            if self._fh is not None:
                self._fh.close()
                self._fh = None


# --------------------------------------------------------------------------
# Consumer groups
# --------------------------------------------------------------------------


@dataclass
class _Member:
    member_id: str
    topics: tuple[str, ...]
    last_heartbeat: float = field(default_factory=time.time)
    # rotating start index into this member's assignment for lease_records:
    # a fixed-order walk starves trailing partitions whenever max_records
    # is exhausted early, so each call starts one partition further along
    lease_cursor: int = 0


@dataclass
class _Group:
    group_id: str
    members: dict[str, _Member] = field(default_factory=dict)
    generation: int = 0
    assignment: dict[str, list[TopicPartition]] = field(default_factory=dict)
    committed: dict[TopicPartition, int] = field(default_factory=dict)
    # rank-0 lock guarding everything above (see broker docstring)
    lock: Any = field(default_factory=threading.RLock)


class Broker:
    """Thread-safe embedded broker with a sharded data plane (see the
    module docstring for the lock hierarchy). All public methods may be
    called from any thread; blocking fetches use per-topic waiter events so
    co-located agents see ~zero poll latency (the paper's polling-interval
    overhead, §6, collapses when the broker is embedded) and a produce
    wakes only consumers of that topic.

    ``single_lock=True`` restores the original one-big-RLock data plane
    (debug escape hatch + benchmark baseline); ``debug_locks=True`` makes
    every ranked lock assert the acquisition order (raises
    :class:`LockOrderError`); ``lease_shards`` sizes the lease registry's
    hash sharding."""

    def __init__(self, log_dir: str | None = None, *,
                 default_partitions: int = 4,
                 retention_records: int | None = None,
                 session_timeout_s: float = 10.0,
                 fsync: bool = False,
                 obs: bool = True,
                 site: str = "",
                 single_lock: bool = False,
                 debug_locks: bool = False,
                 lease_shards: int = 8):
        self.single_lock = bool(single_lock)
        # a single lock cannot violate an order; the wrapper would only
        # slow the baseline down, so debug mode implies the sharded plane
        self._debug_locks = bool(debug_locks) and not self.single_lock
        self._master: threading.RLock | None = (
            threading.RLock() if self.single_lock else None)
        # leaf locks (unranked): tiny critical sections, never held while
        # acquiring a ranked lock. In single-lock mode the registry and
        # offsets locks alias the master so everything serializes as before.
        self._registry_lock: Any = self._master or threading.Lock()
        self._offsets_lock: Any = self._master or threading.Lock()
        self._waiters_lock = threading.Lock()
        self._topic_waiters: dict[str, set[_DataWaiter]] = {}
        self._global_waiters: set[_DataWaiter] = set()
        self._topics: dict[str, list[_PartitionLog]] = {}
        self._groups: dict[str, _Group] = {}
        self._log_dir = log_dir
        self._default_partitions = default_partitions
        self._retention = retention_records
        self._fsync = fsync
        self.session_timeout_s = session_timeout_s
        self._member_seq = 0
        # observability substrate (repro_torch.obs): the broker owns the one
        # registry and span store every co-located component shares.
        # obs=False nulls histograms and spans; counters stay live (the
        # legacy stats views are built on them).
        self.metrics = MetricsRegistry(enabled=obs)
        self.spans = SpanStore() if obs else NullSpanStore()
        self._h_queue_wait = self.metrics.histogram(
            "ksa_task_queue_wait_seconds",
            "Record produce -> lease grant wait, per resource class",
            labels=("cls",))
        self._h_claim = self.metrics.histogram(
            "ksa_lease_claim_latency_seconds",
            "Lease grant -> claim (execution start), per resource class",
            labels=("cls",))
        self._h_run = self.metrics.histogram(
            "ksa_task_run_seconds",
            "Claim -> commit execution time, per resource class",
            labels=("cls",))
        self.metrics.register_callback(
            "ksa_leases_active",
            lambda: self.lease_stats()["active"],
            "Live (GRANTED/RUNNING) leases")
        # crash flight recorder (repro_torch.obs.blackbox): always on — event
        # appends are one deque op — so post-mortems exist even when the
        # telemetry plane is not enabled
        self.blackbox = FlightRecorder()
        self._lease_table = ShardedLeaseTable(
            metrics=self.metrics,
            shards=1 if self.single_lock else max(1, int(lease_shards)),
            lock_factory=lambda i: self._make_lock(_RANK_SHARD,
                                                   ("shard", i)))
        # per-topic cache of (cls, queue-wait child, claim child, run child)
        # so the grant path resolves topic_class + histogram labels once per
        # topic, not once per record (benign last-write-wins under the GIL)
        self._topic_obs_cache: dict[str, tuple] = {}
        # federation: which site this broker belongs to ("" = standalone),
        # and which consumer-group members hold their leases from a remote
        # site — registered by federation bridges so every lease they are
        # granted is stamped with the holder's site and WAN-tolerant
        # heartbeat deadline (consulted by the watchdogs before revoking)
        self.site = site
        self._holder_sites: dict[str, tuple[str, float | None]] = {}
        self._closed = False
        self._offsets_path = (os.path.join(log_dir, "_offsets.log")
                              if log_dir else None)
        if self._offsets_path:
            self._replay_offsets()

    # -- locks / registries --------------------------------------------------

    def _make_lock(self, rank: int, key: tuple) -> Any:
        """One ranked lock of the hierarchy: the master RLock in
        ``single_lock`` mode, an order-asserting wrapper in ``debug_locks``
        mode, a plain RLock otherwise."""
        if self.single_lock:
            return self._master
        if self._debug_locks:
            return _OrderedLock(rank, key)
        return threading.RLock()

    def _topic_logs(self, topic: str) -> list[_PartitionLog]:
        """The topic's partition list, auto-creating like Kafka's
        ``auto.create.topics.enable``. Topics are create-only and a
        partition list is immutable once published, so the fast path is a
        lock-free dict read."""
        logs = self._topics.get(topic)
        if logs is not None:
            return logs
        with self._registry_lock:
            logs = self._topics.get(topic)
            if logs is None:
                logs = self._new_partition_logs(
                    topic, self._default_partitions, self._retention)
                self._topics[topic] = logs
            return logs

    def _new_partition_logs(self, name: str, n: int,
                            retention: int | None) -> list[_PartitionLog]:
        return [
            _PartitionLog(name, p, self._log_dir, retention, self._fsync,
                          lock=self._make_lock(_RANK_PARTITION,
                                               ("partition", name, p)))
            for p in range(n)
        ]

    def _group(self, group_id: str, create: bool = False) -> _Group | None:
        """Lock-free group lookup (groups are create-only); ``create``
        falls back to a registry-locked setdefault."""
        grp = self._groups.get(group_id)
        if grp is not None or not create:
            return grp
        with self._registry_lock:
            grp = self._groups.get(group_id)
            if grp is None:
                grp = _Group(group_id,
                             lock=self._make_lock(_RANK_GROUP,
                                                  ("group", group_id)))
                self._groups[group_id] = grp
            return grp

    # -- topics ------------------------------------------------------------

    def create_topic(self, name: str, partitions: int | None = None,
                     retention_records: int | None | object = _UNSET) -> None:
        """Create a topic (idempotent). ``retention_records`` overrides the
        broker-wide retention for this topic (``None`` = keep every record —
        what a replayable journal topic needs); on an existing topic an
        explicit value updates the retention in place."""
        existed = False
        with self._registry_lock:
            if name in self._topics:
                existed = True
            else:
                n = partitions or self._default_partitions
                retention = (self._retention if retention_records is _UNSET
                             else retention_records)
                self._topics[name] = self._new_partition_logs(
                    name, n, retention)
        if existed and retention_records is not _UNSET:
            self.set_retention(name, retention_records)

    def set_retention(self, topic: str,
                      retention_records: int | None) -> None:
        """Re-bound (or unbound, with ``None``) one topic's per-partition
        retention. Loosening takes effect immediately; tightening trims on
        the next append."""
        for plog in self._topic_logs(topic):
            with plog.lock:
                plog.retention = retention_records

    def topics(self) -> list[str]:
        with self._registry_lock:
            return sorted(self._topics)

    def partitions_for(self, topic: str) -> int:
        return len(self._topic_logs(topic))

    # -- produce / fetch ----------------------------------------------------

    def least_loaded_partition(self, topic: str) -> int:
        """The partition with the fewest records ever produced — the same
        choice unkeyed :meth:`produce` makes. Lets a submitter balance
        *keyed* records (task records must stay keyed for lease granting)
        across partitions instead of hashing, trading per-key placement
        stability for an even per-member share."""
        logs = self._topic_logs(topic)
        return min(range(len(logs)), key=lambda p: logs[p].end_offset())

    def produce(self, topic: str, value: Any, key: str | None = None,
                partition: int | None = None) -> Record:
        """Append one record. Touches only the target partition's lock —
        never group state — then wakes waiters of this topic."""
        logs = self._topic_logs(topic)
        if partition is None:
            if key is not None:
                partition = _hash_key(key, len(logs))
            else:
                partition = min(range(len(logs)),
                                key=lambda p: logs[p].end_offset())
        rec = logs[partition].append(key, value, time.time())
        self._notify(topic)
        return rec

    def fetch(self, tp: TopicPartition, offset: int,
              max_records: int = 500) -> list[Record]:
        return self._topic_logs(tp.topic)[tp.partition].fetch(
            offset, max_records)

    def end_offset(self, tp: TopicPartition) -> int:
        return self._topic_logs(tp.topic)[tp.partition].end_offset()

    def read_from(self, topic: str, offset: int = 0, *,
                  partition: int | None = None) -> list[Record]:
        """Group-less replay read: every retained record of ``topic`` with
        offset ≥ ``offset`` (all partitions unless one is named), ordered by
        ``(partition, offset)``. No consumer group, no committed offsets —
        the caller owns its position. This is the recovery-path API: a
        restarted orchestrator folds the ``PREFIX-campaigns`` journal from
        here (per-campaign order is per-partition order because journal
        records are keyed by campaign id)."""
        logs = self._topic_logs(topic)
        parts = logs if partition is None else [logs[partition]]
        out: list[Record] = []
        for plog in parts:  # one partition lock at a time (inside fetch)
            out.extend(plog.fetch(offset, 1 << 62))
        return out

    def truncate_before(self, topic: str, offset: int, *,
                        partition: int | None = None) -> int:
        """Delete every retained record of ``topic`` with offset < ``offset``
        (one partition, or all of them) — the embedded analogue of Kafka's
        ``AdminClient.delete_records``, used by journal compaction to bound
        the ``PREFIX-campaigns`` topic after terminal campaigns have been
        snapshotted. Returns the number of records dropped. Committed
        offsets are untouched; fetches below the new base offset clamp
        forward to it."""
        logs = self._topic_logs(topic)
        parts = logs if partition is None else [logs[partition]]
        return sum(p.truncate_before(offset) for p in parts)

    # -- data waiters --------------------------------------------------------

    def data_waiter(self, topics: Sequence[str] | None = None) -> _DataWaiter:
        """Register a wakeup slot for produces to ``topics`` (``None`` =
        any topic) and rebalance broadcasts. Consumers arm it (``clear``)
        *before* re-checking for data, wait on it, and must
        :meth:`release_waiter` it when done."""
        w = _DataWaiter(tuple(topics) if topics else None)
        with self._waiters_lock:
            if w.topics is None:
                self._global_waiters.add(w)
            else:
                for t in w.topics:
                    self._topic_waiters.setdefault(t, set()).add(w)
        return w

    def release_waiter(self, w: _DataWaiter) -> None:
        with self._waiters_lock:
            if w.topics is None:
                self._global_waiters.discard(w)
                return
            for t in w.topics:
                ws = self._topic_waiters.get(t)
                if ws is not None:
                    ws.discard(w)
                    if not ws:
                        del self._topic_waiters[t]

    def _notify(self, topic: str) -> None:
        """Wake waiters of one topic (plus topic-agnostic waiters). The
        empty-registry fast path is lock-free so an unwatched produce pays
        nothing."""
        if not self._topic_waiters and not self._global_waiters:
            return
        with self._waiters_lock:
            targets = list(self._topic_waiters.get(topic, ()))
            targets.extend(self._global_waiters)
        for w in targets:
            w.set()

    def _notify_all(self) -> None:
        """Broadcast (rebalance / membership change): assignments moved, so
        every blocked consumer must re-check what it owns."""
        with self._waiters_lock:
            targets = [w for ws in self._topic_waiters.values() for w in ws]
            targets.extend(self._global_waiters)
        for w in targets:
            w.set()

    def wait_for_data(self, timeout: float,
                      topics: Sequence[str] | None = None) -> None:
        """Block until a record is produced to one of ``topics`` (any topic
        if ``None``), a rebalance broadcasts, or the timeout elapses.
        One-shot convenience over :meth:`data_waiter` — for loop use,
        register a waiter once and arm it per iteration (see
        :meth:`Consumer.poll`)."""
        w = self.data_waiter(topics)
        try:
            w.wait(timeout)
        finally:
            self.release_waiter(w)

    # -- backlog accounting (autoscaling signal) -----------------------------

    def queue_stats(self, group_id: str,
                    topics: Sequence[str] | None = None
                    ) -> dict[str, dict[str, int]]:
        """Per-topic backlog of one consumer group, from counters the broker
        already maintains incrementally (partition end offsets and committed
        offsets) — O(topics × partitions) with **no record scans**, safe to
        poll at control-loop frequency.

        For each topic: ``produced`` is the cumulative record count appended
        since topic creation (monotonic — retention trimming does not rewind
        it), ``consumed`` is the cumulative count the group has committed,
        and ``depth`` = produced − consumed is the queue backlog. The
        autoscaler's per-resource-class demand signal is the ``depth`` of
        each ``PREFIX-new.<class>`` topic under the shared agents group;
        drain *rate* falls out of successive ``consumed`` samples."""
        grp = self._groups.get(group_id)
        names = list(topics) if topics is not None else self.topics()
        out: dict[str, dict[str, int]] = {}
        for t in names:
            produced, consumed = self._topic_counters(grp, t)
            out[t] = {"produced": produced,
                      "consumed": min(consumed, produced),
                      "depth": max(0, produced - consumed)}
        return out

    def _topic_counters(self, grp: _Group | None,
                        topic: str) -> tuple[int, int]:
        """(cumulative produced, cumulative committed) for one topic/group —
        the single definition of the backlog counters behind queue_stats()
        and the per-group ``lag`` in stats(). Lock-free: end offsets and
        committed offsets are monotonic ints read GIL-atomically, and the
        callers clamp (``consumed ≤ produced``, ``depth ≥ 0``) so a read
        torn across partitions stays sane."""
        logs = self._topic_logs(topic)
        produced = sum(p.end_offset() for p in logs)
        consumed = 0
        if grp is not None:
            committed = grp.committed
            consumed = sum(committed.get(TopicPartition(topic, p), 0)
                           for p in range(len(logs)))
        return produced, consumed

    # -- consumer groups ----------------------------------------------------

    def join_group(self, group_id: str, topics: Sequence[str],
                   member_id: str | None = None) -> tuple[str, int]:
        """Register a member; returns (member_id, generation). Triggers a
        rebalance (range assignor over the union of subscribed topics)."""
        for t in topics:
            self._topic_logs(t)  # ensure before assignment math
        grp = self._group(group_id, create=True)
        if member_id is None:
            with self._registry_lock:
                self._member_seq += 1
                member_id = f"{group_id}-member-{self._member_seq}"
        with grp.lock:
            grp.members[member_id] = _Member(member_id, tuple(topics))
            self._rebalance(grp)
            return member_id, grp.generation

    def leave_group(self, group_id: str, member_id: str) -> None:
        grp = self._groups.get(group_id)
        if grp is None:
            return
        with grp.lock:
            if member_id in grp.members:
                del grp.members[member_id]
                self._rebalance(grp)

    def heartbeat(self, group_id: str, member_id: str) -> int:
        """Refresh liveness; returns current generation (consumer compares to
        detect rebalances). Also lazily evicts dead members."""
        grp = self._groups.get(group_id)
        if grp is None:
            raise FencedError(f"unknown member {member_id} in {group_id}")
        with grp.lock:
            if member_id not in grp.members:
                raise FencedError(f"unknown member {member_id} in {group_id}")
            grp.members[member_id].last_heartbeat = time.time()
            self._evict_dead(grp)
            return grp.generation

    def _evict_dead(self, grp: _Group) -> None:
        # caller holds grp.lock
        now = time.time()
        dead = [m for m, st in grp.members.items()
                if now - st.last_heartbeat > self.session_timeout_s]
        for m in dead:
            del grp.members[m]
        if dead:
            self._rebalance(grp)

    def evict_expired_members(self) -> None:
        """Watchdog entry point: evict all session-expired members (elastic
        downscale path — the broker notices a dead agent and reassigns its
        partitions to the survivors)."""
        with self._registry_lock:
            groups = list(self._groups.values())
        for grp in groups:  # one group lock at a time
            with grp.lock:
                self._evict_dead(grp)

    def _rebalance(self, grp: _Group) -> None:
        # sticky (cooperative) assignor: a membership change moves only the
        # partitions that *must* move — to a joining member, or away from a
        # departed one. A live member keeps the partitions it is mid-lease
        # on (up to its fair share), which is what makes elastic pool growth
        # duplication-free: the paper's eager-style full reshuffle would
        # hand a just-fetched partition to the new member, whose refetch
        # from the committed offset re-runs the in-flight task.
        prev = {m: set(tps) for m, tps in grp.assignment.items()}
        grp.generation += 1
        grp.assignment = {m: [] for m in grp.members}
        if not grp.members:
            return
        members = sorted(grp.members)
        topics = sorted({t for m in grp.members.values() for t in m.topics})
        for topic in topics:
            subs = [m for m in members if topic in grp.members[m].topics]
            if not subs:
                continue
            nparts = len(self._topics[topic])
            # exact fair shares: every member gets floor or floor+1, with
            # the +1 quotas going to the members holding the most already
            # (maximum stickiness at perfect balance)
            floor, rem = divmod(nparts, len(subs))
            held = {m: sum(1 for tp in prev.get(m, ())
                           if tp.topic == topic) for m in subs}
            by_held = sorted(subs, key=lambda m: (-held[m], m))
            quota = {m: floor + (1 if i < rem else 0)
                     for i, m in enumerate(by_held)}
            counts = {m: 0 for m in subs}
            owner_of: dict[int, str] = {}
            for p in range(nparts):  # sticky pass: keep current owners
                tp = TopicPartition(topic, p)
                for m in subs:
                    if tp in prev.get(m, ()) and counts[m] < quota[m]:
                        owner_of[p] = m
                        counts[m] += 1
                        break
            for p in range(nparts):  # place the rest, least-loaded first
                if p in owner_of:
                    continue
                m = min(subs, key=lambda s: (counts[s] - quota[s], s))
                owner_of[p] = m
                counts[m] += 1
            for p in sorted(owner_of):
                grp.assignment[owner_of[p]].append(TopicPartition(topic, p))
        self._notify_all()

    def assignment(self, group_id: str, member_id: str) -> list[TopicPartition]:
        grp = self._groups.get(group_id)
        if grp is None:
            return []
        with grp.lock:
            if member_id not in grp.members:
                return []
            return list(grp.assignment.get(member_id, []))

    def generation(self, group_id: str) -> int:
        grp = self._groups.get(group_id)
        return grp.generation if grp else 0

    # -- offsets -------------------------------------------------------------

    def _check_fence(self, grp: _Group,
                     offsets: Mapping[TopicPartition, int],
                     member_id: str | None, generation: int | None) -> None:
        """Cooperative-rebalance fencing: a commit from a stale generation
        is still valid for partitions the member *retained* across the
        bump (membership churn elsewhere in the group — e.g. an autoscaler
        growing the pool mid-poll — must not void a live member's lease).
        Only a commit for a partition the member no longer owns is fenced."""
        if generation is None or generation == grp.generation:
            return
        owned = set(grp.assignment.get(member_id or "", []))
        lost = [tp for tp in offsets if tp not in owned]
        if lost:
            raise FencedError(
                f"commit from stale generation {generation} "
                f"(current {grp.generation}) for reassigned partitions "
                f"{[(tp.topic, tp.partition) for tp in lost]}")

    def commit(self, group_id: str, offsets: Mapping[TopicPartition, int],
               member_id: str | None = None,
               generation: int | None = None) -> None:
        grp = self._group(group_id, create=True)
        with grp.lock:
            self._check_fence(grp, offsets, member_id, generation)
            for tp, off in offsets.items():
                grp.committed[tp] = off
            self._persist_offsets(group_id, offsets)

    def committed(self, group_id: str, tp: TopicPartition) -> int:
        grp = self._groups.get(group_id)
        if grp is None:
            return 0
        return grp.committed.get(tp, 0)

    def lease_records(self, group_id: str, member_id: str,
                      max_records: int = 500) -> list[Record]:
        """Atomic fetch+commit ("lease") for one group member: records come
        from the committed offset of each partition the member owns *right
        now*, and the offsets advance in the same critical section. A
        concurrent rebalance therefore can never hand an already-leased
        record to another member — the poll-then-commit window that makes
        eager-rebalance consumers re-run in-flight work during membership
        churn (exactly what an autoscaler growing the pool would trigger).
        This is the task-leasing path agents use; observers (monitor,
        pipeline) keep at-least-once poll()/commit().

        Sharded hot path: the group lock covers only the fetch+commit
        (partition locks taken one at a time inside it, start index
        rotated per call so trailing partitions can't starve); lease
        grants then run in one batched critical section per lease shard,
        and histogram/span observes happen outside all broker locks."""
        if self.single_lock:
            return self._lease_records_legacy(group_id, member_id,
                                              max_records)
        grp = self._groups.get(group_id)
        if grp is None:
            raise FencedError(f"unknown member {member_id} in {group_id}")
        out: list[Record] = []
        with grp.lock:
            member = grp.members.get(member_id)
            if member is None:
                raise FencedError(f"unknown member {member_id} in {group_id}")
            member.last_heartbeat = time.time()
            assigned = grp.assignment.get(member_id, [])
            n = len(assigned)
            updates: dict[TopicPartition, int] = {}
            if n:
                start = member.lease_cursor % n
                member.lease_cursor = start + 1
                budget = max_records
                for k in range(n):
                    if budget <= 0:
                        break
                    tp = assigned[(start + k) % n]
                    off = grp.committed.get(tp, 0)
                    recs = self._topics[tp.topic][tp.partition].fetch(
                        off, budget)
                    if recs:
                        out.extend(recs)
                        updates[tp] = recs[-1].offset + 1
                        grp.committed[tp] = updates[tp]
                        budget -= len(recs)
            if updates:
                self._persist_offsets(group_id, updates)
        if out:
            self._grant_and_observe(out, member_id)
        return out

    def _grant_and_observe(self, records: list[Record],
                           member_id: str) -> None:
        """Batched lease grants for just-leased records + vectorized
        observability. Runs *after* the group lock is released: the records
        are already this member's responsibility (offsets committed), and
        any claim/revoke race on a not-yet-granted lease falls into the
        lease table's existing stale-sibling / tombstone fencing."""
        task_recs = [r for r in records
                     # task records (keyed, self-describing) get a GRANTED
                     # lease — the handle every stop-path revokes through
                     if r.key and isinstance(r.value, dict)
                     and r.value.get("task_id") == r.key]
        if not task_recs:
            return
        h_site, h_deadline = self._holder_sites.get(
            member_id, (self.site, None))
        now = time.time()
        pairs = self._lease_table.grant_batch(
            task_recs, member_id, site=h_site, deadline_s=h_deadline,
            now=now)
        # vectorized observes, one histogram lock hold per class and one
        # span-store lock hold per batch — never inside a broker lock
        waits: dict[str, tuple] = {}
        spans: list[dict] = []
        last_topic, obs = None, None
        for rec, lease in pairs:
            if lease is None:
                continue
            # the grant span's duration IS the queue wait:
            # record append -> this lease
            if rec.topic != last_topic:
                last_topic = rec.topic
                obs = self._topic_obs(rec.topic)
            cls = obs[0]
            wait = now - rec.timestamp
            w = waits.get(cls)
            if w is None:
                w = waits[cls] = (obs[1], [])
            w[1].append(wait)
            trace = rec.value.get("trace") or {}
            spans.append((rec.key, {
                "name": "grant", "task_id": rec.key,
                "start": rec.timestamp, "end": now,
                "dur_s": wait if wait > 0.0 else 0.0,
                "attempt": lease.attempt, "holder": member_id,
                "topic": rec.topic, "cls": cls,
                "trace_id": trace.get("trace_id", rec.key)}))
        for h_wait, vals in waits.values():
            h_wait.observe_many(vals)
        if spans:
            self.spans.add_batch(spans)
            # blackbox: grants are recorded count-level per batch — one
            # ring slot per poll, not per task, so grant volume cannot
            # wash the interesting (revocation/drain) events out
            self.blackbox.record("grants", holder=member_id,
                                 count=len(spans))

    def _topic_obs(self, topic: str) -> tuple:
        """Cached ``(cls, queue-wait, claim, run)`` histogram children for
        one topic — topic_class parsing and label interning happen once per
        topic, not once per record."""
        t = self._topic_obs_cache.get(topic)
        if t is None:
            cls = topic_class(topic)
            t = (cls,
                 self._h_queue_wait.labels(cls=cls),
                 self._h_claim.labels(cls=cls),
                 self._h_run.labels(cls=cls))
            self._topic_obs_cache[topic] = t
        return t

    def _lease_records_legacy(self, group_id: str, member_id: str,
                              max_records: int) -> list[Record]:
        """The seed's single-lock data plane, preserved verbatim as the
        ``single_lock=True`` escape hatch and the benchmark baseline:
        fixed-order assignment walk (no rotation), per-record grants with a
        value copy, and per-record topic_class / label / observe / span
        work, all inside the master lock."""
        with self._master:
            grp = self._groups.get(group_id)
            if grp is None or member_id not in grp.members:
                raise FencedError(f"unknown member {member_id} in {group_id}")
            grp.members[member_id].last_heartbeat = time.time()
            out: list[Record] = []
            budget = max_records
            updates: dict[TopicPartition, int] = {}
            for tp in grp.assignment.get(member_id, []):
                if budget <= 0:
                    break
                off = grp.committed.get(tp, 0)
                recs = self._topics[tp.topic][tp.partition].fetch(off, budget)
                if recs:
                    out.extend(recs)
                    updates[tp] = recs[-1].offset + 1
                    grp.committed[tp] = updates[tp]
                    budget -= len(recs)
            if updates:
                self._persist_offsets(group_id, updates)
            now = time.time()
            for rec in out:
                if rec.key and isinstance(rec.value, dict) \
                        and rec.value.get("task_id") == rec.key:
                    h_site, h_deadline = self._holder_sites.get(
                        member_id, (self.site, None))
                    lease = self._lease_table.grant(
                        rec.key, member_id, rec.topic,
                        int(rec.value.get("attempt", 0)), dict(rec.value),
                        site=h_site, deadline_s=h_deadline)
                    if lease is not None:
                        # uncached class parse, per-record label lookup and
                        # observe — the per-record cost profile the sharded
                        # plane is benchmarked against
                        cls = topic_class.__wrapped__(rec.topic)
                        self._h_queue_wait.labels(cls=cls).observe(
                            now - rec.timestamp)
                        trace = rec.value.get("trace") or {}
                        self.spans.add(
                            rec.key, "grant", rec.timestamp, now,
                            attempt=lease.attempt, holder=member_id,
                            topic=rec.topic, cls=cls,
                            trace_id=trace.get("trace_id", rec.key))
            return out

    # -- task leases (repro_torch.core.lease) -------------------------------------

    def claim_start(self, task_id: str, holder: str, attempt: int,
                    cancel: Any, on_revoke: Callable[[], None] | None = None
                    ) -> bool:
        """GRANTED → RUNNING for the holder's lease, binding the task's
        ``cancel_event`` (and an optional ``on_revoke`` hook, e.g. the
        ClusterAgent's ``scancel``). False means the lease was revoked or
        superseded while queued — the holder must drop the task, its record
        has already been requeued (or belongs to someone else)."""
        ok, lease = self._lease_table.claim_start(task_id, holder, attempt,
                                                  cancel, on_revoke)
        if ok and lease is not None and lease.started_at is not None:
            if self.single_lock:
                with self._master:
                    cls = topic_class.__wrapped__(lease.topic)
                    self._h_claim.labels(cls=cls).observe(
                        lease.started_at - lease.granted_at)
                    self.spans.add(task_id, "claim", lease.granted_at,
                                   lease.started_at, attempt=attempt,
                                   holder=holder, cls=cls)
            else:
                # observes outside the shard lock (obs has its own locks)
                cls, _w, h_claim, _r = self._topic_obs(lease.topic)
                h_claim.observe(lease.started_at - lease.granted_at)
                self.spans.add(task_id, "claim", lease.granted_at,
                               lease.started_at, attempt=attempt,
                               holder=holder, cls=cls)
        return ok

    def complete_lease(self, task_id: str, holder: str | None = None,
                       attempt: int | None = None, *, ok: bool = True) -> bool:
        """The commit gate: atomically RUNNING → DONE/FAILED. Returns False
        when the lease was revoked (or superseded) — the holder's result or
        error is stale and must be suppressed, because the revocation
        already requeued the task."""
        committed, lease = self._lease_table.complete(task_id, holder,
                                                      attempt, ok)
        if committed and lease is not None and lease.started_at is not None:
            now = time.time()
            if self.single_lock:
                with self._master:
                    cls = topic_class.__wrapped__(lease.topic)
                    self._h_run.labels(cls=cls).observe(
                        now - lease.started_at)
                    self.spans.add(task_id, "run", lease.started_at, now,
                                   attempt=lease.attempt,
                                   holder=lease.holder, ok=ok, cls=cls)
            else:
                cls, _w, _c, h_run = self._topic_obs(lease.topic)
                h_run.observe(now - lease.started_at)
                self.spans.add(task_id, "run", lease.started_at, now,
                               attempt=lease.attempt, holder=lease.holder,
                               ok=ok, cls=cls)
        return committed

    def claim_start_batch(self, items: Sequence[tuple], holder: str,
                          cancel: Any,
                          on_revoke: Callable[[], None] | None = None
                          ) -> dict[str, bool]:
        """Batched :meth:`claim_start` for one holder starting a wave of
        tasks: ``items`` is ``[(task_id, attempt), ...]``; every claim binds
        the same ``cancel`` event / ``on_revoke`` hook. One lease-shard
        critical section per shard touched, one histogram flush per topic
        class and one span-store flush for the whole wave. Returns
        ``{task_id: ok}`` with exactly the per-task semantics of the scalar
        call."""
        if self.single_lock:
            # legacy plane: per-record claims under the master lock
            return {tid: self.claim_start(tid, holder, attempt, cancel,
                                          on_revoke)
                    for tid, attempt in items}
        results = self._lease_table.claim_start_batch(items, holder, cancel,
                                                      on_revoke)
        waits: dict[str, tuple] = {}
        spans: list[dict] = []
        out: dict[str, bool] = {}
        last_topic, obs = None, None
        for task_id, ok, lease in results:
            out[task_id] = ok
            if not ok or lease is None or lease.started_at is None:
                continue
            if lease.topic != last_topic:
                last_topic = lease.topic
                obs = self._topic_obs(lease.topic)
            cls = obs[0]
            dur = lease.started_at - lease.granted_at
            w = waits.get(cls)
            if w is None:
                w = waits[cls] = (obs[2], [])
            w[1].append(dur)
            spans.append((task_id, {
                "name": "claim", "task_id": task_id,
                "start": lease.granted_at, "end": lease.started_at,
                "dur_s": dur if dur > 0.0 else 0.0,
                "attempt": lease.attempt, "holder": holder, "cls": cls}))
        for h_claim, vals in waits.values():
            h_claim.observe_many(vals)
        if spans:
            self.spans.add_batch(spans)
        return out

    def complete_lease_batch(self, items: Sequence[tuple],
                             holder: str | None = None, *,
                             ok: bool = True) -> dict[str, bool]:
        """Batched :meth:`complete_lease`: ``items`` is ``[(task_id,
        attempt|None), ...]`` sharing one wave outcome ``ok`` — a holder
        commits its successes and failures as separate waves. One
        lease-shard critical section per shard touched and one vectorized
        obs flush for the whole wave; every entry passes through the same
        commit gate (holder/attempt fencing, completion tombstones) as the
        scalar call. Returns ``{task_id: committed}``."""
        if self.single_lock:
            return {tid: self.complete_lease(tid, holder, attempt, ok=ok)
                    for tid, attempt in items}
        results = self._lease_table.complete_batch(items, holder, ok)
        now = time.time()
        runs: dict[str, tuple] = {}
        spans: list[dict] = []
        out: dict[str, bool] = {}
        last_topic, obs = None, None
        for task_id, committed, lease in results:
            out[task_id] = committed
            if not committed or lease is None or lease.started_at is None:
                continue
            if lease.topic != last_topic:
                last_topic = lease.topic
                obs = self._topic_obs(lease.topic)
            cls = obs[0]
            dur = now - lease.started_at
            r = runs.get(cls)
            if r is None:
                r = runs[cls] = (obs[3], [])
            r[1].append(dur)
            spans.append((task_id, {
                "name": "run", "task_id": task_id,
                "start": lease.started_at, "end": now,
                "dur_s": dur if dur > 0.0 else 0.0,
                "attempt": lease.attempt, "holder": lease.holder,
                "ok": ok, "cls": cls}))
        for h_run, vals in runs.values():
            h_run.observe_many(vals)
        if spans:
            self.spans.add_batch(spans)
        return out

    def revoke_lease(self, task_id: str, reason: str, *,
                     requeue: bool = True) -> bool:
        """**The** reclamation primitive: atomically (one critical section)
        fence the holder's commit, fire the task's ``cancel_event`` /
        ``on_revoke`` hook, and — with ``requeue`` — put the task record
        back on the topic it was leased from (same attempt if it never
        started; bumped attempt if it was running, so the stale holder's
        status updates are fenced downstream too). Returns False when there
        is no live lease — already terminal, never leased, or lost the race
        to a concurrent :meth:`complete_lease` — in which case nothing is
        cancelled and nothing is requeued (a completed task is never
        double-run).

        The fence+cancel+requeue happens inside the task's lease-shard
        critical section (the requeue produce takes a partition lock
        *inside* the shard lock — the legal 1 → 2 order), so a revoked
        task is never both requeued and completed."""
        def _requeue(lease) -> None:
            value = dict(lease.value)
            if lease.started_at is not None:
                value["attempt"] = lease.attempt + 1
            self.produce(lease.topic, value, key=task_id)

        cb = _requeue if requeue else None
        if self.single_lock:
            with self._master:
                lease = self._lease_table.revoke(task_id, reason, cb)
        else:
            lease = self._lease_table.revoke(task_id, reason, cb)
        if lease is None:
            return False
        self.spans.add(task_id, "revoke",
                       lease.revoked_at, lease.revoked_at,
                       attempt=lease.attempt, holder=lease.holder,
                       reason=reason, requeued=requeue)
        # blackbox: every revocation, with its reason — the flight
        # recorder's storm detector auto-dumps on a burst of these
        self.blackbox.record("revocation", task_id=task_id, reason=reason,
                             holder=lease.holder, attempt=lease.attempt,
                             requeued=requeue)
        return True

    def register_holder_site(self, member_id: str, site: str,
                             deadline_s: float | None = None) -> None:
        """Tag a consumer-group member as executing on a (remote) federation
        site: every lease granted to ``member_id`` from now on is stamped
        with ``site`` and the WAN-tolerant heartbeat ``deadline_s`` (see
        :class:`~repro_torch.core.lease.LeaseTolerance`), which the MonitorAgent
        and PipelineAgent watchdogs honour instead of their uniform
        deadline. Idempotent; re-registering updates the deadline."""
        with self._registry_lock:
            self._holder_sites[member_id] = (site, deadline_s)

    def unregister_holder_site(self, member_id: str) -> None:
        """Drop a member's site tag (bridge drained/stopped). Leases already
        granted keep their stamp — their holder really is remote until they
        reach a terminal state."""
        with self._registry_lock:
            self._holder_sites.pop(member_id, None)

    def forget_lease(self, task_id: str, holder: str) -> None:
        """Drop the holder's lease without a verdict (misroute bounce: the
        rerouted record grants a fresh lease to whoever leases it)."""
        self._lease_table.forget(task_id, holder)

    def lease_view(self, task_id: str) -> dict | None:
        """Observability snapshot of one task's lease (None if untracked)."""
        return self._lease_table.get_view(task_id)

    def live_leases(self, task_ids: Sequence[str] | None = None,
                    holder: str | None = None) -> list[dict]:
        """Views of live (GRANTED/RUNNING) leases, optionally filtered —
        the preemption victim-selection query."""
        return self._lease_table.live_views(task_ids, holder)

    def lease_stats(self) -> dict:
        """Cumulative lease counters: granted/completed/failed/requeued and
        revocations by reason — the unified stop-path telemetry."""
        return self._lease_table.stats()

    # -- transactions (exactly-once) -----------------------------------------

    def transact(self, group_id: str, offsets: Mapping[TopicPartition, int],
                 produces: Iterable[tuple[str, Any, str | None]],
                 member_id: str | None = None,
                 generation: int | None = None) -> list[Record]:
        """Atomically: verify generation fencing, append all ``produces``
        ``(topic, value, key)``, and commit ``offsets``. Atomicity is with
        respect to the *group*: fence check, appends, and offset commits
        all happen under the group lock (produces take partition locks
        inside it — the legal 0 → 2 order), so no consumer of this group
        can observe the offsets without the produces, and a stale
        generation can never get either in."""
        grp = self._group(group_id, create=True)
        with grp.lock:
            # exactly-once keeps the *strict* generation fence: the relaxed
            # ownership check would let a member that lost and regained a
            # partition across two rebalances replay its produces (the
            # at-least-once commit path tolerates that; a transaction must
            # not)
            if generation is not None and generation != grp.generation:
                raise FencedError(
                    f"transaction from stale generation {generation} "
                    f"(current {grp.generation})")
            out = [self.produce(t, v, key=k) for (t, v, k) in produces]
            for tp, off in offsets.items():
                grp.committed[tp] = off
            self._persist_offsets(group_id, offsets)
            return out

    # -- offset durability -----------------------------------------------------

    def _persist_offsets(self, group_id: str,
                         offsets: Mapping[TopicPartition, int]) -> None:
        if not self._offsets_path:
            return
        with self._offsets_lock:  # leaf: serializes the shared offsets file
            with open(self._offsets_path, "ab") as fh:
                for tp, off in offsets.items():
                    frame = _msgpack().packb(
                        {"g": group_id, "t": tp.topic, "p": tp.partition,
                         "o": off},
                        use_bin_type=True)
                    fh.write(_FRAME.pack(len(frame)))
                    fh.write(frame)

    def _replay_offsets(self) -> None:
        path = self._offsets_path
        if not path or not os.path.exists(path):
            return
        with open(path, "rb") as fh:
            data = fh.read()
        pos = 0
        while pos + _FRAME.size <= len(data):
            (length,) = _FRAME.unpack_from(data, pos)
            pos += _FRAME.size
            if pos + length > len(data):
                break
            d = _msgpack().unpackb(data[pos:pos + length], raw=False)
            pos += length
            grp = self._group(d["g"], create=True)
            grp.committed[TopicPartition(d["t"], d["p"])] = d["o"]

    # -- lifecycle -------------------------------------------------------------

    def close(self) -> None:
        with self._registry_lock:
            if self._closed:
                return
            self._closed = True
            all_logs = [log for logs in self._topics.values()
                        for log in logs]
        for log in all_logs:  # partition locks taken inside close()
            log.close()

    # stats for the MonitorAgent REST API / benchmarks
    def stats(self) -> dict:
        with self._registry_lock:
            topic_snapshot = dict(self._topics)
            group_snapshot = dict(self._groups)

        def _lag(grp: _Group) -> dict[str, int]:
            # per-topic depth over the topics the group has touched —
            # the queue_stats counters, surfaced for /broker
            touched = sorted({tp.topic for tp in grp.committed} |
                             {t for m in grp.members.values()
                              for t in m.topics})
            out = {}
            for t in touched:
                if t not in topic_snapshot:
                    continue
                produced, consumed = self._topic_counters(grp, t)
                out[t] = max(0, produced - consumed)
            return out

        groups = {}
        for g, grp in group_snapshot.items():
            with grp.lock:  # one group lock at a time
                groups[g] = {
                    "members": sorted(grp.members),
                    "generation": grp.generation,
                    "committed": {
                        f"{tp.topic}:{tp.partition}": off
                        for tp, off in sorted(
                            grp.committed.items(),
                            key=lambda kv: (kv[0].topic, kv[0].partition))
                    },
                    "lag": _lag(grp),
                }
        return {
            "site": self.site,
            "topics": {
                t: {str(p): logs[p].end_offset() for p in range(len(logs))}
                for t, logs in topic_snapshot.items()
            },
            "groups": groups,
            "leases": self._lease_table.stats(),
        }


# --------------------------------------------------------------------------
# kafka-python-shaped clients
# --------------------------------------------------------------------------


class Producer:
    """API shape of ``kafka.KafkaProducer`` (paper §5 uses kafka-python-ng)."""

    def __init__(self, broker: Broker):
        self._broker = broker
        self._dead = False

    def send(self, topic: str, value: Any, key: str | None = None,
             partition: int | None = None) -> Record | None:
        if self._dead:  # simulated process death (see AgentBase.crash)
            return None
        return self._broker.produce(topic, value, key=key, partition=partition)

    def kill(self) -> None:
        """Test hook: silently drop all future sends, as a dead process would."""
        self._dead = True

    def flush(self) -> None:  # embedded log is synchronous; kept for API parity
        pass


class Consumer:
    """Group consumer with the kafka-python API shape.

    ``semantics`` selects the paper's delivery knob:

    * ``"at_least_once"`` — caller processes records then calls ``commit()``;
      a crash before commit redelivers (to whichever member owns the partition
      after the next rebalance).
    * ``"exactly_once"`` — caller uses :meth:`process_transactionally`, which
      runs the handler and atomically appends its output records + commits the
      input offsets under generation fencing.
    """

    def __init__(self, broker: Broker, topics: Sequence[str], group_id: str,
                 *, semantics: str = "at_least_once",
                 max_poll_records: int = 500,
                 member_id: str | None = None):
        if semantics not in ("at_least_once", "exactly_once"):
            raise ValueError(f"unknown semantics: {semantics}")
        self._broker = broker
        self._group = group_id
        self.semantics = semantics
        self._max_poll = max_poll_records
        self._topics = tuple(topics)
        self.member_id, self._generation = broker.join_group(
            group_id, topics, member_id=member_id)
        self._positions: dict[TopicPartition, int] = {}
        self._pending: dict[TopicPartition, int] = {}
        self._closed = False

    # -- assignment bookkeeping --------------------------------------------

    def _sync_assignment(self) -> list[TopicPartition]:
        gen = self._broker.heartbeat(self._group, self.member_id)
        if gen != self._generation:
            # rebalance happened: drop positions for partitions we lost,
            # re-seek newly acquired partitions to their committed offset.
            self._generation = gen
            self._positions = {}
            self._pending = {}
        assignment = self._broker.assignment(self._group, self.member_id)
        for tp in assignment:
            if tp not in self._positions:
                self._positions[tp] = self._broker.committed(self._group, tp)
        return assignment

    def assignment(self) -> list[TopicPartition]:
        return self._sync_assignment()

    # -- polling -------------------------------------------------------------

    def poll(self, timeout: float = 0.0,
             max_records: int | None = None) -> dict[TopicPartition, list[Record]]:
        if self._closed:
            raise BrokerError("consumer is closed")
        deadline = time.time() + timeout
        max_records = max_records or self._max_poll
        waiter = None
        try:
            while True:
                if waiter is not None:
                    waiter.clear()  # arm BEFORE checking: no lost wakeup
                out: dict[TopicPartition, list[Record]] = {}
                budget = max_records
                for tp in self._sync_assignment():
                    if budget <= 0:
                        break
                    recs = self._broker.fetch(tp, self._positions[tp], budget)
                    if recs:
                        out[tp] = recs
                        self._positions[tp] = recs[-1].offset + 1
                        self._pending[tp] = recs[-1].offset + 1
                        budget -= len(recs)
                if out or time.time() >= deadline:
                    return out
                if waiter is None:
                    # register, then loop once more: a produce that landed
                    # before registration is caught by the re-check
                    waiter = self._broker.data_waiter(self._topics)
                    continue
                waiter.wait(max(0.0, deadline - time.time()))
        finally:
            if waiter is not None:
                self._broker.release_waiter(waiter)

    # -- leasing (atomic fetch+commit) ------------------------------------------

    def lease(self, timeout: float = 0.0,
              max_records: int | None = None) -> list[Record]:
        """Fetch records with their offsets committed atomically (see
        :meth:`Broker.lease_records`) — the consumption mode for task
        *leasing*: once returned, a record is this member's responsibility
        and will never be redelivered by a rebalance. Liveness recovery for
        a member that dies after leasing is the watchdog's job, exactly the
        agents' two-level fault-tolerance contract."""
        if self._closed:
            raise BrokerError("consumer is closed")
        deadline = time.time() + timeout
        max_records = max_records or self._max_poll
        waiter = None
        try:
            while True:
                if waiter is not None:
                    waiter.clear()  # arm BEFORE checking: no lost wakeup
                if self._broker.single_lock:
                    # legacy data plane: heartbeat + assignment round trip
                    # per call, exactly as the seed consumer did
                    self._sync_assignment()
                # sharded plane: lease_records heartbeats internally and
                # reads the live assignment under the group lock — the
                # extra sync here would just be two more group-lock trips
                recs = self._broker.lease_records(self._group,
                                                  self.member_id,
                                                  max_records)
                if recs or time.time() >= deadline:
                    return recs
                if waiter is None:
                    waiter = self._broker.data_waiter(self._topics)
                    continue
                waiter.wait(max(0.0, deadline - time.time()))
        finally:
            if waiter is not None:
                self._broker.release_waiter(waiter)

    # -- offsets ---------------------------------------------------------------

    def commit(self) -> None:
        """At-least-once commit of everything returned by previous polls."""
        if self._pending:
            self._broker.commit(self._group, dict(self._pending),
                                member_id=self.member_id,
                                generation=self._generation)
            self._pending = {}

    def seek(self, tp: TopicPartition, offset: int) -> None:
        self._positions[tp] = offset

    def position(self, tp: TopicPartition) -> int:
        return self._positions.get(tp, self._broker.committed(self._group, tp))

    # -- exactly-once -----------------------------------------------------------

    def process_transactionally(
        self, handler: Callable[[list[Record]], Iterable[tuple[str, Any, str | None]]],
        timeout: float = 0.0,
    ) -> int:
        """Poll once; run ``handler(records) -> [(topic, value, key), ...]``;
        atomically append outputs and commit inputs. Returns #records
        processed. If the handler raises, nothing commits (pure redelivery)."""
        batches = self.poll(timeout)
        records = [r for recs in batches.values() for r in recs]
        if not records:
            return 0
        produces = list(handler(records))
        self._broker.transact(self._group, dict(self._pending), produces,
                              member_id=self.member_id,
                              generation=self._generation)
        self._pending = {}
        return len(records)

    def close(self) -> None:
        if not self._closed:
            self._closed = True
            self._broker.leave_group(self._group, self.member_id)
