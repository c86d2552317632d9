"""repro_torch.core — the kafka-slurm-agent (KSA) control plane, embedded.

**The public entry point is** :class:`repro_torch.cluster.KsaCluster` — a
context-managed facade that owns broker/topic/agent/monitor lifecycle::

    from repro_torch.cluster import KsaCluster

    with KsaCluster(workers=2, gpu_workers=1) as c:
        tid = c.submit("matrix", params={"n": 96})
        c.wait_all([tid])
        print(c.result(tid))

The components below (paper §3: :class:`Submitter`, :class:`ClusterAgent`,
:class:`WorkerAgent`, :class:`MonitorAgent`, communicating asynchronously over
a durable log — :class:`Broker`) are the facade's building blocks. Wiring
them by hand is considered **internal**: it is still supported (tests and the
facade itself do it), but every component that routes tasks must then be
given the *same* :class:`~repro_torch.core.scheduling.PlacementPolicy`, which the
facade otherwise guarantees.

Resource-aware placement (:mod:`repro_torch.core.scheduling`) extends the paper's
single shared ``PREFIX-new`` topic with per-resource-class topics
(``PREFIX-new.cpu`` / ``PREFIX-new.gpu`` / label classes): agents declare a
:class:`~repro_torch.core.scheduling.ResourceProfile` and subscribe only to the
classes they can serve, so a GPU stage can never execute on a CPU-only pool,
and a pluggable :class:`~repro_torch.core.scheduling.LeasePolicy`
(:class:`~repro_torch.core.scheduling.FairShare` weighted round-robin) arbitrates
how concurrent campaigns drain into that capacity.
"""
from .broker import (Broker, BrokerError, Consumer, FencedError, Producer,
                     Record, TopicPartition)
from .computing import (ClusterComputing, TaskCancelled, register_script,
                        registered_scripts, resolve_script)
from .lease import Lease, LeaseTolerance, RevokeReason
from .scheduling import (FairShare, FifoLease, LeasePolicy, PlacementPolicy,
                         ResourceClassPolicy, ResourceProfile,
                         SingleTopicPolicy, class_topic)
from .agents import AgentBase, ClusterAgent, WorkerAgent
from .messages import (CampaignEvent, ErrorMessage, Resources, ResultMessage,
                       StatusUpdate, TaskMessage, TaskStatus, new_task_id,
                       topic_names)
from .monitor import MonitorAgent, TaskEntry
from .simslurm import SimSlurm
from .submitter import Submitter

__all__ = [
    "AgentBase", "Broker", "BrokerError", "CampaignEvent", "ClusterAgent",
    "ClusterComputing",
    "Consumer", "ErrorMessage", "FairShare", "FencedError", "FifoLease",
    "Lease", "LeasePolicy", "LeaseTolerance", "MonitorAgent",
    "PlacementPolicy", "Producer",
    "Record", "ResourceClassPolicy", "ResourceProfile", "Resources",
    "RevokeReason",
    "ResultMessage", "SimSlurm", "SingleTopicPolicy", "StatusUpdate",
    "Submitter", "TaskCancelled", "TaskEntry", "TaskMessage", "TaskStatus",
    "TopicPartition", "WorkerAgent", "class_topic", "new_task_id",
    "register_script", "registered_scripts", "resolve_script", "topic_names",
]
