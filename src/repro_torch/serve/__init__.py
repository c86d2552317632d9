from .engine import (ServeEngine, ServePostprocessComputing,
                     ServeRequestComputing, ServeTokenizeComputing,
                     serve_pipeline)
from .metrics import register_serve_metrics
from .paged import PageAllocator
from .replica import (PendingRequest, ServeLoadGenComputing,
                      ServeReplicaComputing, ServeReplicaSet, ttft_slo)

__all__ = ["PageAllocator", "PendingRequest", "ServeEngine",
           "ServeLoadGenComputing", "ServePostprocessComputing",
           "ServeReplicaComputing", "ServeReplicaSet",
           "ServeRequestComputing", "ServeTokenizeComputing",
           "register_serve_metrics", "serve_pipeline", "ttft_slo"]
