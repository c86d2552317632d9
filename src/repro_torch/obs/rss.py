"""Process RSS sampling for memory-overage policing.

The agents' memory watchdog (:meth:`repro_torch.core.agents.AgentBase._police_mem`)
originally trusted each task to *self-report* its usage via
``ClusterComputing.report_mem()`` — fine for cooperative tests, useless
against a genuinely misbehaving task. This module reads the real resident
set from ``/proc/self/status`` (``VmRSS``), falling back to
``resource.getrusage`` where procfs is unavailable (macOS), so policing is
grounded in what the kernel actually accounts.

Reads are cached for a short TTL because the sampler runs inside every
agent's poll loop; a 0.2 s staleness bound is far below the watchdog's
reaction time and keeps the procfs cost negligible.
"""
from __future__ import annotations

import resource
import threading
import time

__all__ = ["sample_rss_mb"]

_CACHE_TTL_S = 0.2
_lock = threading.Lock()
_cached: tuple = (0.0, None)  # (monotonic ts, value_mb)


def _read_proc_vmrss_mb() -> float | None:
    try:
        with open("/proc/self/status", "rb") as fh:
            for line in fh:
                if line.startswith(b"VmRSS:"):
                    # "VmRSS:   123456 kB"
                    return int(line.split()[1]) / 1024.0
    except (OSError, ValueError, IndexError):
        pass
    return None


def _read_rusage_mb() -> float:
    # ru_maxrss is KB on Linux, bytes on macOS; we only hit this fallback
    # off-Linux, but normalizing per-platform keeps it honest everywhere.
    peak = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    import sys
    if sys.platform == "darwin":
        return peak / (1024.0 * 1024.0)
    return peak / 1024.0


def sample_rss_mb(cached: bool = True) -> float:
    """Current resident set size of this process, in MB."""
    global _cached
    now = time.monotonic()
    if cached:
        ts, val = _cached
        if val is not None and now - ts < _CACHE_TTL_S:
            return val
    val = _read_proc_vmrss_mb()
    if val is None:
        val = _read_rusage_mb()
    with _lock:
        _cached = (now, val)
    return val
