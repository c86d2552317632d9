"""RateTracker — windowed rate estimation over a monotonic counter.

The autoscale controller estimates each pool's drain rate from successive
``Broker.queue_stats`` ``consumed`` samples; the federation spillover
controller needs the identical estimate to decide whether a site's backlog
outruns its local drain capacity (time-to-drain = depth / rate). This is
that shared primitive, extracted so both control loops sample and read the
same way: append ``(ts, counter)`` pairs, read the slope over a trailing
window.

Not thread-safe on its own — both controllers sample from a single control
loop thread (or under their own lock).
"""
from __future__ import annotations

from collections import deque

__all__ = ["RateTracker"]


class RateTracker:
    """Sliding-window rate over a cumulative counter.

    ``sample(ts, value)`` appends an observation; ``rate(now)`` returns the
    per-second slope between the oldest sample inside ``window_s`` and the
    newest sample, or 0.0 when fewer than two usable samples exist (cold
    start, or the counter stalled at one timestamp). A monotonic counter
    therefore reads as ≥ 0; a counter reset reads as a transient 0/negative
    until the window refills, which both callers treat as "no drain".
    """

    __slots__ = ("window_s", "_samples")

    def __init__(self, window_s: float, history: int = 512) -> None:
        self.window_s = window_s
        self._samples: deque[tuple[float, float]] = deque(maxlen=history)

    def sample(self, ts: float, value: float) -> None:
        self._samples.append((ts, value))

    def rate(self, now: float) -> float:
        if not self._samples:
            return 0.0
        old = None
        for ts, value in self._samples:
            if now - ts <= self.window_s:
                old = (ts, value)
                break
        new = self._samples[-1]
        if old is None or new[0] <= old[0]:
            return 0.0
        return (new[1] - old[1]) / (new[0] - old[0])

    def __len__(self) -> int:
        return len(self._samples)
