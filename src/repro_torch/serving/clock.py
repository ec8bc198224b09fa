"""Pluggable serving clocks.

The cluster's discrete-event core runs on *estimator time* (virtual
seconds).  The serving loop needs a policy for how virtual event times
relate to the caller's experience of time:

* ``VirtualClock`` — events process as fast as Python allows; ``now``
  jumps to each event's timestamp.  Deterministic: the test tier and the
  simulator run on this.
* ``WallClock`` — the loop *paces* itself to real time: before
  processing an event at virtual time ``t`` it sleeps until ``t``
  seconds after the epoch anchor.  This is the live-demo mode where
  streamed tokens arrive at the modeled rate.  If event processing
  (e.g. real execution on the card) already took longer than the modeled
  duration, no sleep happens — the loop simply runs behind, exactly
  like an overloaded server.
"""
from __future__ import annotations

import time


class VirtualClock:
    """Simulated time: no sleeping, ``now`` tracks the last event."""

    def __init__(self, start: float = 0.0):
        self.now = start

    def sleep_until(self, t: float):
        if t > self.now:
            self.now = t


class WallClock:
    """Real time, anchored at construction (virtual t=0 == anchor)."""

    def __init__(self, start: float = 0.0):
        self._anchor = time.monotonic() - start

    @property
    def now(self) -> float:
        return time.monotonic() - self._anchor

    def sleep_until(self, t: float):
        dt = t - self.now
        if dt > 0:
            time.sleep(dt)
