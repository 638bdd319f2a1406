"""Per-member health tracking for the fleet scheduler.

The counterpart of the JAX package's ``fleet/health.py``.
A member's heartbeat is its ``stats()`` call — if the probe (or a
``step()``) raises, that is a failure.  Consecutive failures back off
exponentially (``backoff_base ** failures`` ticks, capped at
``backoff_cap``) before the next probe is even attempted, so a crashing
member is not hammered every tick; at ``max_failures`` consecutive
failures the member is marked unhealthy and the scheduler stops placing
on (and stepping) it.  One successful probe fully recovers it — the
failure counter and backoff reset, because a member that answers a probe
is a member whose host process is alive, whatever its history.

All of this is plain host bookkeeping: no device state, no threads.  The
scheduler drives :meth:`EngineHealth.beat` from its own tick counter.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional

from repro_torch.utils import get_logger

log = get_logger("fleet")


@dataclasses.dataclass
class HealthState:
    """One member's view: counters plus the backoff window."""

    failures: int = 0            # consecutive (resets on success)
    total_failures: int = 0      # lifetime
    beats: int = 0               # successful probes
    backoff: int = 0             # current backoff window (ticks)
    next_probe_tick: int = 0     # no probe before this scheduler tick
    healthy: bool = True
    unhealthy_marks: int = 0     # times the member crossed max_failures
    last_error: Optional[str] = None


class EngineHealth:
    """Failure counting + bounded exponential backoff over N members."""

    def __init__(self, n_members: int, *, max_failures: int = 3,
                 backoff_base: int = 2, backoff_cap: int = 64):
        self.max_failures = max_failures
        self.backoff_base = backoff_base
        self.backoff_cap = backoff_cap
        self.states: List[HealthState] = [HealthState()
                                          for _ in range(n_members)]

    def add_member(self) -> None:
        self.states.append(HealthState())

    def healthy(self, idx: int) -> bool:
        return self.states[idx].healthy

    def note_failure(self, idx: int, tick: int,
                     err: Optional[BaseException] = None) -> None:
        """Record one failed probe/step; arms the backoff window and marks
        the member unhealthy at ``max_failures`` consecutive failures."""
        st = self.states[idx]
        st.failures += 1
        st.total_failures += 1
        st.last_error = repr(err) if err is not None else None
        st.backoff = min(self.backoff_cap,
                         self.backoff_base ** st.failures)
        st.next_probe_tick = tick + st.backoff
        if st.healthy and st.failures >= self.max_failures:
            st.healthy = False
            st.unhealthy_marks += 1
            log.warning("member %d unhealthy after %d consecutive failures "
                        "(last: %s)", idx, st.failures, st.last_error)

    def beat(self, idx: int, tick: int,
             probe: Callable[[], object]) -> Optional[bool]:
        """Probe member ``idx`` by calling ``probe()`` (typically the
        member's ``stats``).  Returns True on success, False on failure,
        None when the member is inside its backoff window (no probe
        attempted — backoff is what keeps a crashing member from being
        hammered every heartbeat)."""
        st = self.states[idx]
        if tick < st.next_probe_tick:
            return None
        try:
            probe()
        except Exception as e:                        # noqa: BLE001
            self.note_failure(idx, tick, e)
            return False
        st.beats += 1
        if not st.healthy:
            log.info("member %d recovered after %d consecutive failures",
                     idx, st.failures)
        st.failures = 0
        st.backoff = 0
        st.next_probe_tick = tick
        st.healthy = True
        return True

    def stats(self) -> List[dict]:
        return [dataclasses.asdict(st) for st in self.states]

    def summary(self, idx: int) -> dict:
        """One member's health in the shape the fleet surfaces per-member
        (stats()["members"][idx] and the Prometheus scrape): a flapping
        member is visible as nonzero consecutive failures / backoff
        without reading logs."""
        st = self.states[idx]
        return {
            "healthy": st.healthy,
            "consecutive_failures": st.failures,
            "total_failures": st.total_failures,
            "backoff": st.backoff,
            "next_probe_tick": st.next_probe_tick,
            "unhealthy_marks": st.unhealthy_marks,
            "last_error": st.last_error,
        }
