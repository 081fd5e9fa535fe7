"""Elastic scaling + fault tolerance policies (the port's copy of
``repro.train.elastic``: pure, testable logic).

The cluster contract (what the launcher enforces on real hardware):

  1. Every batch is a pure function of ``(seed, step)`` (data.py).
  2. Shard assignment is a pure function of ``(global_batch, healthy_hosts)``
     — ``shard_rows`` below.  Invariants (property-tested):
       * the union of all healthy hosts' rows == all rows (no sample lost),
       * assignments are disjoint,
       * balanced to within one row.
  3. On failure: survivors restore the latest complete checkpoint
     (checkpoint.py manifests are atomic), recompute shard assignment with
     the shrunk host list, and resume the same step sequence.  Because of
     (1)+(2) the training trajectory is identical to a run that never used
     the lost host (modulo batch-position reduction order).
  4. Straggler mitigation: the coordinator tracks per-host step latencies;
     hosts slower than ``median * straggler_factor`` for ``patience``
     consecutive steps are treated as failed (demoted from the healthy list)
     — bounded-wait semantics instead of stalls.

``Coordinator`` simulates the control plane (heartbeats, demotion, rejoin)
so the policy is exercised by unit tests without a cluster.
"""
from __future__ import annotations

import dataclasses
import time


def shard_rows(global_batch: int, host: int, healthy_hosts: list[int]) -> list[int]:
    """Rows of the global batch owned by ``host`` (contiguous, balanced)."""
    assert host in healthy_hosts, f"host {host} not in healthy set"
    hosts = sorted(healthy_hosts)
    n = len(hosts)
    rank = hosts.index(host)
    base = global_batch // n
    extra = global_batch % n
    lo = rank * base + min(rank, extra)
    hi = lo + base + (1 if rank < extra else 0)
    return list(range(lo, hi))


@dataclasses.dataclass
class HostState:
    last_heartbeat: float = 0.0
    slow_steps: int = 0
    healthy: bool = True


class Coordinator:
    """Control-plane simulation: heartbeats, straggler demotion, rejoin."""

    def __init__(
        self,
        hosts: list[int],
        heartbeat_timeout: float = 60.0,
        straggler_factor: float = 2.0,
        patience: int = 3,
    ):
        self.states = {h: HostState() for h in hosts}
        self.heartbeat_timeout = heartbeat_timeout
        self.straggler_factor = straggler_factor
        self.patience = patience

    def heartbeat(self, host: int, now: float | None = None) -> None:
        now = time.monotonic() if now is None else now
        st = self.states.setdefault(host, HostState())
        st.last_heartbeat = now

    def report_step(self, latencies: dict[int, float]) -> None:
        """Per-step latency report; demotes persistent stragglers."""
        healthy = [h for h, s in self.states.items() if s.healthy]
        vals = sorted(latencies.get(h, float("inf")) for h in healthy)
        if not vals:
            return
        median = vals[len(vals) // 2]
        for h in healthy:
            lat = latencies.get(h, float("inf"))
            st = self.states[h]
            if lat > median * self.straggler_factor:
                st.slow_steps += 1
                if st.slow_steps >= self.patience:
                    st.healthy = False
            else:
                st.slow_steps = 0

    def check_timeouts(self, now: float | None = None) -> None:
        now = time.monotonic() if now is None else now
        for st in self.states.values():
            if st.healthy and now - st.last_heartbeat > self.heartbeat_timeout:
                st.healthy = False

    def rejoin(self, host: int) -> None:
        st = self.states.setdefault(host, HostState())
        st.healthy = True
        st.slow_steps = 0

    @property
    def healthy_hosts(self) -> list[int]:
        return sorted(h for h, s in self.states.items() if s.healthy)
