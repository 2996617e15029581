"""Fault tolerance at 1000-node scale.

The paper's count-normalized aggregation is itself the failure-tolerance
mechanism: a client (pod) that misses the round deadline simply has
mask 0 and the divisor adjusts — no retransmission, no blocking.  This
module provides the host-side machinery around it, with the *same*
round-close semantics as the packet engine (DESIGN.md §8): a round
closes at its deadline (never early on a quorum — closing early would
time out stragglers that the engine would still accept), and the
``min_clients`` quorum is a *guard* checked at the close, delegated to
``core.server.check_quorum`` so both layers raise the same
``QuorumError`` in the same words.

- ``DeadlineMonitor``: wall-clock deadline close + alive mask + the
  delegated quorum guard.  Time is injectable (``clock=``), so the
  close logic is unit-testable without sleeping.
- ``HeartbeatTracker``: failure detection feeding the alive mask, same
  injectable clock.
- ``RoundRobustState``: checkpoint/restart bookkeeping — every round
  boundary is a consistent cut (parameters are replicated post-
  aggregation), so restart = restore latest round checkpoint; pods that
  died mid-round rejoin from the same cut.

Torch port of ``repro.runtime.fault_tolerance``: host-only numpy code,
copied, with the quorum guard taken from the port's ``core.server``.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List

import numpy as np

from repro_torch.core.server import check_quorum


@dataclasses.dataclass
class DeadlineMonitor:
    """Close the round at the deadline; guard the close on min_clients.

    The event-count deadline of ``EngineConfig.round_deadline`` is the
    in-stream analogue of ``deadline_s`` here: both close the uplink
    barrier unconditionally at the cut and average what arrived.  The
    one early close is *all pods arrived* — closing then times nobody
    out, so it cannot diverge from the engine's semantics.
    """
    n_pods: int
    min_clients: int = 1
    deadline_s: float = 600.0
    clock: Callable[[], float] = time.monotonic

    def __post_init__(self):
        if not 0 <= self.min_clients <= self.n_pods:
            raise ValueError(
                f"min_clients must be in [0, n_pods={self.n_pods}], "
                f"got {self.min_clients}")
        self._arrived: Dict[int, float] = {}
        self._t0 = self.clock()

    def reset(self):
        self._arrived.clear()
        self._t0 = self.clock()

    def mark_arrived(self, pod: int):
        self._arrived.setdefault(pod, self.clock() - self._t0)

    def elapsed(self) -> float:
        return self.clock() - self._t0

    def should_close(self) -> bool:
        """Deadline expired, or every pod delivered (nobody to wait
        for).  Never closes early on a partial quorum — that is the
        engine's straggler-liveness rule (DESIGN.md §8)."""
        if len(self._arrived) >= self.n_pods:
            return True
        return self.elapsed() >= self.deadline_s

    def stragglers(self) -> List[int]:
        """Pods that had not delivered at the close."""
        return [p for p in range(self.n_pods) if p not in self._arrived]

    def check_quorum(self) -> None:
        """The engine's quorum guard, verbatim: raises
        ``core.server.QuorumError`` (same message) when the round
        closed with fewer than ``min_clients`` participants."""
        check_quorum(len(self._arrived), self.min_clients,
                     len(self.stragglers()))

    def alive_mask(self) -> np.ndarray:
        mask = np.zeros((self.n_pods,), np.float32)
        for pod in self._arrived:
            mask[pod] = 1.0
        return mask


@dataclasses.dataclass
class HeartbeatTracker:
    n_pods: int
    timeout_s: float = 60.0
    clock: Callable[[], float] = time.monotonic

    def __post_init__(self):
        now = self.clock()
        self._last: List[float] = [now] * self.n_pods

    def beat(self, pod: int):
        self._last[pod] = self.clock()

    def dead_pods(self) -> List[int]:
        now = self.clock()
        return [i for i, t in enumerate(self._last)
                if now - t > self.timeout_s]

    def alive_mask(self) -> np.ndarray:
        dead = set(self.dead_pods())
        return np.array([0.0 if i in dead else 1.0
                         for i in range(self.n_pods)], np.float32)


@dataclasses.dataclass
class RoundRobustState:
    """Round bookkeeping for checkpoint/restart."""
    round_idx: int = 0
    failed_rounds: int = 0
    max_round_retries: int = 3

    def on_round_complete(self):
        self.round_idx += 1
        self.failed_rounds = 0

    def on_round_failure(self) -> bool:
        """Returns True if the round should be retried from the last cut."""
        self.failed_rounds += 1
        return self.failed_rounds <= self.max_round_retries

    def to_extra(self) -> dict:
        return {"round_idx": self.round_idx}

    @classmethod
    def from_extra(cls, extra: dict) -> "RoundRobustState":
        return cls(round_idx=int(extra.get("round_idx", 0)))
