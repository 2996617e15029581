"""The port's ``runtime/fault_tolerance`` (a numpy copy), mirroring
tests/test_fault_tolerance.py: the deadline close, the quorum verdict
delegated to the port's ``core.server.check_quorum`` (the same words as
the JAX package's guard), the heartbeat tracker and the retry budget.
Time is injected, so nothing here sleeps.
"""
import dataclasses

import numpy as np
import pytest

from repro.core.server import QuorumError as RefQuorumError
from repro.runtime import fault_tolerance as ref_ft
from repro_torch.core.server import QuorumError, check_quorum
from repro_torch.runtime.fault_tolerance import (DeadlineMonitor,
                                                 HeartbeatTracker,
                                                 RoundRobustState)


class FakeClock:
    def __init__(self, t=0.0):
        self.t = t

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


# --- DeadlineMonitor ---------------------------------------------------------

def test_close_only_at_deadline_not_quorum():
    clk = FakeClock()
    m = DeadlineMonitor(n_pods=4, min_clients=2, deadline_s=10.0,
                        clock=clk)
    m.mark_arrived(0)
    m.mark_arrived(1)
    m.mark_arrived(2)
    assert not m.should_close()      # 3/4 >= min_clients, still open
    clk.advance(9.99)
    assert not m.should_close()
    clk.advance(0.02)
    assert m.should_close()          # the deadline is the close
    assert m.stragglers() == [3]


def test_all_pods_arrived_closes_early():
    clk = FakeClock()
    m = DeadlineMonitor(n_pods=3, min_clients=1, deadline_s=1e9,
                        clock=clk)
    for p in range(3):
        m.mark_arrived(p)
    assert m.should_close()          # nobody left to time out
    assert m.stragglers() == []
    m.check_quorum()                 # trivially satisfied


def test_quorum_verdict_delegates_to_engine_guard():
    """Same exception type AND same words as the engine's guard."""
    clk = FakeClock()
    m = DeadlineMonitor(n_pods=5, min_clients=3, deadline_s=0.0,
                        clock=clk)
    m.mark_arrived(1)
    with pytest.raises(QuorumError) as monitor_err:
        m.check_quorum()
    with pytest.raises(QuorumError) as engine_err:
        check_quorum(1, 3, 4)        # 1 participant, 4 stragglers
    assert str(monitor_err.value) == str(engine_err.value)


def test_quorum_satisfied_no_raise():
    m = DeadlineMonitor(n_pods=5, min_clients=2, deadline_s=0.0,
                        clock=FakeClock())
    m.mark_arrived(0)
    m.mark_arrived(4)
    m.check_quorum()
    np.testing.assert_array_equal(m.alive_mask(), [1, 0, 0, 0, 1])


def test_reset_reopens_round():
    clk = FakeClock()
    m = DeadlineMonitor(n_pods=2, min_clients=1, deadline_s=5.0,
                        clock=clk)
    m.mark_arrived(0)
    clk.advance(6.0)
    assert m.should_close()
    m.reset()
    assert not m.should_close()      # fresh deadline from reset time
    assert m.alive_mask().sum() == 0
    assert m.stragglers() == [0, 1]


def test_mark_arrived_records_first_arrival_only():
    clk = FakeClock()
    m = DeadlineMonitor(n_pods=2, min_clients=1, deadline_s=10.0,
                        clock=clk)
    m.mark_arrived(0)
    clk.advance(3.0)
    m.mark_arrived(0)                # duplicate: first timestamp kept
    assert m._arrived[0] == 0.0


def test_min_clients_validation():
    with pytest.raises(ValueError):
        DeadlineMonitor(n_pods=3, min_clients=4)
    with pytest.raises(ValueError):
        DeadlineMonitor(n_pods=3, min_clients=-1)


# --- HeartbeatTracker --------------------------------------------------------

def test_heartbeat_injected_clock():
    clk = FakeClock()
    h = HeartbeatTracker(n_pods=3, timeout_s=5.0, clock=clk)
    clk.advance(4.0)
    h.beat(0)
    clk.advance(3.0)                 # pod 0 aged 3s; pods 1, 2 aged 7s
    assert h.dead_pods() == [1, 2]
    np.testing.assert_array_equal(h.alive_mask(), [1, 0, 0])
    h.beat(1)
    assert h.dead_pods() == [2]


# --- RoundRobustState --------------------------------------------------------

def test_round_robust_retry_budget_resets_on_success():
    r = RoundRobustState(max_round_retries=2)
    assert r.on_round_failure()
    assert r.on_round_failure()
    assert not r.on_round_failure()  # exhausted
    r.on_round_complete()
    assert r.failed_rounds == 0      # success resets the budget
    assert r.on_round_failure()


# --- against the reference ---------------------------------------------------

def test_quorum_message_matches_reference_monitor():
    """The port's monitor and the JAX package's raise the same words."""
    errs = []
    for cls, exc in ((DeadlineMonitor, QuorumError),
                     (ref_ft.DeadlineMonitor, RefQuorumError)):
        m = cls(n_pods=6, min_clients=4, deadline_s=0.0, clock=FakeClock())
        m.mark_arrived(2)
        m.mark_arrived(5)
        with pytest.raises(exc) as e:
            m.check_quorum()
        errs.append(str(e.value))
        assert m.stragglers() == [0, 1, 3, 4]
    assert errs[0] == errs[1]


def test_dataclass_fields_match_reference():
    for port_cls, ref_cls in ((DeadlineMonitor, ref_ft.DeadlineMonitor),
                              (HeartbeatTracker, ref_ft.HeartbeatTracker),
                              (RoundRobustState, ref_ft.RoundRobustState)):
        names = lambda c: [(f.name, f.default) for f in dataclasses.fields(c)
                           if f.name != "clock"]
        assert names(port_cls) == names(ref_cls)


def test_round_robust_state_extra_round_trip():
    r = RoundRobustState()
    r.on_round_complete()
    r.on_round_complete()
    back = RoundRobustState.from_extra(r.to_extra())
    assert back.round_idx == 2 == ref_ft.RoundRobustState.from_extra(
        r.to_extra()).round_idx
