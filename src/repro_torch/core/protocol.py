"""Application-layer reliable protocol over UDP (paper §3.2.3, Fig. 4).

A copy of ``repro.core.protocol``: the port keeps its own so that it runs
where the JAX package is not installed.  Keep the two in step.

Control packets START / START_ACK / END / END_ACK frame each direction of
a round; *data* packets are never retransmitted (loss tolerance lives in
the count-normalized aggregation), while *control* packets are re-sent
until acknowledged.  The server answers retransmitted ENDs for a grace
window after the first END (the paper's 1 s / TCP TIME_WAIT analogue).

The paper's server aggregates only after *every* client's END (§3.2.3)
— a hard liveness bug at scale: one client that never sends END would
park the round forever.  The server FSM therefore supports a
**deadline close** (DESIGN.md §8): ``deadline_expired()`` moves every
client still short of its END into ``TIMED_OUT``, the aggregation
barrier opens on whatever arrived (the count-normalized divide already
tolerates arbitrarily missing packets), late DATA is dropped *and
counted*, and late ENDs are still grace-acked so stragglers cannot
deadlock themselves retransmitting.

These state machines are host-level (they orchestrate rounds and never
touch the device) and are exercised directly by hypothesis property
tests: no loss/duplication/churn pattern may deadlock a round or hold
the uplink barrier past its deadline.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import List, Optional, Set


class Kind(enum.Enum):
    START = "START"
    START_ACK = "START_ACK"
    DATA = "DATA"
    END = "END"
    END_ACK = "END_ACK"


@dataclasses.dataclass(frozen=True)
class Packet:
    kind: Kind
    client: int
    index: int = -1          # data packet index
    from_server: bool = False
    # Compressed-uplink wire header (DESIGN.md §9).  The FSM and the
    # dedup path never look at these — f32 and q8 streams coexist on
    # one socket and framing/retransmission behave identically.
    wire_dtype: str = "f32"  # "f32" | "q8" payload encoding
    scale: float = 1.0       # q8 per-packet symmetric dequant scale
    # Async buffered mode (DESIGN.md §10): the global-version tag.  The
    # server stamps downlink packets with the version of the global they
    # carry; a client stamps its whole uplink session with the version
    # it trained on, so the server can measure staleness on the wire
    # (version-at-fold minus version-at-send) without tracking per-client
    # history.  Synchronous rounds leave it at 0 and never read it.
    version: int = 0


class ClientPhase(enum.Enum):
    LOCAL_TRAIN = enum.auto()
    SEND_START = enum.auto()
    SEND_PARAMS = enum.auto()
    AWAIT_END_ACK = enum.auto()
    RECV_GLOBAL = enum.auto()
    DONE = enum.auto()


class ServerPhase(enum.Enum):
    WAIT_START = enum.auto()
    RECV_PARAMS = enum.auto()
    COMPUTE = enum.auto()
    SEND_GLOBAL = enum.auto()
    AWAIT_END_ACK = enum.auto()
    DONE = enum.auto()
    TIMED_OUT = enum.auto()      # deadline-closed straggler: excluded from
                                 # this round, pre-deadline arrivals kept


class ClientFSM:
    """One client's per-round state machine."""

    def __init__(self, client_id: int, n_packets: int):
        self.id = client_id
        self.n_packets = n_packets
        self.phase = ClientPhase.SEND_START
        self.next_data = 0
        self.received: Set[int] = set()
        self.got_server_end = False

    def emit(self) -> List[Packet]:
        """Packets the client wants to (re)send now."""
        if self.phase == ClientPhase.SEND_START:
            return [Packet(Kind.START, self.id)]
        if self.phase == ClientPhase.SEND_PARAMS:
            if self.next_data < self.n_packets:
                p = Packet(Kind.DATA, self.id, self.next_data)
                self.next_data += 1
                return [p]
            self.phase = ClientPhase.AWAIT_END_ACK
            return [Packet(Kind.END, self.id)]
        if self.phase == ClientPhase.AWAIT_END_ACK:
            return [Packet(Kind.END, self.id)]          # retransmit END
        return []

    def on_packet(self, p: Packet) -> List[Packet]:
        """Returns immediate replies.  Crucially, retransmitted server ENDs
        are re-acked even after the round is locally DONE (the paper's
        grace window, §3.2.3) — otherwise a dropped final END_ACK
        deadlocks the server."""
        assert p.from_server
        if p.kind == Kind.START_ACK and self.phase == ClientPhase.SEND_START:
            self.phase = ClientPhase.SEND_PARAMS
        elif p.kind == Kind.END_ACK and self.phase == ClientPhase.AWAIT_END_ACK:
            self.phase = ClientPhase.RECV_GLOBAL
        elif p.kind == Kind.DATA and self.phase == ClientPhase.RECV_GLOBAL:
            self.received.add(p.index)
        elif p.kind == Kind.END and self.phase in (ClientPhase.RECV_GLOBAL,
                                                   ClientPhase.DONE):
            self.got_server_end = True
            if self.phase == ClientPhase.RECV_GLOBAL:
                self.phase = ClientPhase.DONE
            return [Packet(Kind.END_ACK, self.id)]
        return []


class ServerFSM:
    """Server per-round state over K clients."""

    def __init__(self, n_clients: int, n_packets: int):
        self.n_clients = n_clients
        self.n_packets = n_packets
        self.phase = {c: ServerPhase.WAIT_START for c in range(n_clients)}
        self.uplink: List[Set[int]] = [set() for _ in range(n_clients)]
        self.next_down = [0] * n_clients
        self.downlink_end_sent = [False] * n_clients
        self.computed = False
        self.timed_out: List[int] = []   # clients closed out by the deadline
        self.late_data_dropped = 0       # DATA from TIMED_OUT clients

    # -- receive path --------------------------------------------------------
    def on_packet(self, p: Packet) -> List[Packet]:
        """Process one client packet; returns immediate replies (RX thread
        answers control packets directly — §3.2.3)."""
        c = p.client
        ph = self.phase[c]
        if p.kind == Kind.START:
            if ph == ServerPhase.WAIT_START:
                self.phase[c] = ServerPhase.RECV_PARAMS
            # (re)ack START in *every* post-START phase — the ack-lost
            # case.  A duplicated/late START arriving after this client's
            # END used to be silently ignored (only RECV_PARAMS re-acked),
            # leaving the client retransmitting forever.  TIMED_OUT never
            # acks: the round is closed for that client.
            if self.phase[c] == ServerPhase.TIMED_OUT:
                return []
            return [Packet(Kind.START_ACK, c, from_server=True)]
        if p.kind == Kind.DATA:
            if ph == ServerPhase.RECV_PARAMS:
                self.uplink[c].add(p.index)
            elif ph == ServerPhase.TIMED_OUT:
                self.late_data_dropped += 1      # dropped AND counted
            return []
        if p.kind == Kind.END:
            # first END moves to COMPUTE; retransmitted ENDs within the
            # grace window are re-acked without touching worker threads.
            # TIMED_OUT is grace-acked too: a straggler that finally sends
            # END must not deadlock itself retransmitting it.
            if ph == ServerPhase.RECV_PARAMS:
                self.phase[c] = ServerPhase.COMPUTE
            if self.phase[c] in (ServerPhase.COMPUTE, ServerPhase.SEND_GLOBAL,
                                 ServerPhase.AWAIT_END_ACK,
                                 ServerPhase.TIMED_OUT):
                return [Packet(Kind.END_ACK, c, from_server=True)]
            return []
        if p.kind == Kind.END_ACK and ph == ServerPhase.AWAIT_END_ACK:
            self.phase[c] = ServerPhase.DONE
            return []
        return []

    # -- deadline close -------------------------------------------------------
    def deadline_expired(self) -> List[int]:
        """Close the uplink barrier: every client still short of its END
        (WAIT_START or RECV_PARAMS) moves to TIMED_OUT and is excluded
        from the rest of the round.  Pre-deadline arrivals stay in the
        uplink sets — the deadline turns a straggler's *undelivered*
        packets into wire losses, nothing more (DESIGN.md §8).
        Idempotent; returns the newly timed-out clients."""
        newly = [c for c, ph in self.phase.items()
                 if ph in (ServerPhase.WAIT_START, ServerPhase.RECV_PARAMS)]
        for c in newly:
            self.phase[c] = ServerPhase.TIMED_OUT
        self.timed_out.extend(newly)
        return newly

    def participants(self) -> int:
        """Clients that completed their uplink (END seen before close)."""
        return sum(ph in (ServerPhase.COMPUTE, ServerPhase.SEND_GLOBAL,
                          ServerPhase.AWAIT_END_ACK, ServerPhase.DONE)
                   for ph in self.phase.values())

    # -- aggregation barrier --------------------------------------------------
    def all_uplinks_done(self) -> bool:
        return all(ph in (ServerPhase.COMPUTE, ServerPhase.SEND_GLOBAL,
                          ServerPhase.AWAIT_END_ACK, ServerPhase.DONE,
                          ServerPhase.TIMED_OUT)
                   for ph in self.phase.values())

    def run_aggregation(self) -> None:
        assert self.all_uplinks_done()
        self.computed = True
        for c in range(self.n_clients):
            if self.phase[c] == ServerPhase.COMPUTE:
                self.phase[c] = ServerPhase.SEND_GLOBAL

    # -- send path ------------------------------------------------------------
    def emit(self) -> List[Packet]:
        out: List[Packet] = []
        for c in range(self.n_clients):
            ph = self.phase[c]
            if ph == ServerPhase.SEND_GLOBAL:
                if self.next_down[c] < self.n_packets:
                    out.append(Packet(Kind.DATA, c, self.next_down[c],
                                      from_server=True))
                    self.next_down[c] += 1
                else:
                    out.append(Packet(Kind.END, c, from_server=True))
                    self.phase[c] = ServerPhase.AWAIT_END_ACK
            elif ph == ServerPhase.AWAIT_END_ACK:
                out.append(Packet(Kind.END, c, from_server=True))
        return out

    def done(self) -> bool:
        return all(ph in (ServerPhase.DONE, ServerPhase.TIMED_OUT)
                   for ph in self.phase.values())


@dataclasses.dataclass
class RoundOutcome:
    """What one driven round delivered.  Unpacks as the historical
    ``(uplink, downlink)`` pair (``up, down = run_round(...)``)."""
    uplink: List[Set[int]]          # per-client uplink index sets
    downlink: List[Set[int]]        # per-client downlink index sets
    steps: int                      # event steps consumed
    timed_out: List[int]            # clients closed out by the deadline
    late_data_dropped: int          # DATA arriving after a client timed out
    completed: bool                 # every client finished its downlink

    def __iter__(self):
        return iter((self.uplink, self.downlink))


def run_round(n_clients: int, n_packets: int,
              drop_fn, max_steps: int = 100000,
              round_deadline: Optional[int] = None,
              dup_fn=None) -> RoundOutcome:
    """Drive one round; ``drop_fn(packet, step) -> bool`` drops packets,
    ``dup_fn(packet, step) -> bool`` (optional) delivers a second copy —
    UDP may duplicate control and data alike.

    Control packets are retransmitted by the FSMs; data packets are sent
    once.  At step ``round_deadline`` the server closes the uplink
    barrier (``ServerFSM.deadline_expired``) and aggregates whatever
    arrived; clients still short of their END are TIMED_OUT and excluded
    (their pre-deadline packets count — the same result as if their
    undelivered packets had been wire losses).  Without an explicit
    deadline the budget is ``max_steps``: the round *always* returns a
    ``RoundOutcome`` — the old ``RuntimeError("protocol deadlock")``
    path is gone, because no loss/duplication/churn pattern may hang the
    server (the property tests/test_protocol.py drives).
    """
    if round_deadline is not None and round_deadline > max_steps:
        raise ValueError(
            f"round_deadline={round_deadline} exceeds the max_steps="
            f"{max_steps} budget — the deadline could never fire when "
            f"requested, silently skewing straggler accounting")
    clients = [ClientFSM(c, n_packets) for c in range(n_clients)]
    server = ServerFSM(n_clients, n_packets)
    deadline = max_steps if round_deadline is None else round_deadline

    def outcome(step: int) -> RoundOutcome:
        completed = (server.done() and not server.timed_out and
                     all(c.phase == ClientPhase.DONE for c in clients))
        return RoundOutcome(server.uplink, [c.received for c in clients],
                            step, sorted(server.timed_out),
                            server.late_data_dropped, completed)

    def copies(p, step):
        return 2 if (dup_fn is not None and dup_fn(p, step)) else 1

    for step in range(max_steps):
        if server.done() and all(
                clients[c].phase == ClientPhase.DONE
                or server.phase[c] == ServerPhase.TIMED_OUT
                for c in range(n_clients)):
            return outcome(step)
        if step >= deadline:
            server.deadline_expired()      # idempotent past the first call

        # client -> server
        for cl in clients:
            for p in cl.emit():
                for _ in range(copies(p, step)):
                    if drop_fn(p, step):
                        continue
                    for reply in server.on_packet(p):
                        if not drop_fn(reply, step):
                            cl.on_packet(reply)

        # aggregation barrier (opens at the deadline for partial rounds)
        if server.all_uplinks_done() and not server.computed:
            server.run_aggregation()

        # server -> client (client replies, e.g. downlink END_ACK, flow back)
        for p in server.emit():
            for _ in range(copies(p, step)):
                if drop_fn(p, step):
                    continue
                for reply in clients[p.client].on_packet(p):
                    if not drop_fn(reply, step):
                        server.on_packet(reply)

    # budget exhausted: close out whatever remains rather than raising —
    # a blocked downlink yields a partial RoundOutcome, never a hang
    server.deadline_expired()
    return outcome(max_steps)
