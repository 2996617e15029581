"""Ring-buffered packet-path server round engine (paper §3.2, §4).

The paper's DPDK server is a three-stage pipeline: one RX core polls the
NIC and demultiplexes packets onto per-worker rings, N worker cores
drain their rings and add payloads into a shared accumulator, and a TX
core streams the averaged global parameters back out.  ``ServerEngine``
consumes an interleaved multi-client stream of ``core.protocol.Packet``
events — lossy, out-of-order, duplicated — and drives the device-side
scatter-accumulate (kernels/packet_scatter.py) through a
``StreamingAggregator`` once per drained ring batch.

Torch port of ``repro.core.server`` for the synchronous round
(``shards=1``, ``hosts=1``, no async buffer) in every ``agg_mode``: the
mean, and the Byzantine-robust trimmed mean, median and norm clip
(DESIGN.md §11).  The host logic (FSM gate, dedup, deadline and quorum
close, ring demux) is the reference's, line for line; the device state
lives in torch tensors on the engine's device.  Semantics (DESIGN.md
§3):

- **RX** answers control packets through the per-round ``ServerFSM`` and
  deduplicates DATA packets against the FSM's uplink sets, so the
  engine's per-slot arrival counts equal the protocol-level counts for
  *any* loss/duplication pattern.
- **Workers** drain a ring when it reaches capacity; each drained batch
  is one scatter-accumulate launch.
- **END** divides by the counts, with per-packet fallback to the
  previous global for slots nobody delivered (§3.2.2).  The robust
  table modes keep a per-slot client table beside the rings and
  finalize it with the rank-select kernel instead.
- **TX** applies the downlink mask with the client-side fallback (§3.1).

Invariants the tests hold against the reference: bitwise parity on
integer-valued payloads (eager == compiled == JAX package), and
conservation — every DATA packet lands in exactly one of
``data_enqueued`` / ``duplicates_dropped`` / ``phase_dropped`` /
``late_dropped`` / ``malformed_dropped``.
"""
from __future__ import annotations

import dataclasses
from typing import Iterable, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.aggregation import expand_packet_mask
from repro_torch.core.device import as_tensor, host_array, resolve_device
from repro_torch.core.packets import PacketizedShape, depacketize
from repro_torch.core.pipeline import StreamingAggregator
from repro_torch.core.protocol import Kind, Packet, ServerFSM, ServerPhase
from repro_torch.kernels import ops as _ops
from repro_torch.kernels.packet_scatter import MAX_BATCH, norm_clip_weights


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Shape + pipeline topology of one server round (paper Table 1).

    Every field of ``repro.core.server.EngineConfig``, with the same
    names and defaults, so a reference config carries over.  Values
    whose code is not ported yet raise ``NotImplementedError``.
    """
    n_clients: int
    n_params: int
    payload: int                       # floats per packet (wire: 367)
    n_workers: int = 5                 # paper: 1 RX + 5 workers + 1 TX
    ring_capacity: int = 64            # worker ring depth == race window
    mode: str = "exact"                # exact | approx
    ring_assign: str = "rr"            # rr | slot (see ServerEngine.rx)
    use_kernel: bool = True            # False: sequential host oracle (CPU)
    compile: bool = False              # True: bulk demux + scheduled fold
    scan_body: str = "auto"            # only "auto" is ported
    round_deadline: Optional[int] = None   # rx events before the close
    min_clients: int = 0               # quorum guard; 0 disables it
    shards: int = 1                    # only 1 is ported
    hosts: int = 1                     # only 1 is ported
    buffer_size: Optional[int] = None  # async buffered mode: not ported
    staleness_mode: str = "const"      # const | poly | norm (async)
    staleness_alpha: float = 0.5       # poly/norm decay exponent (async)
    norm_clip: float = 1.0             # norm-mode screening threshold
    agg_mode: str = "mean"             # mean|trimmed_mean|median|norm_clip
    trim_beta: float = 0.1             # trimmed_mean: fraction per side
    clip_tau: float = 1.0              # norm_clip influence bound

    def __post_init__(self):
        if self.shards < 1:
            raise ValueError(f"shards must be >= 1, got {self.shards}")
        if self.round_deadline is not None and self.round_deadline < 0:
            raise ValueError(
                f"round_deadline must be >= 0, got {self.round_deadline}")
        if not 0 <= self.min_clients <= self.n_clients:
            raise ValueError(
                f"min_clients must be in [0, n_clients], got "
                f"{self.min_clients}")
        if self.hosts < 1:
            raise ValueError(f"hosts must be >= 1, got {self.hosts}")
        if self.staleness_mode not in ("const", "poly", "norm"):
            raise ValueError(
                f"staleness_mode must be const|poly|norm, got "
                f"{self.staleness_mode!r}")
        if self.staleness_alpha < 0:
            raise ValueError(
                f"staleness_alpha must be >= 0, got {self.staleness_alpha}")
        if self.norm_clip <= 0:
            raise ValueError(
                f"norm_clip must be > 0, got {self.norm_clip}")
        if self.agg_mode not in ("mean", "trimmed_mean", "median",
                                 "norm_clip"):
            raise ValueError(
                f"agg_mode must be mean|trimmed_mean|median|norm_clip, "
                f"got {self.agg_mode!r}")
        if not 0.0 <= self.trim_beta < 0.5:
            raise ValueError(
                f"trim_beta must be in [0, 0.5), got {self.trim_beta}")
        if self.clip_tau <= 0:
            raise ValueError(
                f"clip_tau must be > 0, got {self.clip_tau}")
        if self.buffer_size is not None:
            if self.buffer_size < 1:
                raise ValueError(
                    f"buffer_size must be >= 1, got {self.buffer_size}")
            if self.round_deadline is not None or self.min_clients:
                raise ValueError(
                    "async buffered mode has no round barrier: "
                    "round_deadline / min_clients do not apply "
                    "(DESIGN.md §10)")
            if self.agg_mode in ("trimmed_mean", "median"):
                raise ValueError(
                    "trimmed_mean/median need the synchronous round's "
                    "per-slot client table; async buffered mode "
                    "supports agg_mode mean|norm_clip (DESIGN.md §11)")
        for name, value, ported in (
                ("shards", self.shards, 1),
                ("hosts", self.hosts, 1),
                ("buffer_size", self.buffer_size, None),
                ("scan_body", self.scan_body, "auto")):
            if value != ported:
                raise NotImplementedError(
                    f"{name}={value!r} is not yet ported, see ROADMAP.md")
        if self.ring_capacity > MAX_BATCH:
            # the kernels stage one batch in 48 KB of shared memory
            raise NotImplementedError(
                f"ring_capacity={self.ring_capacity} above {MAX_BATCH} is "
                f"not yet ported, see ROADMAP.md")

    @property
    def n_slots(self) -> int:
        return PacketizedShape(self.n_params, self.payload).n_packets


@dataclasses.dataclass
class EngineStats:
    data_enqueued: int = 0             # unique DATA packets ringed
    duplicates_dropped: int = 0        # RX-level dedup hits (same slot again)
    phase_dropped: int = 0             # DATA outside START..END framing
    batches_drained: int = 0           # scatter-accumulate calls
    control_replies: int = 0           # START_ACK / END_ACK emitted
    stragglers_timed_out: int = 0      # clients short of END at round close
    late_dropped: int = 0              # DATA arriving past the deadline
    malformed_dropped: int = 0         # non-finite payload / bad q8 scale


def payload_malformed(payload, wire_q8: bool, scale: float) -> bool:
    """Wire-boundary hardening (DESIGN.md §11): is this DATA packet
    poison?  An f32 payload with any non-finite element, or a q8 packet
    whose dequant scale is zero, negative or non-finite, would corrupt
    the accumulators for good.  Both RX paths drop such packets *before*
    the dedup set records the slot, so a clean retransmission of the
    same (client, slot) is still accepted.  A DATA packet legally
    carrying no payload (it will be phase- or late-dropped) is not
    malformed.
    """
    if wire_q8:
        return not (np.isfinite(scale) and scale > 0)
    if payload is None:
        return False
    return not bool(np.all(np.isfinite(np.asarray(payload, np.float32))))


class QuorumError(RuntimeError):
    """Round closed with fewer participants than ``min_clients``."""


def check_quorum(participants: int, min_clients: int,
                 stragglers: int) -> None:
    """Shared quorum guard: the eager close and the compiled bulk demux
    must report the same verdict, in the same words, for one round."""
    if participants < min_clients:
        raise QuorumError(
            f"round closed with {participants} participant(s) < "
            f"min_clients={min_clients} ({stragglers} timed out)")


@dataclasses.dataclass
class RoundResult:
    new_global: torch.Tensor           # (P,) count-normalized global
    counts: torch.Tensor               # (N,) per-slot weighted arrivals
    up_mask: torch.Tensor              # (K, N) deduplicated arrival mask
    new_client_flats: Optional[torch.Tensor]   # (K, P) after downlink
    stats: EngineStats


def fallback_global(avg: torch.Tensor, counts: torch.Tensor, prev_global,
                    payload: int, n_params: int) -> torch.Tensor:
    """END: the averaged packets (N, W) as the new (P,) global, with
    per-slot fallback to ``prev_global`` where nobody delivered the
    packet (§3.2.2)."""
    agg_flat = depacketize(avg, n_params)
    have = expand_packet_mask(counts > 0, payload, n_params)
    return torch.where(have, agg_flat, as_tensor(prev_global, avg.device))


def downlink(new_global: torch.Tensor, client_flats, down_mask,
             payload: int, n_params: int,
             mix_alpha: float = 0.0) -> torch.Tensor:
    """TX: new_global (P,); client_flats (K, P); down_mask (K, N) ->
    (K, P) client state after the downlink (elements of lost packets
    stay local, §3.1; optional APFL-style blend)."""
    dev = new_global.device
    flats = as_tensor(client_flats, dev)
    down_elem = expand_packet_mask(as_tensor(down_mask, dev), payload,
                                   n_params)
    new_flats = torch.where(down_elem > 0, new_global[None, :], flats)
    if mix_alpha > 0:
        new_flats = mix_alpha * flats + (1 - mix_alpha) * new_flats
    return new_flats


class ServerEngine:
    """One round of the RX → N-worker → TX pipeline on ``device``.

    Feed packets with :meth:`rx` (payload rows ride alongside DATA
    packets — the 4-byte wire index is ``Packet.index``), then
    :meth:`finalize_round` runs the END divide and :meth:`distribute`
    the TX/downlink step.  ``device=None`` is the CUDA device.
    """

    def __init__(self, cfg: EngineConfig, weights=None, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.fsm = ServerFSM(cfg.n_clients, cfg.n_slots)
        self.agg = StreamingAggregator(cfg.n_slots, cfg.payload,
                                       use_kernel=cfg.use_kernel,
                                       device=self.device)
        self.weights = (np.ones(cfg.n_clients, np.float32) if weights is None
                        else host_array(weights, np.float32))
        # per-worker rings of (slot, weight, payload-row).  ``rr`` demux
        # (default) spreads arrivals round-robin like the paper's RX
        # core; ``slot`` demux pins every slot to one worker, making
        # same-slot collisions maximal — a race stress mode.
        self._rings: List[List[Tuple[int, float, np.ndarray]]] = \
            [[] for _ in range(cfg.n_workers)]
        self._rr_next = 0
        # compile=True: RX records accepted arrivals with no device work;
        # the whole round is folded from one drain schedule at END
        self._pend_slots: List[int] = []
        self._pend_weights: List[float] = []
        self._pend_payloads: List[np.ndarray] = []
        self._pend_q8: List[bool] = []       # wire_dtype per arrival
        self._pend_scales: List[float] = []  # q8 dequant scale (DESIGN.md §9)
        self._pend_clients: List[int] = []   # robust table row (DESIGN.md §11)
        # robust table modes (DESIGN.md §11): the eager engine keeps the
        # per-slot client table on the host, one deduplicated decoded row
        # per (slot, client), beside the rings (which still drain, for
        # stats that match the compiled schedule's, but fold nothing)
        if cfg.agg_mode in ("trimmed_mean", "median") and not cfg.compile:
            self._tab = np.zeros((cfg.n_slots, cfg.n_clients, cfg.payload),
                                 np.float32)
            self._tab_mask = np.zeros((cfg.n_slots, cfg.n_clients),
                                      np.float32)
        else:
            self._tab = None
            self._tab_mask = None
        self._events_seen = 0
        self._deadline_fired = False
        self.stats = EngineStats()

    # -- RX core --------------------------------------------------------------
    def rx(self, packet: Packet, payload=None) -> List[Packet]:
        """Process one arriving packet; returns control replies.

        DATA packets must carry their payload row (W,).  Duplicates —
        same (client, index) seen before — are dropped here, mirroring
        the set semantics of ``ServerFSM.uplink``.  With
        ``cfg.round_deadline`` set, the uplink barrier closes after that
        many rx events and every later DATA packet is dropped and
        counted in ``stats.late_dropped`` (DESIGN.md §8).
        """
        if (self.cfg.round_deadline is not None
                and not self._deadline_fired
                and self._events_seen >= self.cfg.round_deadline):
            self._fire_deadline()
        self._events_seen += 1
        if packet.kind != Kind.DATA:
            replies = self.fsm.on_packet(packet)
            self.stats.control_replies += len(replies)
            return replies
        if self._deadline_fired:
            self.stats.late_dropped += 1
            return []
        if payload_malformed(payload, packet.wire_dtype != "f32",
                             packet.scale):
            # dropped before the FSM and the dedup set see it, so a
            # clean retransmission of the same slot is still accepted
            self.stats.malformed_dropped += 1
            return []
        c, slot = packet.client, packet.index
        if self.fsm.phase[c] != ServerPhase.RECV_PARAMS:
            self.stats.phase_dropped += 1
            return []
        if slot in self.fsm.uplink[c]:
            self.stats.duplicates_dropped += 1
            return []
        assert payload is not None, "DATA packet without payload"
        self.fsm.on_packet(packet)               # records the arrival
        if self.cfg.compile:
            # record only; q8 payloads stay int8 so the decode runs in
            # the kernel
            self._pend_slots.append(slot)
            self._pend_weights.append(float(self.weights[c]))
            self._pend_payloads.append(payload)
            self._pend_q8.append(packet.wire_dtype != "f32")
            self._pend_scales.append(packet.scale)
            self._pend_clients.append(c)
            self.stats.data_enqueued += 1
            return []
        if self.cfg.ring_assign == "slot":
            worker = slot % self.cfg.n_workers
        else:
            worker = self._rr_next
            self._rr_next = (self._rr_next + 1) % self.cfg.n_workers
        if packet.wire_dtype != "f32":
            # eager path: wire-decode at RX (the same elementwise
            # q * scale the q8 kernel applies)
            row = (np.asarray(payload, np.int8).astype(np.float32)
                   * np.float32(packet.scale))
        else:
            row = np.asarray(payload, np.float32)
        if self._tab is not None:         # robust table modes (§11)
            self._tab[slot, c] = row
            self._tab_mask[slot, c] = 1.0
        ring = self._rings[worker]
        ring.append((slot, float(self.weights[c]), row))
        self.stats.data_enqueued += 1
        if len(ring) >= self.cfg.ring_capacity:
            self._drain(worker)
        return []

    # -- worker cores ---------------------------------------------------------
    def _drain(self, worker: int) -> None:
        ring = self._rings[worker]
        if not ring:
            return
        self._rings[worker] = []
        self.stats.batches_drained += 1
        if self._tab is not None:
            # robust table modes: the table already holds every row, and
            # the finalize never reads the mean accumulator, so a drain
            # only counts its batch (the stats match the compiled ones)
            return
        idx = np.array([s for s, _, _ in ring], np.int32)
        w = np.array([wt for _, wt, _ in ring], np.float32)
        payloads = as_tensor(np.stack([p for _, _, p in ring]), self.device)
        if self.cfg.agg_mode == "norm_clip":
            # per-packet influence bound, elementwise per packet: the
            # compiled schedule computes the same bits
            w = norm_clip_weights(as_tensor(w, self.device), payloads,
                                  tau=self.cfg.clip_tau)
        self.agg.scatter_add(payloads, idx, weights=w, mode=self.cfg.mode)

    def flush(self) -> None:
        """Drain every ring (the workers' post-END cleanup pass)."""
        for wkr in range(self.cfg.n_workers):
            self._drain(wkr)

    # -- deadline / quorum ----------------------------------------------------
    def _fire_deadline(self) -> None:
        newly = self.fsm.deadline_expired()
        self.stats.stragglers_timed_out += len(newly)
        self._deadline_fired = True

    def _close_round(self) -> None:
        """Close the uplink barrier before the END divide: the deadline
        (if set and not yet fired), then the quorum guard."""
        if self.cfg.round_deadline is not None and not self._deadline_fired:
            self._fire_deadline()
        check_quorum(self.fsm.participants(), self.cfg.min_clients,
                     self.stats.stragglers_timed_out)

    # -- END: count-normalized divide ----------------------------------------
    def finalize_round(self, prev_global
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(prev_global (P,)) -> (new_global (P,), counts (N,)).

        Slots with count 0 keep the previous round's global value.  With
        ``cfg.compile`` the recorded arrivals are demuxed into one drain
        schedule and folded by ``engine_compiled.dispatch_round``.  The
        robust table modes finalize the client table with the
        rank-select kernel and return its per-slot contributor count in
        place of the counts; client weights do not enter (rank
        statistics are unweighted).
        """
        self._close_round()
        if self.cfg.compile:
            new_global, counts, _ = self._finalize_compiled(prev_global)
            return new_global, counts
        self.flush()
        if self._tab is not None:
            agg, m = _ops.robust_finalize(
                torch.from_numpy(self._tab).to(self.device),
                torch.from_numpy(self._tab_mask).to(self.device),
                median=(self.cfg.agg_mode == "median"),
                beta=self.cfg.trim_beta)
            # on the CPU the tensors above share the host table's memory:
            # clear it only once the finalize has read it
            self._tab[...] = 0.0
            self._tab_mask[...] = 0.0
            return fallback_global(agg, m, prev_global, self.cfg.payload,
                                   self.cfg.n_params), m
        new_global = fallback_global(self.agg.finalize(), self.agg.counts,
                                     prev_global, self.cfg.payload,
                                     self.cfg.n_params)
        return new_global, self.agg.counts

    def finalize_and_distribute(self, prev_global, client_flats, down_mask,
                                mix_alpha: float = 0.0
                                ) -> Tuple[torch.Tensor, torch.Tensor,
                                           torch.Tensor]:
        """END + TX in one step -> (new_global, counts, new_client_flats)."""
        if self.cfg.compile:
            self._close_round()
            return self._finalize_compiled(prev_global, client_flats,
                                           down_mask, mix_alpha)
        new_global, counts = self.finalize_round(prev_global)
        new_flats = self.distribute(new_global, client_flats, down_mask,
                                    mix_alpha=mix_alpha)
        return new_global, counts, new_flats

    def _finalize_compiled(self, prev_global, client_flats=None,
                           down_mask=None, mix_alpha: float = 0.0):
        from repro_torch.core import engine_compiled as ec
        n_q8 = sum(self._pend_q8)
        scales = None
        if n_q8 == 0:
            pay = (np.asarray(self._pend_payloads, np.float32)
                   if self._pend_payloads
                   else np.zeros((0, self.cfg.payload), np.float32))
        elif n_q8 == len(self._pend_payloads):
            # homogeneous q8 round: int8 schedule + scale column, decoded
            # inside the q8 kernel
            pay = np.asarray(self._pend_payloads, np.int8)
            scales = np.asarray(self._pend_scales, np.float32)
        else:
            # mixed wire round: decode the q8 rows on the host
            pay = np.stack([
                np.asarray(p, np.int8).astype(np.float32) * np.float32(s)
                if q else np.asarray(p, np.float32)
                for p, q, s in zip(self._pend_payloads, self._pend_q8,
                                   self._pend_scales)])
        sched = ec.build_drain_schedule(
            np.asarray(self._pend_slots, np.int32),
            np.asarray(self._pend_weights, np.float32),
            pay,
            n_workers=self.cfg.n_workers,
            ring_capacity=self.cfg.ring_capacity,
            ring_assign=self.cfg.ring_assign, scales=scales,
            clients=np.asarray(self._pend_clients, np.int32))
        self._pend_slots, self._pend_weights, self._pend_payloads = [], [], []
        self._pend_q8, self._pend_scales, self._pend_clients = [], [], []
        total, counts, new_global, new_flats = ec.dispatch_round(
            self.cfg, sched, self.agg.total, self.agg.counts, prev_global,
            client_flats=client_flats, down_mask=down_mask,
            mix_alpha=mix_alpha)
        self.agg.total, self.agg.counts = total, counts
        self.stats.batches_drained += sched.n_batches
        return new_global, counts, new_flats

    # -- TX core: downlink with client fallback ------------------------------
    def distribute(self, new_global: torch.Tensor, client_flats, down_mask,
                   mix_alpha: float = 0.0) -> torch.Tensor:
        """new_global (P,); client_flats (K, P); down_mask (K, N) ->
        (K, P) client state after the downlink (lost elements stay
        local; optional APFL-style blend)."""
        return downlink(new_global, client_flats, down_mask,
                        self.cfg.payload, self.cfg.n_params, mix_alpha)

    def up_mask(self) -> torch.Tensor:
        """(K, N) deduplicated protocol-level arrival mask."""
        m = np.zeros((self.cfg.n_clients, self.cfg.n_slots), np.float32)
        pairs = [(c, s) for c, got in enumerate(self.fsm.uplink)
                 for s in got]
        if pairs:
            cs, ss = np.asarray(pairs, np.int64).T
            m[cs, ss] = 1.0
        return torch.from_numpy(m).to(self.device)


# ---------------------------------------------------------------------------
# Stream generation: lossy / out-of-order / duplicated uplink traffic
# ---------------------------------------------------------------------------

def make_uplink_stream(rng: np.random.Generator, client_pk,
                       *, loss_rate: float = 0.0, dup_rate: float = 0.0,
                       shuffle: bool = True, scales=None,
                       versions: Optional[np.ndarray] = None
                       ) -> Tuple[list, torch.Tensor]:
    """Build one round's interleaved uplink from packetized client state.

    client_pk (K, N, W) (numpy array or tensor).  Each DATA packet is
    dropped with probability ``loss_rate``; each survivor is duplicated
    with probability ``dup_rate``; delivery order is shuffled across
    clients and packets (UDP reordering).  START frames precede all
    data, END frames follow.  With ``scales`` (K, N) the stream is the
    compressed uplink: client_pk carries the int8 wire payloads and each
    DATA packet is stamped ``wire_dtype='q8'`` with its scale.

    The rng draws are the reference's, in the same order, so one seed
    gives the same stream in both packages.  Returns (events, up_mask):
    events is a list of ``(Packet, payload)`` pairs with numpy payload
    rows; up_mask (K, N) is a CPU tensor marking packets that arrived
    at least once.
    """
    pk_host = host_array(client_pk)
    K, N, _ = pk_host.shape
    ver = (np.zeros(K, np.int64) if versions is None
           else np.asarray(versions, np.int64))
    keep = (rng.random((K, N)) >= loss_rate if loss_rate > 0.0
            else np.ones((K, N), bool))
    dup_draw = (rng.random((K, N)) < dup_rate if dup_rate > 0.0
                else np.zeros((K, N), bool))
    cs, ns = np.nonzero(keep)
    # duplicates ride adjacent to their original (UDP re-delivery); a
    # single permutation then models cross-client reordering
    reps = 1 + (dup_draw[cs, ns]).astype(np.int64)
    cl, sl = np.repeat(cs, reps), np.repeat(ns, reps)
    if shuffle:
        perm = rng.permutation(cl.size)
        cl, sl = cl[perm], sl[perm]
    events = [(Packet(Kind.START, c, version=int(ver[c])), None)
              for c in range(K)]
    if scales is None:
        events += [(Packet(Kind.DATA, int(c), int(s),
                           version=int(ver[c])), pk_host[c, s])
                   for c, s in zip(cl.tolist(), sl.tolist())]
    else:
        sc_host = host_array(scales, np.float32)
        events += [(Packet(Kind.DATA, int(c), int(s), wire_dtype="q8",
                           scale=float(sc_host[c, s]),
                           version=int(ver[c])), pk_host[c, s])
                   for c, s in zip(cl.tolist(), sl.tolist())]
    events += [(Packet(Kind.END, c, version=int(ver[c])), None)
               for c in range(K)]
    return events, torch.from_numpy(keep.astype(np.float32))


def run_engine_round(cfg: EngineConfig, client_flats, prev_global,
                     events: Iterable, down_mask=None, weights=None,
                     mix_alpha: float = 0.0, device=None) -> RoundResult:
    """Drive one full round: RX the event stream, divide at END, TX.

    client_flats (K, P) is only used for the downlink fallback; the
    uplink payloads travel inside ``events`` (see make_uplink_stream).
    Inputs may be numpy arrays or tensors; results are tensors on
    ``device`` (``None``: the CUDA device).  With ``cfg.compile`` the
    round routes through the compiled engine's bulk path
    (core/engine_compiled.py): one vectorized demux pass, then the whole
    drain schedule folded on the device with no host sync in between.
    """
    if cfg.compile:
        from repro_torch.core.engine_compiled import run_compiled_round
        return run_compiled_round(cfg, client_flats, prev_global, events,
                                  down_mask=down_mask, weights=weights,
                                  mix_alpha=mix_alpha, device=device)
    engine = ServerEngine(cfg, weights=weights, device=device)
    for packet, payload in events:
        engine.rx(packet, payload)
    new_global, counts = engine.finalize_round(prev_global)
    new_flats = None
    if down_mask is not None:
        new_flats = engine.distribute(new_global, client_flats, down_mask,
                                      mix_alpha=mix_alpha)
    return RoundResult(new_global, counts, engine.up_mask(), new_flats,
                       engine.stats)
