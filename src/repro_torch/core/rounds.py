"""Multi-round FedAvg driver: deadline-closed partial rounds + churn.

The paper runs one barrier round over a fixed client set; a server for
millions of users never sees that — clients join, leave, get sampled in
and out per round, and straggle mid-upload.  This driver turns the
compiled round engine (core/engine_compiled.py, DESIGN.md §8) into a
continuously serving loop:

- **Per-round sampling**: each round Bernoulli-samples the currently
  *active* clients at ``participation`` rate.
- **Bernoulli churn**: inactive clients join with ``p_join``, active
  ones leave with ``p_leave``.
- **Stragglers**: a sampled client straggles with ``straggle_rate``:
  it STARTs, delivers a random prefix of its packets, and never sends
  END.  The deadline close times it out and averages what arrived.
- **Attackers** (DESIGN.md §11): ``AttackConfig`` poisons the uplink of
  the first ``n_attackers`` clients, so a sweep can hold the robust
  ``agg_mode``s against the mean.

Every round is one compiled dispatch.  Without local training the
rounds stream through ``run_compiled_rounds`` (round r+1's demux hides
under round r's device work); with a ``train_fn`` the loop is
sequential, because round r+1's uplink payloads depend on round r's
downlink.

Torch port of the synchronous part of ``repro.core.rounds``.  Every
random draw is a numpy ``np.random.Generator`` draw in the reference's
order, so one seed gives both packages the same rounds.  Uplink
payloads ride the event stream as host (numpy) rows; client state and
the globals are tensors on the round's device.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import engine_compiled as ec
from repro_torch.core.device import as_tensor, host_array, resolve_device
from repro_torch.core.packets import packetize
from repro_torch.core.protocol import Kind, Packet
from repro_torch.core.server import (EngineConfig, QuorumError, RoundResult,
                                     make_uplink_stream)

# round_deadline stand-in for "close at finalize": larger than any event
# stream, so nothing is late in-stream but stragglers still time out at
# the round close (ServerEngine._close_round / demux_events)
CLOSE_AT_FINALIZE = 2 ** 62


@dataclasses.dataclass(frozen=True)
class ChurnConfig:
    """Per-round membership + participation dynamics."""
    participation: float = 1.0     # Bernoulli sampling of active clients
    p_join: float = 0.0            # inactive -> active per round
    p_leave: float = 0.0           # active -> inactive per round
    straggle_rate: float = 0.0     # sampled client stalls mid-upload
    loss_rate: float = 0.0         # wire loss on uplink DATA
    dup_rate: float = 0.0          # wire duplication on uplink DATA
    down_loss_rate: float = 0.0    # wire loss on downlink packets

    def __post_init__(self):
        for f in ("participation", "p_join", "p_leave", "straggle_rate",
                  "loss_rate", "dup_rate", "down_loss_rate"):
            v = getattr(self, f)
            if not 0.0 <= v <= 1.0:
                raise ValueError(f"{f} must be in [0, 1], got {v}")


@dataclasses.dataclass(frozen=True)
class AttackConfig:
    """Byzantine attacker models for the churn driver (DESIGN.md §11).

    Attackers are the first ``n_attackers`` client ids, so a sweep's
    honest/attacker split is reproducible from the config alone.

    - ``sign_flip``: the attacker uploads the negated update.
    - ``scale``: the attacker boosts its update by ``boost``.
    - ``nan``: the attacker injects NaNs into random payload elements at
      ``nan_rate``; the malformed-packet filter must absorb them.
    - ``label_flip``: a *data* attack, the identity on the wire (the
      sweep's ``train_fn`` implements it).
    """
    model: str = "none"        # none|sign_flip|scale|label_flip|nan
    n_attackers: int = 0       # attackers are client ids [0, n_attackers)
    boost: float = 10.0        # scale-attack multiplier
    nan_rate: float = 0.25     # per-element NaN injection probability

    def __post_init__(self):
        if self.model not in ("none", "sign_flip", "scale", "label_flip",
                              "nan"):
            raise ValueError(
                f"attack model must be none|sign_flip|scale|label_flip|"
                f"nan, got {self.model!r}")
        if self.n_attackers < 0:
            raise ValueError(f"n_attackers must be >= 0, "
                             f"got {self.n_attackers}")
        if not 0.0 <= self.nan_rate <= 1.0:
            raise ValueError(f"nan_rate must be in [0, 1], "
                             f"got {self.nan_rate}")

    def mask(self, n_clients: int) -> np.ndarray:
        """(K,) bool attacker mask."""
        m = np.zeros(n_clients, bool)
        m[:min(self.n_attackers, n_clients)] = True
        return m


def apply_attack(rng: np.random.Generator, client_pk,
                 attack: Optional[AttackConfig]):
    """Apply a wire-level attacker model to packetized uplink state.

    client_pk (K, N, W) f32 (numpy array or tensor) -> a numpy (K, N, W)
    copy with the attacker rows poisoned per ``attack.model``;
    ``label_flip`` and ``none`` return ``client_pk`` as given.  Only the
    ``nan`` model consumes ``rng``, so a deterministic attacker does not
    perturb the driver's churn/loss draws.
    """
    if (attack is None or attack.n_attackers == 0
            or attack.model in ("none", "label_flip")):
        return client_pk
    pk = host_array(client_pk, np.float32).copy()
    att = attack.mask(pk.shape[0])
    if attack.model == "sign_flip":
        pk[att] = -pk[att]
    elif attack.model == "scale":
        pk[att] = np.float32(attack.boost) * pk[att]
    else:                                  # nan injector
        sub = pk[att]
        sub[rng.random(sub.shape) < attack.nan_rate] = np.nan
        pk[att] = sub
    return pk


@dataclasses.dataclass
class RoundLog:
    """Host-side bookkeeping for one driven round."""
    selected: np.ndarray           # (K,) bool — sampled this round
    stragglers: np.ndarray         # (K,) bool — sampled but stalled
    active: np.ndarray             # (K,) bool — membership after churn
    n_events: int                  # uplink stream length
    down_mask: np.ndarray          # (K, N) downlink delivery mask


@dataclasses.dataclass
class ChurnHistory:
    results: List[RoundResult]     # one engine RoundResult per round
    logs: List[RoundLog]

    @property
    def final_global(self) -> torch.Tensor:
        if not self.results:
            raise ValueError("no completed rounds (quorum failed on the "
                             "first round?) — final_global is undefined")
        return self.results[-1].new_global


def make_partial_round_events(rng: np.random.Generator, client_pk,
                              selected: np.ndarray,
                              stragglers: np.ndarray, *,
                              loss_rate: float = 0.0,
                              dup_rate: float = 0.0,
                              ) -> Tuple[list, np.ndarray]:
    """One partial-participation round's uplink event stream.

    Builds the same lossy/duplicated/shuffled stream as
    ``server.make_uplink_stream`` restricted to ``selected`` clients;
    clients flagged in ``stragglers`` send START and a random *prefix*
    of their surviving packets but never END, so a deadline-closed
    round times them out with their delivered prefix in the aggregate.

    Returns ``(events, up_mask)`` where up_mask (K, N) numpy marks the
    packets that actually ride the stream (the straggler prefix
    included) — by construction the engine's post-dedup arrival mask.
    """
    K, N, _ = client_pk.shape
    selected = np.asarray(selected, bool)
    stragglers = np.asarray(stragglers, bool) & selected
    events, up = make_uplink_stream(rng, client_pk, loss_rate=loss_rate,
                                    dup_rate=dup_rate)
    up = up.numpy().copy()
    up[~selected] = 0.0
    # a straggler delivers a prefix of its own arrival order: draw the
    # stall point uniformly over its surviving unique packets
    n_unique = up.sum(axis=1).astype(np.int64)
    stall = np.where(stragglers, rng.integers(0, np.maximum(n_unique, 1)),
                     np.iinfo(np.int64).max)
    delivered = np.zeros(K, np.int64)
    seen: List[set] = [set() for _ in range(K)]
    out = []
    for packet, payload in events:
        c = packet.client
        if not selected[c]:
            continue                       # not sampled: silent this round
        if packet.kind is Kind.END and stragglers[c]:
            continue                       # straggler never ENDs
        if packet.kind is Kind.DATA:
            if delivered[c] >= stall[c]:
                continue                   # stalled: nothing more is sent
            if packet.index not in seen[c]:
                seen[c].add(packet.index)
                delivered[c] += 1
        out.append((packet, payload))
    # up_mask keeps only packets that made it out before the stall
    for c in range(K):
        if stragglers[c]:
            mask = np.zeros(N, np.float32)
            mask[list(seen[c])] = 1.0
            up[c] = mask
    return out, up


def losses_only_twin(events: list, deadline: int) -> list:
    """The losses-only equivalent of closing ``events`` at ``deadline``:
    keep the pre-deadline prefix and let every client END normally —
    whatever trails the cut is exactly the wire losses.  A deadline-
    closed round must match this round bitwise (DESIGN.md §8).
    """
    events = list(events)
    prefix = events[:deadline]
    clients = sorted({p.client for p, _ in events})
    started, ended = set(), set()
    for p, _ in prefix:
        if p.kind is Kind.START:
            started.add(p.client)
        elif p.kind is Kind.END and p.client in started:
            ended.add(p.client)
    return prefix + [(Packet(Kind.END, c), None)
                     for c in clients if c not in ended]


def make_straggler_stream(events: list, straggler: int, keep: int
                          ) -> Tuple[list, int, list]:
    """Rearrange one round's uplink so ``straggler`` stalls mid-upload.

    The straggler's first ``keep`` unique packets (duplicates ride
    along) stay in the pre-deadline body; the rest of its DATA and its
    END trail the deadline.  Returns ``(deadline_events, deadline,
    losses_events)`` with the losses-only twin from
    ``losses_only_twin``.
    """
    starts = [e for e in events if e[0].kind is Kind.START]
    datas = [e for e in events if e[0].kind is Kind.DATA]
    ends = [e for e in events if e[0].kind is Kind.END]
    seen: set = set()
    kept, tail = [], []
    for ev in datas:
        p = ev[0]
        if p.client != straggler:
            kept.append(ev)
        elif p.index in seen or len(seen) < keep:
            seen.add(p.index)
            kept.append(ev)            # prefix (duplicates ride along)
        else:
            tail.append(ev)
    other_ends = [e for e in ends if e[0].client != straggler]
    strag_end = [e for e in ends if e[0].client == straggler]
    if not strag_end:                  # the stream may have lost it
        strag_end = [(Packet(Kind.END, straggler), None)]
    pre = starts + kept + other_ends
    deadline_events = pre + tail + strag_end
    return (deadline_events, len(pre),
            losses_only_twin(deadline_events, len(pre)))


def _step_membership(rng: np.random.Generator, active: np.ndarray,
                     churn: ChurnConfig) -> np.ndarray:
    K = active.shape[0]
    joins = ~active & (rng.random(K) < churn.p_join)
    leaves = active & (rng.random(K) < churn.p_leave)
    return (active | joins) & ~leaves


def _packetize_host(flats, payload: int) -> np.ndarray:
    """(K, P) client state -> (K, N, W) numpy wire rows: ``packetize``
    on a host copy, since the events carry host payloads."""
    return packetize(as_tensor(flats, torch.device("cpu")),
                     payload).numpy()


def run_churn_rounds(cfg: EngineConfig, churn: ChurnConfig, client_flats,
                     prev_global, n_rounds: int, *,
                     rng: np.random.Generator, weights=None,
                     train_fn: Optional[Callable] = None,
                     mix_alpha: float = 0.0,
                     attack: Optional[AttackConfig] = None,
                     device=None) -> ChurnHistory:
    """Drive ``n_rounds`` deadline-closed FedAvg rounds with churn.

    ``cfg`` must have ``compile=True`` (each round is one compiled
    dispatch).  If ``cfg.round_deadline`` is None the rounds close at
    finalize (``CLOSE_AT_FINALIZE``) — stragglers still time out,
    nothing is dropped as late in-stream.  ``device=None`` is the CUDA
    device.

    ``train_fn(client_flats, round_idx) -> client_flats`` runs the
    clients' local updates between rounds.  Without it the uplink
    payloads are static and the rounds stream through
    ``run_compiled_rounds``; with it the loop is sequential.
    ``attack`` poisons the attackers' uplink rows every round.

    A round that closes below ``cfg.min_clients`` raises
    ``QuorumError``; the rounds already served ride on the exception
    as ``e.history`` (a ``ChurnHistory`` of the completed prefix).
    """
    if not cfg.compile:
        raise ValueError("run_churn_rounds drives the compiled engine; "
                         "pass EngineConfig(compile=True, ...)")
    if cfg.round_deadline is None:
        cfg = dataclasses.replace(cfg, round_deadline=CLOSE_AT_FINALIZE)
    dev = resolve_device(device)
    K = cfg.n_clients
    active = np.ones(K, bool)
    logs: List[RoundLog] = []

    def next_round(pk):
        nonlocal active
        active = _step_membership(rng, active, churn)
        sel = active & (rng.random(K) < churn.participation)
        strag = sel & (rng.random(K) < churn.straggle_rate)
        events, _ = make_partial_round_events(
            rng, apply_attack(rng, pk, attack), sel, strag,
            loss_rate=churn.loss_rate, dup_rate=churn.dup_rate)
        # downlink only reaches clients that finished the round; lost
        # downlink packets keep the client's local value (paper §3.1)
        finishers = sel & ~strag
        down = ((rng.random((K, cfg.n_slots)) >= churn.down_loss_rate)
                & finishers[:, None]).astype(np.float32)
        logs.append(RoundLog(sel, strag, active.copy(), len(events), down))
        return events, down

    flats = as_tensor(client_flats, dev)
    if train_fn is None:
        # static payloads: packetize once, not once per round
        static_pk = _packetize_host(flats, cfg.payload)

        def gen():
            for _ in range(n_rounds):
                events, down = next_round(static_pk)
                yield events, flats, down
        try:
            results = ec.run_compiled_rounds(cfg, gen(), prev_global,
                                             weights=weights,
                                             mix_alpha=mix_alpha, device=dev)
        except QuorumError as e:
            done = getattr(e, "results", [])
            e.history = ChurnHistory(done, logs[:len(done)])
            raise
        return ChurnHistory(results, logs)

    results: List[RoundResult] = []
    g = as_tensor(prev_global, dev)
    for r in range(n_rounds):
        flats = train_fn(flats, r)
        events, down = next_round(_packetize_host(flats, cfg.payload))
        try:
            res = ec.run_compiled_round(cfg, flats, g, events,
                                        down_mask=down, weights=weights,
                                        mix_alpha=mix_alpha, device=dev)
        except QuorumError as e:
            e.history = ChurnHistory(results, logs[:len(results)])
            raise
        results.append(res)
        flats, g = res.new_client_flats, res.new_global
    return ChurnHistory(results, logs)
