"""The port's multi-round churn driver (``core/rounds.py``) held against
the JAX package's, mirroring tests/test_rounds.py (its unsharded tests).

Both drivers draw every random number from one ``np.random.Generator``
in the same order, so one seed gives both packages the same rounds:
the same membership, sampling, stragglers, streams and downlink masks.
On integer payloads every sum is exact, so the served rounds are equal
bit for bit.  The error-feedback test trains a reduced CNN with the
port's own SGD (torch generators draw other numbers than
``jax.random``), so it holds the port to the reference test's relative
claims, not to the JAX run.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import rounds as ref_rounds
from repro.core import server as ref
from repro_torch.configs.paper_cnn import CNNConfig
from repro_torch.core import rounds
from repro_torch.core import server as port
from repro_torch.core.aggregation import fused_round_step
from repro_torch.core.fedavg import FedAvgConfig, ModelFns, _local_update
from repro_torch.core.packets import (PacketizedShape, flatten_params,
                                      loss_mask, packetize,
                                      quantize_batch_with_feedback)
from repro_torch.core.protocol import Kind
from repro_torch.data.federated import partition_iid
from repro_torch.data.synthetic import synthetic_image_classification
from repro_torch.models import cnn

K, P, W = 8, 320, 32
N = P // W
CPU = "cpu"


def _kw(**kw):
    return dict(n_clients=K, n_params=P, payload=W, ring_capacity=8,
                compile=True, **kw)


def _cfg(**kw):
    return port.EngineConfig(**_kw(**kw))


def _flats(seed):
    rng = np.random.default_rng(seed)
    return rng, rng.integers(-8, 9, (K, P)).astype(np.float32)


def _run_both(churn, flats, prev, n_rounds, seed, **cfg_kw):
    """The port's and the reference's driver on the same seed."""
    hist = rounds.run_churn_rounds(
        port.EngineConfig(**_kw(**cfg_kw)), churn, flats, prev, n_rounds,
        rng=np.random.default_rng(seed), device=CPU)
    want = ref_rounds.run_churn_rounds(
        ref.EngineConfig(**_kw(**cfg_kw)),
        ref_rounds.ChurnConfig(**dataclasses.asdict(churn)),
        jnp.asarray(flats), jnp.asarray(prev), n_rounds,
        rng=np.random.default_rng(seed))
    return hist, want


def _assert_history_matches(hist, want):
    assert len(hist.results) == len(want.results)
    for res, wr, log, wl in zip(hist.results, want.results, hist.logs,
                                want.logs):
        for name in ("new_global", "counts", "up_mask", "new_client_flats"):
            np.testing.assert_array_equal(getattr(res, name).numpy(),
                                          np.asarray(getattr(wr, name)))
        assert dataclasses.asdict(res.stats) == dataclasses.asdict(wr.stats)
        for name in ("selected", "stragglers", "active", "down_mask"):
            np.testing.assert_array_equal(getattr(log, name),
                                          np.asarray(getattr(wl, name)))
        assert log.n_events == wl.n_events


def test_partial_round_events_respect_selection_and_stall():
    rng, flats = _flats(0)
    pk = packetize(torch.from_numpy(flats), W)
    sel = np.array([True] * 6 + [False] * 2)
    strag = np.array([True, True] + [False] * 6)
    events, up = rounds.make_partial_round_events(rng, pk, sel, strag,
                                                  loss_rate=0.2,
                                                  dup_rate=0.2)
    assert {p.client for p, _ in events} <= {0, 1, 2, 3, 4, 5}
    ends = {p.client for p, _ in events if p.kind is Kind.END}
    assert ends == {2, 3, 4, 5}               # stragglers never END
    assert up[6].sum() == 0 and up[7].sum() == 0
    for c in (0, 1):
        stream_c = {p.index for p, _ in events
                    if p.client == c and p.kind is Kind.DATA}
        assert set(np.nonzero(up[c])[0].tolist()) == stream_c
    # the reference builds the same stream from the same draws
    ev_ref, up_ref = ref_rounds.make_partial_round_events(
        _flats(0)[0], jnp.asarray(pk.numpy()), sel, strag, loss_rate=0.2,
        dup_rate=0.2)
    np.testing.assert_array_equal(up, np.asarray(up_ref))
    assert [(p.kind.name, p.client, p.index) for p, _ in events] == \
        [(p.kind.name, p.client, p.index) for p, _ in ev_ref]


def test_round_results_match_fused_round_step():
    """Every driven partial round is the fused dataflow on its own up
    and down masks (bitwise, integer payloads), and the JAX driver's."""
    rng, flats = _flats(1)
    churn = rounds.ChurnConfig(participation=0.6, straggle_rate=0.4,
                               loss_rate=0.15, dup_rate=0.2,
                               down_loss_rate=0.1)
    prev = np.zeros(P, np.float32)
    hist = rounds.run_churn_rounds(_cfg(), churn, flats, prev, 4, rng=rng,
                                   device=CPU)
    g = torch.zeros(P)
    t = torch.from_numpy(flats)
    for res, log in zip(hist.results, hist.logs):
        down = torch.from_numpy(log.down_mask)
        nf, ng, cnt = fused_round_step(t, res.up_mask, down, g, W,
                                       mode="exact")
        assert torch.equal(res.new_global, ng)
        assert torch.equal(res.counts, cnt)
        assert torch.equal(res.new_client_flats, nf)
        assert torch.equal(res.counts, res.up_mask.sum(dim=0))
        g = ng
    hist2, want = _run_both(churn, flats, prev, 4, 1)
    _assert_history_matches(hist2, want)


def test_straggler_accounting_per_round():
    _, flats = _flats(2)
    churn = rounds.ChurnConfig(participation=0.7, straggle_rate=0.5,
                               p_leave=0.2, p_join=0.5)
    hist, want = _run_both(churn, flats, np.zeros(P, np.float32), 5, 2)
    for res, log in zip(hist.results, hist.logs):
        finishers = int((log.selected & ~log.stragglers).sum())
        assert res.stats.stragglers_timed_out == K - finishers
        assert res.stats.late_dropped == 0    # nothing trails the close
        assert (log.down_mask.sum(axis=1) > 0).sum() <= finishers
    _assert_history_matches(hist, want)


def test_sequential_train_fn_chains_downlink():
    """With a train_fn the loop runs round after round on the downlinked
    state; with full participation and no downlink loss every client
    adopts the global."""
    _, flats = _flats(3)
    churn = rounds.ChurnConfig(participation=1.0, down_loss_rate=0.0)
    seen = []
    hist = rounds.run_churn_rounds(
        _cfg(), churn, flats, np.zeros(P, np.float32), 3,
        rng=np.random.default_rng(3),
        train_fn=lambda f, r: seen.append(r) or f, device=CPU)
    assert seen == [0, 1, 2]
    g1 = hist.results[0].new_global
    assert torch.equal(hist.results[0].new_client_flats,
                       g1[None].expand(K, P))
    want = ref_rounds.run_churn_rounds(
        ref.EngineConfig(**_kw()),
        ref_rounds.ChurnConfig(participation=1.0, down_loss_rate=0.0),
        jnp.asarray(flats), jnp.zeros((P,)), 3,
        rng=np.random.default_rng(3), train_fn=lambda f, r: f)
    _assert_history_matches(hist, want)


def test_rounds_chain_prev_global():
    """An all-straggler round contributes nothing: its global equals the
    previous round's, and the chain continues."""
    _, flats = _flats(4)
    hist = rounds.run_churn_rounds(
        _cfg(), rounds.ChurnConfig(participation=1.0, straggle_rate=0.0),
        flats, np.zeros(P, np.float32), 2, rng=np.random.default_rng(4),
        device=CPU)
    hist2 = rounds.run_churn_rounds(
        _cfg(), rounds.ChurnConfig(participation=0.0), flats,
        hist.final_global, 2, rng=np.random.default_rng(99), device=CPU)
    for res in hist2.results:
        assert torch.equal(res.new_global, hist.final_global)
        assert res.stats.stragglers_timed_out == K


def test_quorum_guard_stops_underpopulated_rounds():
    rng, flats = _flats(5)
    with pytest.raises(port.QuorumError):
        rounds.run_churn_rounds(_cfg(min_clients=1),
                                rounds.ChurnConfig(participation=0.0), flats,
                                np.zeros(P, np.float32), 1, rng=rng,
                                device=CPU)


def test_quorum_failure_preserves_completed_rounds():
    """The QuorumError carries the completed prefix as ``e.history``;
    seed 0 gives both packages the same two served rounds."""
    _, flats = _flats(5)
    churn = rounds.ChurnConfig(participation=0.55)
    with pytest.raises(port.QuorumError) as ei:
        rounds.run_churn_rounds(_cfg(min_clients=4), churn, flats,
                                np.zeros(P, np.float32), 6,
                                rng=np.random.default_rng(0), device=CPU)
    with pytest.raises(ref.QuorumError) as ei_ref:
        ref_rounds.run_churn_rounds(
            ref.EngineConfig(**_kw(min_clients=4)),
            ref_rounds.ChurnConfig(participation=0.55), jnp.asarray(flats),
            jnp.zeros((P,)), 6, rng=np.random.default_rng(0))
    hist = ei.value.history
    assert len(hist.results) == 2
    assert len(hist.logs) == len(hist.results)
    assert str(ei.value) == str(ei_ref.value)
    _assert_history_matches(hist, ei_ref.value.history)
    for res, log in zip(hist.results, hist.logs):
        assert int((log.selected & ~log.stragglers).sum()) >= 4
        assert torch.equal(res.counts, res.up_mask.sum(dim=0))


def test_driver_requires_compiled_engine_and_validates_churn():
    rng, flats = _flats(6)
    with pytest.raises(ValueError):
        rounds.run_churn_rounds(
            port.EngineConfig(n_clients=K, n_params=P, payload=W),
            rounds.ChurnConfig(), flats, np.zeros(P, np.float32), 1,
            rng=rng, device=CPU)
    with pytest.raises(ValueError):
        rounds.ChurnConfig(participation=1.5)


def test_driver_defaults_deadline_to_close_at_finalize():
    _, flats = _flats(7)
    cfg = _cfg()
    assert cfg.round_deadline is None
    prev = np.zeros(P, np.float32)
    hist = rounds.run_churn_rounds(cfg, rounds.ChurnConfig(), flats, prev, 1,
                                   rng=np.random.default_rng(70), device=CPU)
    assert hist.results[0].stats.late_dropped == 0
    explicit = dataclasses.replace(cfg,
                                   round_deadline=rounds.CLOSE_AT_FINALIZE)
    hist2 = rounds.run_churn_rounds(explicit, rounds.ChurnConfig(), flats,
                                    prev, 1, rng=np.random.default_rng(70),
                                    device=CPU)
    assert torch.equal(hist.results[0].new_global,
                       hist2.results[0].new_global)
    assert rounds.CLOSE_AT_FINALIZE == ref_rounds.CLOSE_AT_FINALIZE


def test_entry_point_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, flats = _flats(8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        rounds.run_churn_rounds(_cfg(), rounds.ChurnConfig(), flats,
                                np.zeros(P, np.float32), 1,
                                rng=np.random.default_rng(0))


# ---------------------------------------------------------------------------
# Attackers and the driver's helpers, against the reference's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("model", ["none", "sign_flip", "scale",
                                   "label_flip", "nan"])
def test_apply_attack_matches_reference(model):
    rng = np.random.default_rng(9)
    pk = rng.normal(size=(K, N, W)).astype(np.float32)
    att = rounds.AttackConfig(model=model, n_attackers=3, boost=7.0,
                              nan_rate=0.3)
    got = rounds.apply_attack(np.random.default_rng(1), pk, att)
    want = ref_rounds.apply_attack(
        np.random.default_rng(1), jnp.asarray(pk),
        ref_rounds.AttackConfig(**dataclasses.asdict(att)))
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    honest = ~att.mask(K)
    np.testing.assert_array_equal(np.asarray(got)[honest], pk[honest])
    if model == "nan":
        assert np.isnan(np.asarray(got)[:3]).any()
    np.testing.assert_array_equal(att.mask(K),
                                  np.arange(K) < 3)


def test_nan_attack_is_absorbed_by_the_malformed_filter():
    """The nan attacker's packets are dropped at RX; the served global
    stays finite, and the drop count matches the reference driver."""
    _, flats = _flats(10)
    churn = rounds.ChurnConfig(participation=1.0, loss_rate=0.1)
    att = rounds.AttackConfig("nan", n_attackers=2, nan_rate=0.1)
    hist = rounds.run_churn_rounds(
        _cfg(agg_mode="median"), churn, flats, np.zeros(P, np.float32), 2,
        rng=np.random.default_rng(10), attack=att, device=CPU)
    want = ref_rounds.run_churn_rounds(
        ref.EngineConfig(**_kw(agg_mode="median")),
        ref_rounds.ChurnConfig(**dataclasses.asdict(churn)),
        jnp.asarray(flats), jnp.zeros((P,)), 2,
        rng=np.random.default_rng(10),
        attack=ref_rounds.AttackConfig("nan", n_attackers=2, nan_rate=0.1))
    _assert_history_matches(hist, want)
    for res in hist.results:
        assert res.stats.malformed_dropped > 0
        assert bool(torch.isfinite(res.new_global).all())


@pytest.mark.parametrize("model,kw,match", [
    ("krum", {}, "attack model"), ("scale", {"n_attackers": -1},
                                   "n_attackers"),
    ("nan", {"nan_rate": 1.5}, "nan_rate")])
def test_attack_config_validation(model, kw, match):
    with pytest.raises(ValueError, match=match):
        rounds.AttackConfig(model, **kw)
    with pytest.raises(ValueError, match=match):
        ref_rounds.AttackConfig(model, **kw)


def test_straggler_stream_and_losses_twin_match_reference():
    """A deadline-closed round equals its losses-only twin, bitwise, and
    both stream functions reorder events as the reference's do."""
    rng, flats = _flats(11)
    pk = packetize(torch.from_numpy(flats), W)
    events, _ = port.make_uplink_stream(rng, pk, loss_rate=0.1,
                                        dup_rate=0.2)
    ref_events, _ = ref.make_uplink_stream(_flats(11)[0], np.asarray(pk),
                                           loss_rate=0.1, dup_rate=0.2)
    dl_ev, cut, twin = rounds.make_straggler_stream(events, 3, 5)
    r_dl, r_cut, r_twin = ref_rounds.make_straggler_stream(ref_events, 3, 5)
    key = lambda ev: [(p.kind.name, p.client, p.index) for p, _ in ev]
    assert cut == r_cut
    assert key(dl_ev) == key(r_dl) and key(twin) == key(r_twin)
    kw = dict(n_clients=K, n_params=P, payload=W, ring_capacity=8)
    a = port.run_engine_round(port.EngineConfig(round_deadline=cut, **kw),
                              flats, np.zeros(P, np.float32), dl_ev,
                              device=CPU)
    b = port.run_engine_round(port.EngineConfig(**kw), flats,
                              np.zeros(P, np.float32), twin, device=CPU)
    assert torch.equal(a.new_global, b.new_global)
    assert torch.equal(a.counts, b.counts)
    assert a.stats.stragglers_timed_out == 1
    assert a.stats.late_dropped > 0


# ---------------------------------------------------------------------------
# Error feedback on the q8 wire, through the compiled engine, over rounds
# ---------------------------------------------------------------------------

def _train_reduced_cnn_rounds(wire: str, rounds_: int = 5, seed: int = 0):
    """Reduced-CNN FedAvg through the port's compiled engine, one wire
    format: per round the clients train locally, encode their flats
    (f32, q8 with the error-feedback residual carried, or q8 with the
    residual held at zero) and the engine aggregates a lossy/dup/out-of-
    order stream.  Every wire format gets the same seeds, so the runs
    differ by quantization alone."""
    K2, W2 = 6, 32
    cfg_cnn = CNNConfig(image_size=8, conv_channels=(4, 8, 8, 8),
                        fc_hidden=16)
    data_rng = np.random.default_rng(seed)
    train = synthetic_image_classification(data_rng, 192, image_size=8)
    clients = partition_iid(train, K2, seed=seed)
    fns = ModelFns(init=lambda g: cnn.init_cnn(g, cfg_cnn),
                   loss=lambda p, b, g: cnn.cnn_loss(p, b, cfg_cnn,
                                                     dropout_rng=g),
                   test_metrics=lambda p, d: {})
    fcfg = FedAvgConfig(n_clients=K2, rounds=rounds_, local_epochs=1,
                        batch_size=32, lr=0.05, seed=seed)
    init_gen = torch.Generator().manual_seed(seed)
    like = fns.init(init_gen)
    flat0 = flatten_params(like)
    P2 = int(flat0.shape[0])
    local_update = _local_update(fns, fcfg, like)
    train_gen = torch.Generator().manual_seed(seed + 10)
    down_gen = torch.Generator().manual_seed(seed + 20)
    cfg = port.EngineConfig(n_clients=K2, n_params=P2, payload=W2,
                            ring_capacity=2, compile=True)
    pshape = PacketizedShape(P2, W2)
    client_flats = flat0[None].repeat(K2, 1)
    server = flat0
    stream_rng = np.random.default_rng(seed + 1)
    residuals = torch.zeros((K2, P2))
    globals_ = []
    for _ in range(rounds_):
        client_flats = torch.stack([
            local_update(client_flats[k],
                         {key: v[k] for key, v in clients.items()},
                         train_gen) for k in range(K2)])
        if wire == "f32":
            pk = packetize(client_flats, W2)
            events, _ = port.make_uplink_stream(stream_rng, pk,
                                                loss_rate=0.0468,
                                                dup_rate=0.02)
        else:
            pk, sc, new_res = quantize_batch_with_feedback(
                client_flats, residuals, W2)
            if wire == "q8":      # 'q8_noef' control: residual stays 0
                residuals = new_res
            events, _ = port.make_uplink_stream(stream_rng, pk,
                                                loss_rate=0.0468,
                                                dup_rate=0.02, scales=sc)
        down = loss_mask(down_gen, K2, pshape.n_packets, 0.0468)
        res = port.run_engine_round(cfg, client_flats, server, events,
                                    down_mask=down, device=CPU)
        server, client_flats = res.new_global, res.new_client_flats
        globals_.append(server.numpy().copy())
    return globals_


def test_error_feedback_q8_tracks_f32_across_rounds():
    """The compressed-uplink convergence contract (DESIGN.md §9): with
    the residual carried round to round, the q8 engine's global tracks
    the f32 engine's, while the residual-off control drifts."""
    n_rounds, seed = 5, 1
    g_f32 = _train_reduced_cnn_rounds("f32", n_rounds, seed)
    g_ef = _train_reduced_cnn_rounds("q8", n_rounds, seed)
    g_noef = _train_reduced_cnn_rounds("q8_noef", n_rounds, seed)
    ref_norm = [np.linalg.norm(g) for g in g_f32]
    gap_ef = [np.linalg.norm(a - b) / r
              for a, b, r in zip(g_ef, g_f32, ref_norm)]
    gap_noef = [np.linalg.norm(a - b) / r
                for a, b, r in zip(g_noef, g_f32, ref_norm)]
    # round 0: both start from a zero residual: the same quantization
    np.testing.assert_array_equal(g_ef[0], g_noef[0])
    assert gap_noef[-1] > 1.5 * gap_noef[0], (gap_noef[0], gap_noef[-1])
    assert gap_ef[-1] < 1.4 * gap_ef[0], (gap_ef[0], gap_ef[-1])
    assert gap_ef[-1] < 0.75 * gap_noef[-1], (gap_ef[-1], gap_noef[-1])
