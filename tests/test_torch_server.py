"""The port's server round — eager ``ServerEngine``/``run_engine_round``
and the compiled bulk path — held against the JAX package's
``run_engine_round`` on the same ``make_uplink_stream`` streams.

Equal: ``EngineStats`` field by field, ``up_mask``, counts and the drain
schedule arrays.  ``new_global`` and ``new_client_flats``: bitwise on
integer-valued payloads (and power-of-two q8 scales), where every f32
sum is exact; rtol 1e-5 on Gaussian payloads.  Only ``shards=1``
reference paths are used.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import engine_compiled as ref_ec
from repro.core import server as ref
from repro.core.packets import packetize as ref_packetize
from repro_torch.core import device as port_device
from repro_torch.core import engine_compiled as ec
from repro_torch.core import server as port
from repro_torch.core.protocol import Kind, Packet

K, P, W = 6, 300, 16
N = -(-P // W)


def _inputs(seed, *, integer=True):
    rng = np.random.default_rng(seed)
    flats = (rng.integers(-8, 9, (K, P)) if integer
             else rng.normal(size=(K, P))).astype(np.float32)
    prev = rng.integers(-8, 9, P).astype(np.float32)
    weights = rng.integers(1, 4, K).astype(np.float32)
    down = (rng.random((K, N)) > 0.2).astype(np.float32)
    pk = np.asarray(jax.vmap(lambda f: ref_packetize(f, W))(
        jnp.asarray(flats)))
    return rng, flats, prev, weights, down, pk


def _q8(rng, pk):
    q = rng.integers(-127, 128, pk.shape).astype(np.int8)
    scales = (2.0 ** rng.integers(-4, 1, pk.shape[:2])).astype(np.float32)
    return q, scales


def _mixed(events, rng):
    """Re-encode every other DATA packet of a q8 stream as f32 (the
    decoded row): both wires on one socket."""
    out = []
    for i, (p, pay) in enumerate(events):
        if p.kind.name == "DATA" and i % 2:
            pay = pay.astype(np.float32) * np.float32(p.scale)
            p = dataclasses.replace(p, wire_dtype="f32", scale=1.0)
        out.append((p, pay))
    return out


def _streams(seed, wire, *, integer=True, loss=0.2, dup=0.3):
    rng, flats, prev, weights, down, pk = _inputs(seed, integer=integer)
    scales = None
    if wire != "f32":
        pk, scales = _q8(rng, pk)
    ev_ref, up_ref = ref.make_uplink_stream(
        np.random.default_rng(seed + 100), pk, loss_rate=loss, dup_rate=dup,
        scales=scales)
    ev, up = port.make_uplink_stream(
        np.random.default_rng(seed + 100), pk, loss_rate=loss, dup_rate=dup,
        scales=scales)
    if wire == "mixed":
        ev_ref, ev = _mixed(ev_ref, rng), _mixed(ev, rng)
        for stream in (ev_ref, ev):
            assert {p.wire_dtype for p, _ in stream
                    if p.kind.name == "DATA"} == {"f32", "q8"}
    return dict(flats=flats, prev=prev, weights=weights, down=down,
                ev_ref=ev_ref, ev=ev, up_ref=up_ref, up=up)


def _assert_round(got, want, *, integer=True, flats=True):
    assert dataclasses.asdict(got.stats) == dataclasses.asdict(want.stats)
    np.testing.assert_array_equal(got.up_mask.cpu().numpy(),
                                  np.asarray(want.up_mask))
    np.testing.assert_array_equal(got.counts.cpu().numpy(),
                                  np.asarray(want.counts))
    pairs = [(got.new_global, want.new_global)]
    if flats:
        pairs.append((got.new_client_flats, want.new_client_flats))
    for g, w in pairs:
        if integer:
            np.testing.assert_array_equal(g.cpu().numpy(), np.asarray(w))
        else:
            np.testing.assert_allclose(g.cpu().numpy(), np.asarray(w),
                                       rtol=1e-5, atol=1e-6)


def _both(s, **cfg_kw):
    """The round through the reference and the port (same config)."""
    kw = dict(n_clients=K, n_params=P, payload=W, ring_capacity=7)
    kw.update(cfg_kw)
    want = ref.run_engine_round(ref.EngineConfig(**kw), s["flats"],
                                s["prev"], s["ev_ref"], down_mask=s["down"],
                                weights=s["weights"])
    got = port.run_engine_round(port.EngineConfig(**kw), s["flats"],
                                s["prev"], s["ev"], down_mask=s["down"],
                                weights=s["weights"], device="cpu")
    return got, want


@pytest.mark.parametrize("wire", ["f32", "q8", "mixed"])
@pytest.mark.parametrize("mode", ["exact", "approx"])
@pytest.mark.parametrize("assign", ["rr", "slot"])
@pytest.mark.parametrize("compile_", [False, True],
                         ids=["eager", "compiled"])
def test_round_matches_reference(wire, mode, assign, compile_):
    s = _streams(11, wire)
    np.testing.assert_array_equal(s["up"].numpy(), np.asarray(s["up_ref"]))
    got, want = _both(s, mode=mode, ring_assign=assign, compile=compile_)
    _assert_round(got, want)
    assert got.stats.duplicates_dropped > 0


@pytest.mark.parametrize("mode", ["exact", "approx"])
@pytest.mark.parametrize("compile_", [False, True],
                         ids=["eager", "compiled"])
def test_gaussian_round_within_rtol(mode, compile_):
    s = _streams(12, "f32", integer=False)
    got, want = _both(s, mode=mode, compile=compile_, ring_capacity=5)
    _assert_round(got, want, integer=False)


@pytest.mark.parametrize("mode", ["exact", "approx"])
def test_port_eager_equals_port_compiled_bitwise_on_gaussian(mode):
    """One kernel path, one batching: the two engines share every op."""
    s = _streams(13, "q8", integer=False)
    kw = dict(n_clients=K, n_params=P, payload=W, ring_capacity=5, mode=mode)
    res = [port.run_engine_round(port.EngineConfig(compile=c, **kw),
                                 s["flats"], s["prev"], s["ev"],
                                 down_mask=s["down"], weights=s["weights"],
                                 device="cpu") for c in (False, True)]
    for name in ("new_global", "counts", "new_client_flats"):
        assert torch.equal(getattr(res[0], name), getattr(res[1], name))


@pytest.mark.parametrize("deadline", [0, 40, 120])
@pytest.mark.parametrize("compile_", [False, True],
                         ids=["eager", "compiled"])
def test_deadline_round_matches_reference(deadline, compile_):
    s = _streams(14, "f32", loss=0.1, dup=0.2)
    got, want = _both(s, round_deadline=deadline, compile=compile_)
    _assert_round(got, want)
    if deadline < 120:
        assert got.stats.late_dropped > 0


@pytest.mark.parametrize("compile_", [False, True],
                         ids=["eager", "compiled"])
def test_quorum_error_matches_reference(compile_):
    s = _streams(15, "f32", loss=0.1, dup=0.2)
    kw = dict(round_deadline=20, min_clients=K, compile=compile_)
    with pytest.raises(ref.QuorumError) as e_ref:
        _both(dict(s, ev=[]), **kw)
    with pytest.raises(port.QuorumError) as e:
        port.run_engine_round(
            port.EngineConfig(n_clients=K, n_params=P, payload=W, **kw),
            s["flats"], s["prev"], s["ev"], device="cpu")
    assert str(e.value) == str(e_ref.value)
    assert ec.QuorumError is port.QuorumError


def _poison(events, rng):
    """NaN into one f32 payload, a zero scale into one q8 packet, and a
    clean retransmission of the poisoned f32 slot at the end."""
    out = list(events)
    data = [i for i, (p, _) in enumerate(out) if p.kind.name == "DATA"]
    i = data[3]
    p, pay = out[i]
    bad = np.array(pay, np.float32)
    bad[2] = np.nan
    out[i] = (p, bad)
    j = data[7]
    p2, pay2 = out[j]
    out[j] = (dataclasses.replace(p2, wire_dtype="q8", scale=0.0),
              np.zeros_like(pay2, dtype=np.int8))
    end = next(k for k, (q, _) in enumerate(out) if q.kind.name == "END")
    out.insert(end, (p, pay))
    return out


@pytest.mark.parametrize("compile_", [False, True],
                         ids=["eager", "compiled"])
def test_malformed_packets_drop_like_reference(compile_):
    s = _streams(16, "f32", loss=0.0, dup=0.0)
    rng = np.random.default_rng(0)
    s = dict(s, ev_ref=_poison(s["ev_ref"], rng), ev=_poison(s["ev"], rng))
    got, want = _both(s, compile=compile_)
    _assert_round(got, want)
    assert got.stats.malformed_dropped == 2
    assert bool(torch.isfinite(got.new_global).all())


@pytest.mark.parametrize("wire", ["f32", "q8", "mixed"])
@pytest.mark.parametrize("assign", ["rr", "slot"])
def test_drain_schedule_equals_reference(wire, assign):
    s = _streams(17, wire)
    kw = dict(n_clients=K, n_params=P, payload=W, ring_capacity=7,
              ring_assign=assign)
    sched_r, stats_r, up_r = ref_ec.demux_events(ref.EngineConfig(**kw),
                                                 s["ev_ref"], s["weights"])
    sched, stats, up = ec.demux_events(port.EngineConfig(**kw), s["ev"],
                                       s["weights"])
    for f in ("idx", "weights", "payloads", "scales", "workers", "clients"):
        a, b = getattr(sched, f), getattr(sched_r, f)
        assert (a is None) == (b is None), f
        if a is not None:
            np.testing.assert_array_equal(a, b, err_msg=f)
            assert a.dtype == b.dtype, f
    assert (sched.n_batches, sched.n_packets) == (sched_r.n_batches,
                                                  sched_r.n_packets)
    assert dataclasses.asdict(stats) == dataclasses.asdict(stats_r)
    np.testing.assert_array_equal(up, up_r)
    np.testing.assert_array_equal(ec.approx_lost_updates(sched, 2),
                                  ref_ec.approx_lost_updates(sched_r, 2))


def test_empty_schedule_and_empty_round():
    kw = dict(n_workers=3, ring_capacity=5)
    a = ec.build_drain_schedule(np.zeros(0, np.int32), np.zeros(0, np.float32),
                                np.zeros((0, W), np.float32), **kw)
    b = ref_ec.build_drain_schedule(np.zeros(0, np.int32),
                                    np.zeros(0, np.float32),
                                    np.zeros((0, W), np.float32), **kw)
    for f in ("idx", "weights", "payloads", "workers"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    s = _streams(18, "f32")
    events = [(p, x) for p, x in s["ev"] if p.kind is not Kind.DATA]
    for compile_ in (False, True):
        res = port.run_engine_round(
            port.EngineConfig(n_clients=K, n_params=P, payload=W,
                              compile=compile_),
            s["flats"], s["prev"], events, device="cpu")
        np.testing.assert_array_equal(res.new_global.numpy(), s["prev"])
        assert res.stats.batches_drained == 0


@pytest.mark.parametrize("mode", ["exact", "approx"])
def test_per_packet_api_matches_reference(mode):
    """ServerEngine.rx + finalize_and_distribute, both compile settings,
    against the reference engine driven the same way."""
    s = _streams(19, "q8")
    for compile_ in (False, True):
        kw = dict(n_clients=K, n_params=P, payload=W, ring_capacity=7,
                  mode=mode, compile=compile_)
        e_ref = ref.ServerEngine(ref.EngineConfig(**kw), weights=s["weights"])
        e = port.ServerEngine(port.EngineConfig(**kw), weights=s["weights"],
                              device="cpu")
        for (p, x), (p2, x2) in zip(s["ev_ref"], s["ev"]):
            r_ref = e_ref.rx(p, x)
            r = e.rx(p2, x2)
            assert [(q.kind.name, q.client) for q in r] == \
                [(q.kind.name, q.client) for q in r_ref]
        g_ref, c_ref, f_ref = e_ref.finalize_and_distribute(
            s["prev"], s["flats"], s["down"], mix_alpha=0.25)
        g, c, f = e.finalize_and_distribute(s["prev"], s["flats"], s["down"],
                                            mix_alpha=0.25)
        np.testing.assert_array_equal(g.numpy(), np.asarray(g_ref))
        np.testing.assert_array_equal(c.numpy(), np.asarray(c_ref))
        np.testing.assert_allclose(f.numpy(), np.asarray(f_ref), rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_array_equal(e.up_mask().numpy(),
                                      np.asarray(e_ref.up_mask()))
        assert dataclasses.asdict(e.stats) == dataclasses.asdict(e_ref.stats)


def test_sequential_oracle_engine_matches_reference():
    s = _streams(20, "f32")
    got, want = _both(s, use_kernel=False, mode="approx")
    _assert_round(got, want)


def test_compiled_rounds_chain_matches_reference():
    rounds, rounds_ref = [], []
    for r in range(3):
        s = _streams(30 + r, "f32", loss=0.15, dup=0.2)
        rounds.append((s["ev"], s["flats"], s["down"]))
        rounds_ref.append((s["ev_ref"], s["flats"], s["down"]))
    kw = dict(n_clients=K, n_params=P, payload=W, ring_capacity=7,
              compile=True)
    want = ref_ec.run_compiled_rounds(ref.EngineConfig(**kw), rounds_ref,
                                      s["prev"], weights=s["weights"])
    got = ec.run_compiled_rounds(port.EngineConfig(**kw), rounds, s["prev"],
                                 weights=s["weights"], device="cpu")
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        _assert_round(g, w)


def test_compiled_rounds_quorum_error_carries_completed_rounds():
    kw = dict(n_clients=K, n_params=P, payload=W, compile=True,
              round_deadline=30, min_clients=K)
    s = _streams(40, "f32", loss=0.0, dup=0.0)
    ok = [(p, x) for p, x in s["ev"] if p.kind is not Kind.DATA]
    short = s["ev"][:10]
    with pytest.raises(port.QuorumError) as e:
        ec.run_compiled_rounds(port.EngineConfig(**kw),
                               [(ok, None, None), (short, None, None)],
                               s["prev"], device="cpu")
    assert len(e.value.results) == 1


@pytest.mark.parametrize("field,value", [
    ("shards", 2), ("hosts", 2),
    ("buffer_size", 4), ("scan_body", "jnp"), ("scan_body", "pallas"),
    ("ring_capacity", 4096)])
def test_unported_configs_raise(field, value):
    with pytest.raises(NotImplementedError, match="not yet ported"):
        port.EngineConfig(n_clients=K, n_params=P, payload=W, compile=True,
                          **{field: value})


@pytest.mark.parametrize("agg_mode", ["trimmed_mean", "median", "norm_clip"])
@pytest.mark.parametrize("compile_", [False, True],
                         ids=["eager", "compiled"])
def test_robust_agg_modes_are_ported(agg_mode, compile_):
    cfg = port.EngineConfig(n_clients=K, n_params=P, payload=W,
                            compile=compile_, agg_mode=agg_mode)
    assert cfg.agg_mode == agg_mode


@pytest.mark.parametrize("kw", [
    {"shards": 0}, {"round_deadline": -1}, {"min_clients": K + 1},
    {"hosts": 0}, {"staleness_mode": "exp"}, {"norm_clip": 0.0},
    {"agg_mode": "mode"}, {"trim_beta": 0.5}, {"clip_tau": 0.0},
    {"buffer_size": 0}])
def test_invalid_configs_raise_value_error_like_reference(kw):
    with pytest.raises(ValueError):
        ref.EngineConfig(n_clients=K, n_params=P, payload=W, compile=True,
                         **kw)
    with pytest.raises(ValueError):
        port.EngineConfig(n_clients=K, n_params=P, payload=W, compile=True,
                          **kw)


def test_config_fields_match_reference():
    names = lambda cls: [(f.name, f.default) for f in dataclasses.fields(cls)]
    assert names(port.EngineConfig) == names(ref.EngineConfig)


def test_entry_points_default_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = port.EngineConfig(n_clients=K, n_params=P, payload=W)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port_device.resolve_device(None)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port.ServerEngine(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port.run_engine_round(cfg, np.zeros((K, P), np.float32),
                              np.zeros(P, np.float32), [])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ec.run_compiled_rounds(dataclasses.replace(cfg, compile=True), [],
                               np.zeros(P, np.float32))
    assert port_device.resolve_device("cpu") == torch.device("cpu")


def test_oracle_refuses_a_device_other_than_cpu():
    cfg = port.EngineConfig(n_clients=K, n_params=P, payload=W,
                            use_kernel=False)
    with pytest.raises(ValueError, match="CPU only"):
        port.ServerEngine(cfg, device="meta")
    sched = ec.build_drain_schedule(np.zeros(0, np.int32),
                                    np.zeros(0, np.float32),
                                    np.zeros((0, W), np.float32),
                                    n_workers=5, ring_capacity=64)
    z = torch.zeros((N, W), device="meta")
    with pytest.raises(ValueError, match="CPU only"):
        ec.dispatch_round(cfg, sched, z, torch.zeros(N, device="meta"),
                          np.zeros(P, np.float32))


def test_tensor_inputs_and_stream_packets():
    s = _streams(50, "f32")
    cfg = port.EngineConfig(n_clients=K, n_params=P, payload=W)
    a = port.run_engine_round(cfg, s["flats"], s["prev"], s["ev"],
                              down_mask=s["down"], weights=s["weights"],
                              device="cpu")
    b = port.run_engine_round(cfg, torch.from_numpy(s["flats"]),
                              torch.from_numpy(s["prev"]), s["ev"],
                              down_mask=torch.from_numpy(s["down"]),
                              weights=torch.from_numpy(s["weights"]),
                              device="cpu")
    for name in ("new_global", "counts", "new_client_flats"):
        assert torch.equal(getattr(a, name), getattr(b, name))
    ev_ref = s["ev_ref"]
    assert [(p.kind.name, p.client, p.index, p.wire_dtype, p.scale)
            for p, _ in s["ev"]] == \
        [(p.kind.name, p.client, p.index, p.wire_dtype, p.scale)
         for p, _ in ev_ref]
    assert isinstance(s["ev"][K][0], Packet)
