"""Wire format, q8 quantization, parameter flattening and the protocol
FSM of the port, held bitwise against the JAX package.

Inputs come from ``np.random.default_rng(seed)`` and pass between the
packages as numpy arrays.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.paper_cnn import CNNConfig as RefCNNConfig
from repro.core import packets as ref
from repro.core import protocol as ref_proto
from repro.models.cnn import init_cnn
from repro_torch.configs.paper_cnn import CONFIG, CNNConfig, n_params
from repro_torch.core import packets as port
from repro_torch.core import protocol as port_proto

P, W = 1000, 64


def _eq(port_t, ref_a):
    np.testing.assert_array_equal(port_t.numpy(), np.asarray(ref_a))


def _flat(seed, p=P):
    return np.random.default_rng(seed).normal(size=p).astype(np.float32)


@pytest.mark.parametrize("p,w", [(1000, 64), (1024, 64), (367 * 3 + 5, 367)])
def test_packetize_depacketize_bitwise(p, w):
    flat = _flat(p, p)
    pk_ref = ref.packetize(jnp.asarray(flat), w)
    pk = port.packetize(torch.from_numpy(flat), w)
    _eq(pk, pk_ref)
    _eq(port.depacketize(pk, p), ref.depacketize(pk_ref, p))
    _eq(port.depacketize(pk, p), flat)
    shape = port.PacketizedShape(p, w)
    assert (shape.n_packets, shape.padded) == (
        ref.PacketizedShape(p, w).n_packets, ref.PacketizedShape(p, w).padded)


def test_quantize_payload_bitwise_incl_half_ties():
    rng = np.random.default_rng(1)
    pk = rng.normal(size=(20, W)).astype(np.float32)
    # a row with absmax 127 has scale exactly 1.0, so its .5 entries are
    # exact ties: both packages must round them half to even
    pk[0] = rng.integers(-126, 127, W) + 0.5
    pk[0, 0] = 127.0
    pk[1] = 0.0                               # all-zero packet: eps scale
    q_ref, s_ref = ref.quantize_payload(jnp.asarray(pk))
    q, s = port.quantize_payload(torch.from_numpy(pk))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    _eq(q, q_ref)
    _eq(s, s_ref)
    _eq(port.dequantize_payload(q, s), ref.dequantize_payload(q_ref, s_ref))


def test_q8_roundtrip_bitwise():
    flat = _flat(2)
    q_ref, s_ref = ref.packetize_q8(jnp.asarray(flat), W)
    q, s = port.packetize_q8(torch.from_numpy(flat), W)
    _eq(q, q_ref)
    _eq(s, s_ref)
    _eq(port.depacketize_q8(q, s, P), ref.depacketize_q8(q_ref, s_ref, P))


def test_error_feedback_bitwise_over_rounds():
    st_ref = ref.QuantClientState.init(P, payload=W)
    st = port.QuantClientState.init(P, payload=W, device="cpu")
    for r in range(3):
        flat = _flat(10 + r)
        q_ref, s_ref, st_ref = st_ref.encode(jnp.asarray(flat))
        q, s, st = st.encode(torch.from_numpy(flat))
        _eq(q, q_ref)
        _eq(s, s_ref)
        _eq(st.residual, st_ref.residual)


def test_batch_error_feedback_bitwise():
    rng = np.random.default_rng(3)
    flats = rng.normal(size=(4, P)).astype(np.float32)
    res = (rng.normal(size=(4, P)) * 1e-3).astype(np.float32)
    want = ref.quantize_batch_with_feedback(jnp.asarray(flats),
                                            jnp.asarray(res), W)
    got = port.quantize_batch_with_feedback(torch.from_numpy(flats),
                                            torch.from_numpy(res), W)
    for g, w in zip(got, want):
        _eq(g, w)


@pytest.mark.parametrize("payload", [367, 1464, 64])
@pytest.mark.parametrize("wire", ["f32", "q8"])
@pytest.mark.parametrize("versioned", [False, True])
def test_wire_bytes_equal(payload, wire, versioned):
    assert port.payload_wire_bytes(payload, wire, versioned) == \
        ref.payload_wire_bytes(payload, wire, versioned)
    assert port.packet_wire_bytes(payload, wire, versioned) == \
        ref.packet_wire_bytes(payload, wire, versioned)
    assert port.packet_bytes_on_wire(4585546, payload, wire, versioned) == \
        ref.packet_bytes_on_wire(4585546, payload, wire, versioned)


def test_wire_constants_and_bad_dtype():
    for name in ("PAYLOAD_BYTES", "PAYLOAD_F32", "PAYLOAD_Q8",
                 "WIRE_PACKET_BYTES", "Q8_LEVELS", "ETH_OVERHEAD"):
        assert getattr(port, name) == getattr(ref, name), name
    with pytest.raises(ValueError):
        port.payload_wire_bytes(10, "bf16")


def _np_tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


def test_flatten_params_matches_flatten_pytree():
    params = _np_tree(init_cnn(jax.random.PRNGKey(0), RefCNNConfig()))
    flat_ref, _ = ref.flatten_pytree(params)
    flat = port.flatten_params(params)
    _eq(flat, flat_ref)
    back = port.unflatten_params(flat, params)
    for k in params:
        for leaf in params[k]:
            np.testing.assert_array_equal(back[k][leaf].numpy(),
                                          params[k][leaf])


@pytest.mark.parametrize("kw", [
    {}, {"conv_channels": (4, 8, 8, 16), "fc_hidden": 32, "image_size": 16},
    {"in_channels": 1, "num_classes": 100, "kernel_size": 5}])
def test_n_params_matches_init_cnn(kw):
    shapes = jax.eval_shape(lambda: init_cnn(jax.random.PRNGKey(0),
                                             RefCNNConfig(**kw)))
    want = sum(int(np.prod(x.shape))
               for x in jax.tree_util.tree_leaves(shapes))
    assert n_params(CNNConfig(**kw)) == want


def test_paper_width():
    assert n_params(CONFIG) == 4_585_546
    assert port.PacketizedShape(4_585_546, port.PAYLOAD_F32).n_packets \
        == 12_495
    assert port.PacketizedShape(4_585_546, port.PAYLOAD_Q8).n_packets \
        == 3_133
    assert dataclasses.asdict(CONFIG) == dataclasses.asdict(RefCNNConfig())


def test_state_from_reference():
    rng = np.random.default_rng(4)
    prev = rng.normal(size=P).astype(np.float32)
    flats = rng.normal(size=(3, P)).astype(np.float32)
    wts = np.array([1, 2, 3], np.float32)
    g, f, w = port.state_from_reference(jnp.asarray(prev), flats, wts, "cpu")
    for t, a in ((g, prev), (f, flats), (w, wts)):
        assert t.dtype == torch.float32 and t.device.type == "cpu"
        np.testing.assert_array_equal(t.numpy(), a)


def _drive_fsm(mod, stream):
    fsm = mod.ServerFSM(3, 4)
    replies, phases = [], []
    for kind, client, index in stream:
        if kind == "DEADLINE":
            replies.append(tuple(fsm.deadline_expired()))
            continue
        pkt = mod.Packet(mod.Kind[kind], client, index)
        replies.append(tuple((r.kind.name, r.client, r.from_server)
                             for r in fsm.on_packet(pkt)))
        phases.append(tuple(fsm.phase[c].name for c in range(3)))
    return replies, phases, [sorted(u) for u in fsm.uplink], \
        fsm.late_data_dropped, fsm.participants()


def test_server_fsm_replies_equal_on_a_lossy_stream():
    rng = np.random.default_rng(5)
    stream = []
    for step in range(200):
        c = int(rng.integers(0, 3))
        kind = str(rng.choice(["START", "DATA", "DATA", "DATA", "END"]))
        if rng.random() < 0.2:                 # lost on the wire
            continue
        stream.append((kind, c, int(rng.integers(0, 4))))
        if step == 150:
            stream.append(("DEADLINE", -1, -1))
    assert _drive_fsm(port_proto, stream) == _drive_fsm(ref_proto, stream)


@pytest.mark.parametrize("deadline", [None, 40])
def test_run_round_outcome_equal(deadline):
    def drop(seed):
        rng = np.random.default_rng(seed)
        return lambda p, step: bool(rng.random() < 0.25)

    def dup(seed):
        rng = np.random.default_rng(seed)
        return lambda p, step: bool(rng.random() < 0.1)

    a = ref_proto.run_round(4, 6, drop(7), max_steps=400,
                            round_deadline=deadline, dup_fn=dup(8))
    b = port_proto.run_round(4, 6, drop(7), max_steps=400,
                             round_deadline=deadline, dup_fn=dup(8))
    assert (a.uplink, a.downlink, a.steps, a.timed_out,
            a.late_data_dropped, a.completed) == \
        (b.uplink, b.downlink, b.steps, b.timed_out, b.late_data_dropped,
         b.completed)
