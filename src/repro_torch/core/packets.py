"""Wire format of the paper's lightweight UDP protocol (§4.1, Fig. 5).

Each UDP payload is a 4-byte packet index followed by 1468 B of float32
parameters — 367 weights per packet (MTU 1500 = 20 B IP + 8 B UDP + 4 B
index + 1468 B payload).

The compressed uplink (DESIGN.md §9) replaces the f32 weight block with
int8 weights plus ONE per-packet symmetric scale in the header: 4 B
index + 4 B f32 scale + up to 1464 int8 weights.  ``QuantClientState``
carries the client-side error-feedback residual, so the quantization
error of round *t* is added back into the upload of round *t+1*.

Torch port of ``repro.core.packets``: the same constants and the same
f32 arithmetic, so one input gives the same bits in both packages
(``torch.round`` and ``jnp.round`` both round half to even).
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

MTU = 1500
IP_HEADER = 20
UDP_HEADER = 8
INDEX_BYTES = 4
PAYLOAD_BYTES = MTU - IP_HEADER - UDP_HEADER - INDEX_BYTES   # 1468
PAYLOAD_F32 = PAYLOAD_BYTES // 4                             # 367
SCALE_BYTES = 4                     # per-packet f32 symmetric scale (q8)
PAYLOAD_Q8 = PAYLOAD_BYTES - SCALE_BYTES                     # 1464
VERSION_BYTES = 4                   # async global-version tag (DESIGN.md §10)
ETH_OVERHEAD = 14 + 4 + 8 + 12      # eth hdr + FCS + preamble + IFG
WIRE_PACKET_BYTES = MTU + ETH_OVERHEAD
Q8_LEVELS = 127                     # symmetric int8: [-127, 127]
_INV_LEVELS = torch.tensor(1.0 / Q8_LEVELS, dtype=torch.float32)


@dataclasses.dataclass(frozen=True)
class PacketizedShape:
    """Static description of a packetized flat parameter vector."""
    n_params: int
    payload: int

    @property
    def n_packets(self) -> int:
        return -(-self.n_params // self.payload)

    @property
    def padded(self) -> int:
        return self.n_packets * self.payload


def packetize(flat: torch.Tensor, payload: int = PAYLOAD_F32) -> torch.Tensor:
    """(..., P) -> (..., n_packets, payload), zero-padded tail."""
    shape = PacketizedShape(flat.shape[-1], payload)
    out = torch.nn.functional.pad(flat, (0, shape.padded - shape.n_params))
    return out.reshape(*flat.shape[:-1], shape.n_packets, payload)


def depacketize(packets: torch.Tensor, n_params: int) -> torch.Tensor:
    """(..., n_packets, payload) -> (..., P)."""
    return packets.reshape(*packets.shape[:-2], -1)[..., :n_params]


# ---------------------------------------------------------------------------
# Compressed (int8) wire path — DESIGN.md §9
# ---------------------------------------------------------------------------

def _quantize(packets: torch.Tensor, scale: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    q = torch.clamp(torch.round(packets / scale[..., None]),
                    -Q8_LEVELS, Q8_LEVELS).to(torch.int8)
    return q, scale


def quantize_payload(packets: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(..., W) f32 -> int8 weights + per-packet symmetric scale (...,).

    ``scale = max(|x|, eps) / 127`` so the full int8 range covers the
    packet; the scale travels in the packet header.
    """
    absmax = packets.abs().amax(dim=-1)
    # a tensor divisor on the packets' device: PyTorch turns a division
    # of a CUDA tensor by a host scalar into a multiplication by its
    # reciprocal, which rounds otherwise than the CPU's division
    levels = torch.tensor(float(Q8_LEVELS), device=packets.device)
    return _quantize(packets, torch.clamp_min(absmax, 1e-12) / levels)


def dequantize_payload(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """int8 weights (..., W) + scales (...,) -> f32 (..., W)."""
    return q.to(torch.float32) * scale[..., None]


def packetize_q8(flat: torch.Tensor, payload: int = PAYLOAD_Q8
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(..., P) f32 -> ((..., n_packets, payload) int8, (..., n_packets)
    f32 scales)."""
    return quantize_payload(packetize(flat, payload))


def depacketize_q8(q: torch.Tensor, scales: torch.Tensor,
                   n_params: int) -> torch.Tensor:
    """Int8 packets + scales -> (..., P) f32 (the wire-decoded vector)."""
    return depacketize(dequantize_payload(q, scales), n_params)


def quantize_with_feedback(flat: torch.Tensor, residual: torch.Tensor,
                           payload: int = PAYLOAD_Q8):
    """Error-feedback encode: quantize ``flat + residual``, carry back
    the quantization error.

    Returns ``(q, scales, new_residual)``; ``new_residual`` is the part
    of the compensated vector the int8 encoding could not express, added
    to the next round's upload (EF-SGD).  Works on one client's (P,)
    vector or on a (K, P) batch alike.
    """
    target = flat + residual
    pk = packetize(target, payload)
    # The reference runs this function under jax.jit, and XLA's CPU
    # compiler changes two roundings; the port makes the same two, so
    # both packages give the same bits.  (1) The division by the
    # constant 127 becomes a multiplication by its f32 reciprocal.
    absmax = pk.abs().amax(dim=-1)
    q, scales = _quantize(pk, torch.clamp_min(absmax, 1e-12) * _INV_LEVELS)
    # (2) ``target - q * scale`` becomes one fused multiply-add, rounded
    # once.  In f64 the product and the difference are exact (at most 32
    # significant bits), so one rounding to f32 gives the same value.
    decoded = depacketize(q.to(torch.float64)
                          * scales.to(torch.float64)[..., None],
                          flat.shape[-1])
    return q, scales, (target.to(torch.float64) - decoded).to(torch.float32)


def quantize_batch_with_feedback(flats: torch.Tensor,
                                 residuals: torch.Tensor,
                                 payload: int = PAYLOAD_Q8):
    """``quantize_with_feedback`` over a (K, P) client batch."""
    return quantize_with_feedback(flats, residuals, payload)


@dataclasses.dataclass(frozen=True)
class QuantClientState:
    """One client's persistent error-feedback residual (DESIGN.md §9)."""
    residual: torch.Tensor           # (P,) f32, zero-initialized
    payload: int = PAYLOAD_Q8

    @classmethod
    def init(cls, n_params: int, payload: int = PAYLOAD_Q8,
             device=None) -> "QuantClientState":
        return cls(residual=torch.zeros((n_params,), dtype=torch.float32,
                                        device=device),
                   payload=payload)

    def encode(self, flat: torch.Tensor):
        """-> (q int8 packets, f32 scales, next round's state)."""
        q, scales, new_residual = quantize_with_feedback(
            flat, self.residual, self.payload)
        return q, scales, dataclasses.replace(self, residual=new_residual)


# ---------------------------------------------------------------------------
# Parameter trees <-> the flat f32 vector the server aggregates
# ---------------------------------------------------------------------------

def _leaves(params):
    """Leaves in JAX's pytree order: dict keys sorted, sequences in order."""
    if isinstance(params, dict):
        for k in sorted(params):
            yield from _leaves(params[k])
    elif isinstance(params, (list, tuple)):
        for p in params:
            yield from _leaves(p)
    else:
        yield params


def _f32_leaf(leaf) -> torch.Tensor:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to(torch.float32).reshape(-1)
    return torch.tensor(np.asarray(leaf, np.float32)).reshape(-1)


def flatten_params(params) -> torch.Tensor:
    """Nested dict of arrays or tensors -> one (P,) f32 tensor (on the
    leaves' device; numpy leaves give a CPU tensor).

    The same vector ``repro.core.packets.flatten_pytree`` gives for the
    same dict: JAX flattens dicts in sorted-key order (``conv0`` ...
    ``fc1``; ``b`` before ``w``).
    """
    return torch.cat([_f32_leaf(leaf) for leaf in _leaves(params)])


def unflatten_params(flat: torch.Tensor, like):
    """Inverse of ``flatten_params``: a tree shaped like ``like`` whose
    leaves are f32 tensors cut from ``flat`` in the same order."""
    off = 0

    def build(node):
        nonlocal off
        if isinstance(node, dict):
            return {k: build(node[k]) for k in sorted(node)}
        if isinstance(node, (list, tuple)):
            return type(node)(build(p) for p in node)
        shape = np.shape(node)
        n = int(np.prod(shape))
        leaf = flat[off:off + n].reshape(shape)
        off += n
        return leaf

    return build(like)


def state_from_reference(prev_global, client_flats, weights, device
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The reference round's host state (numpy arrays: prev_global (P,),
    client_flats (K, P), weights (K,)) as f32 tensors on ``device``."""
    return tuple(torch.tensor(np.asarray(a, np.float32), device=device)
                 for a in (prev_global, client_flats, weights))


# ---------------------------------------------------------------------------
# Loss / arrival models
# ---------------------------------------------------------------------------

def loss_mask(generator: torch.Generator, n_clients: int, n_packets: int,
              loss_rate: float) -> torch.Tensor:
    """(K, N) f32 mask on the generator's device: 1 where the packet
    arrived (independent Bernoulli loss).  The reference draws with
    ``jax.random``, so the two packages draw different masks from one
    seed; parity tests pass the mask in."""
    dev = generator.device
    if loss_rate <= 0.0:
        return torch.ones((n_clients, n_packets), dtype=torch.float32,
                          device=dev)
    u = torch.rand((n_clients, n_packets), generator=generator, device=dev)
    return (u < 1.0 - loss_rate).to(torch.float32)


def straggler_mask(generator: torch.Generator, n_clients: int,
                   dropout_rate: float) -> torch.Tensor:
    """(K,) f32 on the generator's device: 0 for clients that miss the
    round deadline entirely."""
    dev = generator.device
    if dropout_rate <= 0.0:
        return torch.ones((n_clients,), dtype=torch.float32, device=dev)
    u = torch.rand((n_clients,), generator=generator, device=dev)
    return (u < 1.0 - dropout_rate).to(torch.float32)


# ---------------------------------------------------------------------------
# Wire-byte accounting
# ---------------------------------------------------------------------------

def payload_wire_bytes(payload: int, wire_dtype: str = "f32",
                       versioned: bool = False) -> int:
    """UDP payload bytes carrying ``payload`` weights at ``wire_dtype``.

    f32: 4 B per weight.  q8: 1 B per weight plus the 4 B scale header.
    ``versioned`` adds the 4 B global-version tag of the async buffered
    mode (DESIGN.md §10).
    """
    if wire_dtype == "f32":
        base = 4 * payload
    elif wire_dtype == "q8":
        base = payload + SCALE_BYTES
    else:
        raise ValueError(f"unknown wire_dtype {wire_dtype!r}")
    return base + (VERSION_BYTES if versioned else 0)


def packet_wire_bytes(payload: int, wire_dtype: str = "f32",
                      versioned: bool = False) -> int:
    """Bytes ONE packet occupies on the wire, all framing included."""
    return (ETH_OVERHEAD + IP_HEADER + UDP_HEADER + INDEX_BYTES
            + payload_wire_bytes(payload, wire_dtype, versioned))


def packet_bytes_on_wire(n_params: int, payload: int = PAYLOAD_F32,
                         wire_dtype: str = "f32",
                         versioned: bool = False) -> int:
    """Total bytes on the 25GbE wire for one client's parameter upload."""
    n_pkts = PacketizedShape(n_params, payload).n_packets
    return n_pkts * packet_wire_bytes(payload, wire_dtype, versioned)
