"""Count-normalized masked FedAvg aggregation: the paper's server compute.

The server averages local parameters element-wise; packets lost on the
wire are *excluded from the divisor* rather than retransmitted (§3.2.2:
"Local parameters that are missing due to packet loss are not included in
the divisor"), and clients fall back to their local value for elements
they never received back.

Three aggregation modes mirror the paper's design space:

- ``exact``  : masked sum + per-packet contribution count, divide by count
               (the paper's server *with* exclusive access control).
- ``approx`` : the synchronization-free variant, modelled as binomial
               thinning of contributions (each element-wise add is lost
               with probability ``conflict_rate``) while the divisor
               still counts every *received* packet: the bias of a lost
               update.
- ``int8``   : per-packet absmax int8 payloads (beyond paper).

Torch port of ``repro.core.aggregation``.  ``aggregate_flat`` and
``fused_round_step`` keep the reference's ``backend=`` argument with the
port's two values: ``"plain"`` is the reference's ``"jnp"`` dataflow in
tensor ops (an einsum), and ``"kernel"`` is its ``"pallas"``: exact and
int8 go through the hand-written kernels (``kernels/ops.py``), which on
CPU tensors run their plain versions.  The port's default is
``"kernel"``, where the reference's is ``"jnp"``: on the TPU the
reference's einsum is XLA's own fused code, while on the card an einsum
would be a library kernel, and the training loop's aggregation is what
the hand-written kernels are for.  Approx stays tensor ops in both
backends, as in the reference: its thinning is a per-element draw.

The conflict thinning draws from a ``torch.Generator`` on the tensors'
device, or takes the draw itself (``survive``), so that a test can give
both packages the same one.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.core.packets import depacketize, packetize, quantize_payload
from repro_torch.kernels import ops as _ops
from repro_torch.kernels.fedavg_accum import finalize_mean

BACKENDS = ("plain", "kernel")


def _weights(weights, n_clients: int, device) -> torch.Tensor:
    if weights is None:
        return torch.ones((n_clients,), dtype=torch.float32, device=device)
    return weights.to(torch.float32)


def masked_aggregate(packets: torch.Tensor, mask: torch.Tensor,
                     weights: Optional[torch.Tensor] = None,
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact count-normalized aggregation.

    packets (K, N, W) per-client packetized parameters; mask (K, N) 1
    where client k's packet n arrived; weights (K,) optional FedAvg n_k
    weights (default 1).  -> (global_packets (N, W), counts (N,)), counts
    the per-packet sum of arrived weights; packets with count 0 return 0
    and are left to the caller's fallback.
    """
    wmask = mask * _weights(weights, packets.shape[0], packets.device)[:, None]
    total = torch.einsum("knw,kn->nw", packets.to(torch.float32), wmask)
    counts = wmask.sum(dim=0)
    return finalize_mean(total, counts), counts


def approx_aggregate(packets: torch.Tensor, mask: torch.Tensor,
                     conflict_rng: Optional[torch.Generator] = None,
                     conflict_rate: float = 0.0,
                     weights: Optional[torch.Tensor] = None, *,
                     survive: Optional[torch.Tensor] = None,
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Approximated (lock-free) aggregation with the lost-update model.

    Each element-wise addition is independently lost with probability
    ``conflict_rate`` (a Bernoulli draw over (K, N, W) from
    ``conflict_rng``, which must live on the packets' device), but the
    divisor still counts every *received* packet.  ``survive`` (K, N, W)
    is the draw itself (1 = the add survives) and takes the generator's
    place.  No draw reproduces the exact result.
    """
    wmask = mask * _weights(weights, packets.shape[0], packets.device)[:, None]
    counts = wmask.sum(dim=0)                   # divisor: all received
    add_mask = wmask[:, :, None]
    if survive is None and conflict_rate > 0.0 and conflict_rng is not None:
        u = torch.rand(packets.shape, generator=conflict_rng,
                       device=packets.device)
        survive = u < 1.0 - conflict_rate
    if survive is not None:
        add_mask = add_mask * survive.to(torch.float32)
    total = (packets.to(torch.float32) * add_mask).sum(dim=0)
    return finalize_mean(total, counts), counts


def client_update_with_fallback(local_packets: torch.Tensor,
                                global_packets: torch.Tensor,
                                down_mask: torch.Tensor) -> torch.Tensor:
    """Client-side rule (§3.1): elements of the global parameters lost on
    the downlink are left at the client's local value.

    local/global (..., N, W); down_mask (..., N): 1 where the global
    packet arrived at this client.
    """
    return torch.where(down_mask[..., None] > 0, global_packets,
                       local_packets)


# ---------------------------------------------------------------------------
# Quantized aggregation (beyond paper): int8 per-packet scaling
# ---------------------------------------------------------------------------

def quantize_packets(packets: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(K, N, W) f32 -> (int8 payloads, per-packet scales (K, N)).

    ``packets.quantize_payload``: the one definition of the symmetric
    absmax encoding, shared with the wire path.  It divides by 127, as
    the reference's eager ops do (under ``jax.jit`` XLA may multiply by
    the reciprocal instead: ROADMAP.md, faults).
    """
    return quantize_payload(packets)


def dequantize_aggregate(q: torch.Tensor, scale: torch.Tensor,
                         mask: torch.Tensor,
                         weights: Optional[torch.Tensor] = None,
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dequantizing count-normalized aggregation (int8 wire format)."""
    deq = q.to(torch.float32) * scale[..., None]
    return masked_aggregate(deq, mask, weights)


# ---------------------------------------------------------------------------
# Whole-round helpers on flat parameter vectors
# ---------------------------------------------------------------------------

def aggregate_flat(client_flats: torch.Tensor, up_mask: torch.Tensor,
                   payload: int, mode: str = "exact",
                   conflict_rng: Optional[torch.Generator] = None,
                   conflict_rate: float = 0.0,
                   weights: Optional[torch.Tensor] = None,
                   backend: str = "kernel", *,
                   survive: Optional[torch.Tensor] = None,
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """client_flats (K, P) -> (global packets (N, W), counts (N,)).

    up_mask (K, N) is the uplink arrival mask over packets.
    ``backend="kernel"`` (the default) runs exact and int8 through the
    hand-written kernels; ``"plain"`` through an einsum.  Approx is tensor
    ops in both (see the module docstring).
    """
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got "
                         f"{backend!r}")
    pk = packetize(client_flats, payload)                 # (K, N, W)
    weights = _weights(weights, client_flats.shape[0], client_flats.device)
    if mode == "exact":
        if backend == "kernel":
            return _ops.fedavg_accum(pk, up_mask * weights[:, None])
        return masked_aggregate(pk, up_mask, weights)
    if mode == "approx":
        return approx_aggregate(pk, up_mask, conflict_rng, conflict_rate,
                                weights, survive=survive)
    if mode == "int8":
        q, s = quantize_packets(pk)
        if backend == "kernel":
            return _ops.quantized_accum(q, s, up_mask * weights[:, None])
        return dequantize_aggregate(q, s, up_mask, weights)
    raise ValueError(mode)


def expand_packet_mask(mask: torch.Tensor, payload: int,
                       n_params: int) -> torch.Tensor:
    """(..., N) per-packet mask -> (..., P) per-element mask (tail dropped)."""
    return torch.repeat_interleave(mask, payload, dim=-1)[..., :n_params]


def fused_round_step(client_flats: torch.Tensor, up_mask: torch.Tensor,
                     down_mask: torch.Tensor, prev_global: torch.Tensor,
                     payload: int, mode: str = "exact",
                     conflict_rng: Optional[torch.Generator] = None,
                     conflict_rate: float = 0.0,
                     weights: Optional[torch.Tensor] = None,
                     mix_alpha: float = 0.0, backend: str = "kernel", *,
                     survive: Optional[torch.Tensor] = None,
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One full server round on flat (K, P) client state.

    Uplink masking, aggregation, per-packet count-fallback to the
    previous global, downlink client fallback and the optional
    APFL-style blend run over flat tensors: the only (K, N, W) tensor is
    the packetized view of the client flats that the aggregation itself
    consumes; the global is never tiled per client.

    client_flats (K, P); up_mask/down_mask (K, N); prev_global (P,).
    -> (new_client_flats (K, P), new_global (P,), counts (N,)).
    """
    P = client_flats.shape[1]
    gpk, counts = aggregate_flat(client_flats, up_mask, payload, mode=mode,
                                 conflict_rng=conflict_rng,
                                 conflict_rate=conflict_rate,
                                 weights=weights, backend=backend,
                                 survive=survive)
    agg_flat = depacketize(gpk, P)                           # (P,)
    # Per-packet count fallback (§3.2.2): packets nobody delivered keep
    # the previous round's global value.
    have = expand_packet_mask(counts > 0, payload, P)        # (P,) bool
    new_global = torch.where(have, agg_flat, prev_global)
    # Downlink fallback (§3.1): elements of packets lost on the downlink
    # stay at the client's local value.
    down_elem = expand_packet_mask(down_mask, payload, P)    # (K, P)
    new_flats = torch.where(down_elem > 0, new_global[None, :], client_flats)
    if mix_alpha > 0:                                        # APFL-style blend
        new_flats = mix_alpha * client_flats + (1 - mix_alpha) * new_flats
    return new_flats, new_global, counts
