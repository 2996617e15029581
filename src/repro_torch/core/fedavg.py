"""FedAvg (Algorithm 1) orchestrator with the paper's server semantics.

The selected clients train one after another on the device (minibatch
SGD, ``torch.autograd.grad`` and ``p -= lr * g``), and the server step
runs through ``aggregation.fused_round_step`` on flat (K, P) client state
with ``backend="kernel"``: exact and int8 aggregation launch the
hand-written kernels (``kernels/fedavg_accum.py``,
``kernels/quantized_accum.py``) once per round on CUDA tensors, and
approx aggregates with tensor ops, as in the reference.  Packet loss is
drawn independently on the uplink and the downlink; the downlink
fallback keeps a client's local value for packets that never arrived
(paper §3.1).  ``mix_alpha`` blends local and global parameters
(APFL-style, paper §2.1.2).

Torch port of ``repro.core.fedavg``.  The reference vmaps the K local
trainings and keeps the selected ones; the port trains only the selected
clients, which gives the same state.  Every draw (selection, shuffles,
dropout, loss masks, conflict thinning) comes from a ``torch.Generator``
seeded from ``cfg.seed``, one stream each.  ``jax.random`` draws other
numbers from the same seed, so a run is held to the reference by its
accuracy, not its bits.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List

import torch
from torch.profiler import record_function

from repro_torch.core import aggregation as agg
from repro_torch.core.device import resolve_device
from repro_torch.core.packets import (PAYLOAD_F32, PacketizedShape,
                                      flatten_params, loss_mask,
                                      unflatten_params)


@dataclasses.dataclass(frozen=True)
class FedAvgConfig:
    n_clients: int = 10
    client_fraction: float = 1.0          # C in Algorithm 1
    rounds: int = 20                      # T
    local_epochs: int = 1                 # E
    batch_size: int = 64                  # B
    lr: float = 0.05                      # eta
    payload: int = PAYLOAD_F32
    agg_mode: str = "exact"               # exact | approx | int8
    conflict_rate: float = 0.0            # lock-free lost-update probability
    uplink_loss: float = 0.0
    downlink_loss: float = 0.0
    weighted: bool = True                 # n_k/n weighting
    mix_alpha: float = 0.0                # 0 = FedAvg replace; >0 = APFL-style
    seed: int = 0


@dataclasses.dataclass
class ModelFns:
    """Model plumbing: functions over a parameter dict of tensors."""
    init: Callable          # generator -> params on the generator's device
    loss: Callable          # (params, batch, generator) -> scalar tensor
    test_metrics: Callable  # (params, test_data) -> dict of scalars


# one generator per random stream, seeded from cfg.seed
STREAMS = ("init", "select", "train", "uplink", "downlink", "conflict")


def _generators(seed: int, device: torch.device
                ) -> Dict[str, torch.Generator]:
    gens = {}
    for i, name in enumerate(STREAMS):
        # the client selection is a tiny draw: on the host
        dev = torch.device("cpu") if name == "select" else device
        gens[name] = torch.Generator(device=dev)
        gens[name].manual_seed(seed * len(STREAMS) + i)
    return gens


def _local_update(model: ModelFns, cfg: FedAvgConfig, like):
    """One client's E local epochs of minibatch SGD (Algorithm 1, lines
    9-13) on its flat (P,) parameter vector; ``like`` is the parameter
    dict whose shapes cut the vector."""

    def update(flat: torch.Tensor, data: Dict[str, torch.Tensor],
               gen: torch.Generator) -> torch.Tensor:
        n = next(iter(data.values())).shape[0]
        n_batches = max(1, n // cfg.batch_size)
        for _ in range(cfg.local_epochs):
            perm = torch.randperm(n, generator=gen, device=gen.device)
            for i in range(n_batches):
                idx = perm[i * cfg.batch_size:(i + 1) * cfg.batch_size]
                batch = {k: v[idx] for k, v in data.items()}
                flat = flat.detach().requires_grad_(True)
                loss = model.loss(unflatten_params(flat, like), batch, gen)
                (g,) = torch.autograd.grad(loss, flat)
                flat = (flat - cfg.lr * g).detach()
        return flat

    return update


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_fedavg(model: ModelFns, client_data: Dict[str, torch.Tensor],
               test_data: Dict[str, torch.Tensor], cfg: FedAvgConfig, *,
               device=None) -> Dict[str, List[float]]:
    """client_data: dict of tensors with leading (K, n_k) axes (e.g.
    ``data.federated.partition_iid``); test_data: dict of (n, ...)
    tensors.  Runs on ``device`` (default CUDA; pass ``"cpu"`` for the
    CPU).

    Returns the history: per round the global model's test metrics,
    ``train_s`` (the selected clients' local training) and ``agg_s``
    (the server step), host seconds up to a device synchronisation, and
    ``peak_mem_bytes``, the round's peak allocated device memory (NaN on
    the CPU).  The local training runs in a ``local_training`` profiler
    span.
    """
    dev = resolve_device(device)
    gens = _generators(cfg.seed, dev)
    like = model.init(gens["init"])
    server_flat = flatten_params(like).to(dev)
    n_params = server_flat.shape[0]
    n_packets = PacketizedShape(n_params, cfg.payload).n_packets
    K = cfg.n_clients
    client_flats = server_flat[None].repeat(K, 1)            # (K, P)
    data = {k: v.to(dev) for k, v in client_data.items()}
    test = {k: v.to(dev) for k, v in test_data.items()}
    n_k = next(iter(data.values())).shape[1]
    weights = (torch.full((K,), float(n_k), device=dev) if cfg.weighted
               else torch.ones((K,), device=dev))
    local_update = _local_update(model, cfg, like)

    history: Dict[str, List[float]] = {"round": [], "test_loss": [],
                                       "test_acc": [], "train_s": [],
                                       "agg_s": [], "peak_mem_bytes": []}
    m = max(int(cfg.client_fraction * K), 1)
    for t in range(cfg.rounds):
        _sync(dev)
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        sel_idx = torch.randperm(K, generator=gens["select"])[:m]
        sel = torch.zeros((K,), device=dev)
        sel[sel_idx.to(dev)] = 1.0
        with record_function("local_training"):
            for k in sorted(sel_idx.tolist()):
                client_flats[k] = local_update(
                    client_flats[k], {key: v[k] for key, v in data.items()},
                    gens["train"])
            _sync(dev)
        t1 = time.perf_counter()
        up = loss_mask(gens["uplink"], K, n_packets, cfg.uplink_loss)
        up = up * sel[:, None]                             # only selected join
        down = loss_mask(gens["downlink"], K, n_packets, cfg.downlink_loss)
        client_flats, server_flat, _ = agg.fused_round_step(
            client_flats, up, down, server_flat, cfg.payload,
            mode=cfg.agg_mode, conflict_rng=gens["conflict"],
            conflict_rate=cfg.conflict_rate, weights=weights * sel,
            mix_alpha=cfg.mix_alpha, backend="kernel")
        _sync(dev)
        t2 = time.perf_counter()
        with torch.no_grad():
            metrics = model.test_metrics(unflatten_params(server_flat, like),
                                         test)
        history["round"].append(t)
        for k, v in metrics.items():
            history.setdefault(k, []).append(float(v))
        history["train_s"].append(t1 - t0)
        history["agg_s"].append(t2 - t1)
        history["peak_mem_bytes"].append(
            float(torch.cuda.max_memory_allocated(dev)) if dev.type == "cuda"
            else float("nan"))
    return history
