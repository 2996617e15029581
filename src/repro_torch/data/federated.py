"""Federated partitioner: split a dataset across K clients.

- iid: equal random shards (the paper's setting: 50,000/10 = 5,000 each)
- dirichlet: non-iid label skew with concentration alpha (the paper's
  stated future work)

Torch port of ``repro.data.federated``: the same numpy draws, so one
seed gives the same shards bit for bit.  Data is a dict of tensors with
a leading sample axis; the result has leading (K, n_k) axes.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def _take(data: Dict[str, torch.Tensor], idx: np.ndarray
          ) -> Dict[str, torch.Tensor]:
    ix = torch.from_numpy(idx)
    return {k: v[ix.to(v.device)] for k, v in data.items()}


def partition_iid(data: Dict[str, torch.Tensor], n_clients: int,
                  seed: int = 0) -> Dict[str, torch.Tensor]:
    """Equal random shards -> dict with leading (K, n_k) axes."""
    n = next(iter(data.values())).shape[0]
    per = n // n_clients
    rng = np.random.default_rng(seed)
    perm = rng.permutation(n)[: per * n_clients]
    return _take(data, perm.reshape(n_clients, per))


def partition_dirichlet(data: Dict[str, torch.Tensor], n_clients: int,
                        alpha: float = 0.5, seed: int = 0,
                        label_key: str = "labels"
                        ) -> Dict[str, torch.Tensor]:
    """Label-skewed partition; pads shards to equal length by resampling."""
    labels = data[label_key].cpu().numpy()
    n = labels.shape[0]
    classes = np.unique(labels)
    rng = np.random.default_rng(seed)
    shards = [[] for _ in range(n_clients)]
    for c in classes:
        idx = np.where(labels == c)[0]
        rng.shuffle(idx)
        p = rng.dirichlet(alpha * np.ones(n_clients))
        splits = (np.cumsum(p)[:-1] * len(idx)).astype(int)
        for k, part in enumerate(np.split(idx, splits)):
            shards[k].extend(part.tolist())
    per = n // n_clients
    out = []
    for k in range(n_clients):
        s = np.array(shards[k], dtype=np.int64)
        if len(s) == 0:
            s = rng.integers(0, n, per)
        s = rng.choice(s, per, replace=len(s) < per)
        out.append(s)
    return _take(data, np.stack(out))
