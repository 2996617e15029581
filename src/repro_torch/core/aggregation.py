"""Per-packet masks on flat parameter vectors (torch port of the part of
``repro.core.aggregation`` that the server round uses)."""
from __future__ import annotations

import torch


def expand_packet_mask(mask: torch.Tensor, payload: int,
                       n_params: int) -> torch.Tensor:
    """(..., N) per-packet mask -> (..., P) per-element mask (tail dropped)."""
    return torch.repeat_interleave(mask, payload, dim=-1)[..., :n_params]
