"""The paper's federated-learning model (§5.1, footnote 1):

Conv(32,3)->ReLU->Conv(64,3)->ReLU->MaxPool(2)->Conv(128,3)->ReLU->Conv(256,3)
->ReLU->MaxPool(2)->FC(256)->Dropout(0.5)->FC(10)->Softmax: 4,585,546 f32
parameters on CIFAR-10-shaped inputs (32x32x3, 10 classes).

Torch port of ``repro.models.cnn``: functions over a parameter dict in
the reference's layout, so that the flat vector the server aggregates,
and so every packet, carries the same numbers in both packages.  Images
are NHWC, conv weights HWIO ``(k, k, cin, cout)``, and ``fc0`` consumes
an NHWC flatten, so its rows are ordered (h, w, c).  The forward pass
views each conv weight as OIHW (``permute(3, 2, 0, 1)``) for
``F.conv2d`` and the NHWC images as NCHW; that view is channels-last in
memory, and the activation goes back to NHWC before the flatten.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs.paper_cnn import CNNConfig

Params = Dict[str, Dict[str, torch.Tensor]]


def init_cnn(generator: torch.Generator, cfg: CNNConfig) -> Params:
    """He-normal weights and zero biases on the generator's device, in
    the reference's shapes.  The reference draws with ``jax.random``, so
    the values differ; ``params_from_reference`` carries its draw over."""
    dev = generator.device

    def normal(shape, fan_in):
        return (torch.randn(shape, generator=generator, device=dev)
                * (2.0 / fan_in) ** 0.5)

    params = {}
    cin, k = cfg.in_channels, cfg.kernel_size
    for i, cout in enumerate(cfg.conv_channels):
        params[f"conv{i}"] = {
            "w": normal((k, k, cin, cout), k * k * cin),
            "b": torch.zeros((cout,), device=dev),
        }
        cin = cout
    # two 2x max-pools with 'same' convs: spatial = image_size / 4
    spatial = cfg.image_size // 4
    flat = spatial * spatial * cfg.conv_channels[-1]
    params["fc0"] = {"w": normal((flat, cfg.fc_hidden), flat),
                     "b": torch.zeros((cfg.fc_hidden,), device=dev)}
    params["fc1"] = {"w": normal((cfg.fc_hidden, cfg.num_classes),
                                 cfg.fc_hidden),
                     "b": torch.zeros((cfg.num_classes,), device=dev)}
    return params


def params_from_reference(params_np, device=None) -> Params:
    """The JAX package's parameter dict (numpy or JAX arrays; layout
    unchanged) as f32 tensors on ``device`` (default CPU)."""
    return {layer: {name: torch.tensor(np.asarray(a, np.float32),
                                       device=device)
                    for name, a in leaves.items()}
            for layer, leaves in params_np.items()}


def cnn_forward(params: Params, images: torch.Tensor, cfg: CNNConfig, *,
                dropout_rng: Optional[torch.Generator] = None,
                keep_mask: Optional[torch.Tensor] = None,
                train: bool = False) -> torch.Tensor:
    """images (B, H, W, C) -> logits (B, num_classes).

    Dropout runs in training with a draw from ``dropout_rng`` (on the
    images' device), or with ``keep_mask`` (B, fc_hidden), the draw
    itself, so that a test can give both packages the same one.
    """
    x = images.permute(0, 3, 1, 2)                    # NCHW view
    for i in range(len(cfg.conv_channels)):
        p = params[f"conv{i}"]
        x = F.relu(F.conv2d(x, p["w"].permute(3, 2, 0, 1), p["b"],
                            padding="same"))
        if i in (1, 3):
            x = F.max_pool2d(x, 2)
    x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)  # NHWC flatten
    x = F.relu(x @ params["fc0"]["w"] + params["fc0"]["b"])
    if train and cfg.dropout > 0 and (dropout_rng is not None
                                      or keep_mask is not None):
        if keep_mask is None:
            u = torch.rand(x.shape, generator=dropout_rng, device=x.device)
            keep_mask = u < 1.0 - cfg.dropout
        x = torch.where(keep_mask, x / (1.0 - cfg.dropout), 0.0)
    return x @ params["fc1"]["w"] + params["fc1"]["b"]


def cnn_loss(params: Params, batch: Dict[str, torch.Tensor], cfg: CNNConfig,
             dropout_rng: Optional[torch.Generator] = None,
             train: bool = True, *,
             keep_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean softmax cross-entropy of the batch's labels."""
    logits = cnn_forward(params, batch["images"], cfg,
                         dropout_rng=dropout_rng, keep_mask=keep_mask,
                         train=train)
    lse = torch.logsumexp(logits, dim=-1)
    ll = logits.gather(-1, batch["labels"].long()[:, None])[:, 0]
    return (lse - ll).mean()


def cnn_accuracy(params: Params, batch: Dict[str, torch.Tensor],
                 cfg: CNNConfig) -> torch.Tensor:
    logits = cnn_forward(params, batch["images"], cfg, train=False)
    return (logits.argmax(dim=-1) == batch["labels"]).to(
        torch.float32).mean()
