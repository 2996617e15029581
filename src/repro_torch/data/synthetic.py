"""Synthetic data source for the FedAvg training loop (CIFAR-10 is not
available offline; DESIGN.md §2).

``synthetic_image_classification``: class-conditional Gaussian images,
10 classes, 32x32x3, separable enough that the paper's CNN converges
within tens of FedAvg rounds.

Torch port of the image part of ``repro.data.synthetic``: the same numpy
draws, so one seed gives the same arrays bit for bit; returned as CPU
tensors.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def synthetic_image_classification(rng: np.random.Generator, n: int,
                                   image_size: int = 32, channels: int = 3,
                                   num_classes: int = 10,
                                   noise: float = 0.35,
                                   task_seed: int = 1234
                                   ) -> Dict[str, torch.Tensor]:
    """Class templates + Gaussian noise -> dict(images (n, H, W, C) f32,
    labels (n,) int32), NHWC as in the reference.

    Templates come from ``task_seed`` (not ``rng``) so train and test
    splits drawn from separate rng states share the same classification
    task; only sample noise and labels consume ``rng``.
    """
    templates = np.random.default_rng(task_seed).normal(
        0.0, 1.0, (num_classes, image_size, image_size, channels))
    labels = rng.integers(0, num_classes, n)
    images = templates[labels] + noise * rng.normal(
        0.0, 1.0, (n, image_size, image_size, channels))
    return {
        "images": torch.from_numpy(images.astype(np.float32)),
        "labels": torch.from_numpy(labels.astype(np.int32)),
    }
