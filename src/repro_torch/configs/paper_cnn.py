"""The paper's own model: 4-conv + 2-FC CNN for CIFAR-10-shaped inputs.

Conv(32,3) -> ReLU -> Conv(64,3) -> ReLU -> MaxPool(2) ->
Conv(128,3) -> ReLU -> Conv(256,3) -> ReLU -> MaxPool(2) ->
FC(256) -> Dropout(0.5) -> FC(10) -> Softmax

A copy of ``repro.configs.paper_cnn``.  The server only needs the
model's width (``n_params``): the flat f32 vector it aggregates.
"""
import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class CNNConfig:
    name: str = "paper-cnn"
    image_size: int = 32
    in_channels: int = 3
    conv_channels: Tuple[int, ...] = (32, 64, 128, 256)
    kernel_size: int = 3
    fc_hidden: int = 256
    num_classes: int = 10
    dropout: float = 0.5


CONFIG = CNNConfig()


def n_params(cfg: CNNConfig = CONFIG) -> int:
    """Parameter count of ``repro.models.cnn.init_cnn(cfg)``, from the
    shapes alone: 'same' 3x3 convs with bias, two 2x max-pools (so the
    FC input is (image_size / 4)^2 x last conv width), two FC layers
    with bias.  4,585,546 for the paper's config."""
    total, cin = 0, cfg.in_channels
    for cout in cfg.conv_channels:
        total += cfg.kernel_size * cfg.kernel_size * cin * cout + cout
        cin = cout
    spatial = cfg.image_size // 4
    flat = spatial * spatial * cfg.conv_channels[-1]
    total += flat * cfg.fc_hidden + cfg.fc_hidden
    total += cfg.fc_hidden * cfg.num_classes + cfg.num_classes
    return total
