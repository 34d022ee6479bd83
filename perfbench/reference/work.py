"""The work of a configuration, counted on the reference model with meta
tensors (no data, no device): forward FLOPs a tile (convolutions and
matrix products; a multiply-add is two) and the input shape of every
BatchNorm in a training forward."""

from __future__ import annotations

from typing import List, Tuple

import torch
from torch.utils.flop_counter import FlopCounterMode

from . import unet


def _meta(config: dict) -> unet.UNet:
    with torch.device("meta"):
        return unet.UNet(config)


def forward_flops(config: dict, tile: int) -> float:
    """FLOPs of one training-mode forward of one tile² tile."""
    model = _meta(config).train()
    counter = FlopCounterMode(display=False)
    with counter:
        model(torch.empty((1, config["bands"], tile, tile), device="meta"))
    return float(counter.get_total_flops())


def bn_sites(config: dict, batch: int, tile: int) -> List[Tuple[int, ...]]:
    """(N, C, H, W) at each BatchNorm of a training forward of a batch."""
    model = _meta(config).train()
    shapes: List[Tuple[int, ...]] = []
    hooks = [m.register_forward_hook(lambda _m, inp, _out: shapes.append(tuple(inp[0].shape)))
             for m in model.modules() if isinstance(m, unet.BatchNorm)]
    try:
        model(torch.empty((batch, config["bands"], tile, tile), device="meta"))
    finally:
        for h in hooks:
            h.remove()
    return shapes
