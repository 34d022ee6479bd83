"""XResNet encoder bodies (Bag-of-Tricks ResNets), NCHW.

Counterpart of ``unet_tpu/models/xresnet.py``: the N-channel stem is a
constructor argument and the body returns its skip activations, deepest
first. Two stems: the parity stem (three 3x3 ConvLayers, stride 2 first)
and the tpu_opt folded stem (k4-s4 conv to 128, two 3x3 convs at /4 to
128 and 256 channels, depth-to-space back to 64 channels at /2).
``remat`` recomputes every ResBlock in the backward, as JAX's ``nn.remat``
does.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..parallel import halo
from .layers import ConvLayer, ResBlock, depth_to_space, max_pool_torch, recompute_context

# architecture name -> (expansion, blocks per stage)
ARCHS: Dict[str, Tuple[int, Tuple[int, ...]]] = {
    "xresnet18": (1, (2, 2, 2, 2)),
    "xresnet34": (1, (3, 4, 6, 3)),
    "xresnet50": (4, (3, 4, 6, 3)),
    "xresnet101": (4, (3, 4, 23, 3)),
    "xresnet34_deep": (1, (3, 4, 6, 3, 1, 1)),
}


def stage_widths(n_stages: int) -> List[int]:
    """fastai block_szs: [64, 128, 256, 512] then 256 for deeper stages."""
    base = [64, 128, 256, 512]
    return base[:n_stages] + [256] * max(0, n_stages - 4)


def stage_out_channels(arch: str) -> List[int]:
    """Output channels of every stage of ``arch``."""
    expansion, layers = ARCHS[arch]
    return [w * expansion for w in stage_widths(len(layers))]


def remat_call(remat: bool, block: nn.Module, *args):
    """``block(*args)``, or under ``remat`` (in training, with gradients
    on) through non-reentrant ``torch.utils.checkpoint``: the block's
    activations are dropped after the forward and recomputed in the
    backward (its BatchNorms launch ``bn_sum_sumsq`` again there; see
    ``layers.recompute_context``), inside the space scope of the forward,
    so a spatial recompute exchanges its halos again. The blocks draw no
    random numbers, so no RNG state is kept."""
    if not (remat and torch.is_grad_enabled()):
        return block(*args)
    scope = halo.current()

    def contexts():
        first, again = recompute_context()
        return first, _in_scope(again, scope)

    return checkpoint(block, *args, use_reentrant=False, preserve_rng_state=False,
                      context_fn=contexts)


@contextlib.contextmanager
def _in_scope(ctx, scope):
    with ctx, halo.space_scope(scope):
        yield


class XResNetBody(nn.Module):
    """Stem + maxpool + residual stages. ``forward`` returns ``(features,
    skips)`` with skips deepest first: [stage_{N-2}, ..., stage_0,
    stem_out]."""

    def __init__(self, arch: str = "xresnet34", c_in: int = 3,
                 tpu_opt: bool = False, remat: bool = False):
        super().__init__()
        if arch not in ARCHS:
            raise ValueError(f"Unknown architecture {arch!r}; options: {sorted(ARCHS)}")
        self.tpu_opt = tpu_opt
        self.remat = remat
        expansion, layers = ARCHS[arch]
        if tpu_opt:
            self.stem_0 = ConvLayer(c_in, 128, 4, 4, pad=0)
            self.stem_1 = ConvLayer(128, 128, 3, 1)
            self.stem_2 = ConvLayer(128, 256, 3, 1)
        else:
            self.stem_0 = ConvLayer(c_in, 32, 3, 2)
            self.stem_1 = ConvLayer(32, 32, 3, 1)
            self.stem_2 = ConvLayer(32, 64, 3, 1)
        self.block_names: List[List[str]] = []
        ni = 64
        for s, (n_blocks, width) in enumerate(zip(layers, stage_widths(len(layers)))):
            names = []
            for b in range(n_blocks):
                name = f"stage_{s}_block_{b}"
                stride = (1 if s == 0 else 2) if b == 0 else 1
                self.add_module(name, ResBlock(expansion, ni, width, stride))
                ni = width * expansion
                names.append(name)
            self.block_names.append(names)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        scope = halo.current()
        height = x.shape[2] * (1 if scope is None else scope.size)  # the whole tile's
        if self.tpu_opt and (height % 4 or x.shape[3] % 4):
            raise ValueError(
                f"tpu_opt requires tile height/width divisible by 4, got "
                f"{height}x{x.shape[3]}; pad the tile or set tpu_opt=False")
        x = self.stem_2(self.stem_1(self.stem_0(x)))
        stem_out = depth_to_space(x, 2) if self.tpu_opt else x  # skip at /2
        x = max_pool_torch(stem_out, 3, 2)
        stage_outs = []
        for names in self.block_names:
            for name in names:
                x = remat_call(self.remat and self.training, getattr(self, name), x)
            stage_outs.append(x)
        skips = list(reversed(stage_outs[:-1])) + [stem_out]
        return x, skips
