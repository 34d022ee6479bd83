"""Random weights from a seed, made on the device in one draw.

One standard-normal vector covers every parameter and buffer of the
reference model; each leaf takes its slice, scaled by its role:
He-normal convolution kernels (fan in), small biases, BatchNorm scales
near 1 (near 0.25 where a residual branch ends, so that sixteen blocks in
eval mode keep activations of order one), SelfAttention projections over
√fan-in with γ near 0.5 (so the attention adds to its output from the
first step), unit power-iteration vectors, running statistics 0 and 1.
The result is a state dict that the reference and the program both load.
"""

from __future__ import annotations

import math
from typing import Dict

import torch



def make(model: torch.nn.Module, seed: int, device: torch.device) -> Dict[str, torch.Tensor]:
    """The state dict of ``model`` (a reference model, on any device, the
    meta device too; its layers are known by their class names ``Conv``,
    ``ConvT``, ``BatchNorm`` and ``SelfAttention``) filled from ``seed`` on
    ``device``, float32."""
    shapes = {k: v.shape for k, v in model.state_dict().items()}
    total = sum(math.prod(s) for s in shapes.values())
    g = torch.Generator(device=device).manual_seed(int(seed))
    flat = torch.randn(total, generator=g, device=device)
    out, at = {}, 0
    for k, s in shapes.items():
        n = math.prod(s)
        out[k] = flat[at:at + n].view(s)
        at += n
    with torch.no_grad():
        for name, mod in model.named_modules():
            pre = f"{name}." if name else ""
            kind = type(mod).__name__
            if kind in ("Conv", "ConvT"):
                w = out[pre + "weight"]
                fan_in = w.shape[0] if kind == "ConvT" else w[0].numel()
                w.mul_(math.sqrt(2.0 / fan_in))
                if mod.bias is not None:
                    out[pre + "bias"].mul_(0.01)
            elif kind == "BatchNorm":
                base, spread = (0.25, 0.05) if mod.zero else (1.0, 0.1)
                out[pre + "weight"].mul_(spread).add_(base)
                out[pre + "bias"].mul_(0.1)
                out[pre + "running_mean"].zero_()
                out[pre + "running_var"].fill_(1.0)
            elif kind == "SelfAttention":
                for proj in ("query", "key", "value"):
                    k = out[f"{pre}{proj}_kernel"]
                    k.div_(math.sqrt(k.shape[0]))
                    u = out[f"{pre}{proj}_u"]
                    u.div_(u.norm())
                out[pre + "gamma"].mul_(0.1).add_(0.5)
    return out


HEAD_LOGIT_STD = 2.0


@torch.no_grad()
def temper_head(model: torch.nn.Module, state: Dict[str, torch.Tensor],
                x: torch.Tensor) -> None:
    """Scale the head's weight and bias in ``state`` so that the logits of
    ``model`` (a reference model holding ``state``, in the mode it will
    run in) over the batch ``x`` have a standard deviation of
    ``HEAD_LOGIT_STD``: raw 8-bit values reach the last block through its
    skip of the input, and the logits of random weights would otherwise
    run to hundreds and the softmax saturate."""
    factor = HEAD_LOGIT_STD / float(model(x).float().std())
    state["head.weight"].mul_(factor)
    state["head.bias"].mul_(factor)
