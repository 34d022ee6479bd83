"""Training-mode BatchNorm: per-channel statistics and their gradient.

Counterpart of ``unet_tpu/ops/pallas_bn.py``. Both reductions run over
every (n, h, w) of an NCHW tensor and return a (2, C) float32 tensor:

* ``bn_sum_sumsq(x)`` — (Σx, Σx²), the forward statistics;
* ``bn_bwd_sums(dy, x, mean, inv)`` — (Σdy, Σdy·x̂) with x̂ = (x − mean)·inv
  recomputed inside, the backward's dbias and dscale.

For CUDA tensors each launches the CUDA kernel ``csrc/bn_stats.cu`` (a
deterministic two-stage reduction, bit-stable across launches) or raises;
for CPU tensors each runs its plain PyTorch version
(``bn_sum_sumsq_reference``, ``bn_bwd_sums_reference``).

``BatchNormTrain`` is the ``torch.autograd.Function`` around them. Its
forward follows flax's ``nn.BatchNorm`` (the JAX package's default):
float32 statistics with the fast variance E[x²] − E[x]², clamped at 0, the
normalize ``(x − mean)·(rsqrt(var + eps)·scale) + bias`` in float32 and one
cast to ``x.dtype``. Its backward is the standard BatchNorm gradient,
``dx = scale·inv·(dy − Σdy/n − x̂·Σdy·x̂/n)`` in float32, cast to
``x.dtype``; dscale and dbias stay float32. The elementwise passes are
PyTorch ops, as they are XLA ops outside the TPU kernels.

Under a process group (``group``, the ranks of one data-parallel step)
the forward all-reduces the (2, C) sums and divides by the global count,
so every rank normalizes with the global batch's statistics, as GSPMD
computes them in JAX; the backward all-reduces its (2, C) sums before dx
and returns the rank's own dscale and dbias, which the trainer's gradient
all-reduce then sums once.

``n_stat`` (the ``UNET_TPU_BN=slice[:k]`` variant) takes the statistics
from the first k = min(n_stat, global batch) samples only: the forward
sums run over that prefix of the batch (a contiguous head of an NCHW
tensor) with count k·H·W. Every sample's normalize reads those
statistics, so the backward sums still span the whole batch, and dx =
scale·inv·(dy − Σdy/(k·H·W) − x̂·Σdy·x̂/(k·H·W)) holds for the first k
samples; the others get scale·inv·dy. Under a process group the prefix is
that of the global batch: rank r holds the global samples [r·n, (r+1)·n)
of a microbatch (``parallel.mesh.shard_indices``), so its share of the
prefix is the head of its own n samples, of length clamp(k − r·n, 0, n).

Under spatial partitioning (``space`` = S > 1) the group is the world of
D data indices × S space ranks: rank r holds rows 1/S of the samples of
data index r // S, so the count is k·H·W summed over the S ranks' rows and
the prefix is that of data index r // S.
"""

from __future__ import annotations

import ctypes
from typing import Callable, Dict, Optional, Tuple

import torch
import torch.distributed as dist

THREADS = 256                # threads per block of the stage-1 kernel
BLOCKS_PER_SM = 8            # resident stage-1 blocks the grid aims for on each SM
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def bn_sum_sumsq_reference(x: torch.Tensor) -> torch.Tensor:
    """Plain version of ``bn_sum_sumsq``: (2, C) float32 (Σx, Σx²)."""
    xf = x.float()
    return torch.stack([xf.sum(dim=(0, 2, 3)), (xf * xf).sum(dim=(0, 2, 3))])


def bn_bwd_sums_reference(dy: torch.Tensor, x: torch.Tensor,
                          mean: torch.Tensor, inv: torch.Tensor) -> torch.Tensor:
    """Plain version of ``bn_bwd_sums``: (2, C) float32 (Σdy, Σdy·x̂)."""
    g = dy.float()
    xhat = (x.float() - mean.view(1, -1, 1, 1)) * inv.view(1, -1, 1, 1)
    return torch.stack([g.sum(dim=(0, 2, 3)), (g * xhat).sum(dim=(0, 2, 3))])


def _check(op: str, name: str, t: torch.Tensor, like: torch.Tensor) -> None:
    if not t.is_cuda:
        raise ValueError(f"{op}: {name} is on {t.device}, not CUDA")
    if t.device != like.device:
        raise ValueError(f"{op}: tensors on different devices")
    if not t.is_contiguous():
        raise ValueError(f"{op}: {name} is not contiguous")


def launch_grid(shape: Tuple[int, ...], element_size: int, aligned: bool,
                sms: int) -> Tuple[int, int, int]:
    """(V, S, chunk) for an (N, C, H, W) input on a card with ``sms``
    multiprocessors: values per load (16 bytes when H·W allows and the data
    is 16-byte aligned, else 1), blocks per channel S, and packs of V values
    per block. S grows until the grid holds ~BLOCKS_PER_SM blocks per SM,
    but keeps >= 4 packs per thread."""
    n, c, h, w = shape
    vec = 16 // element_size
    if (h * w) % vec or not aligned:
        vec = 1
    packs = n * (h * w // vec)
    s = max(1, min(-(-sms * BLOCKS_PER_SM // c), -(-packs // (THREADS * 4)), 65535))
    chunk = -(-packs // s)
    return vec, -(-packs // chunk), chunk


def _check_x(op: str, x: torch.Tensor) -> None:
    _check(op, "x", x, x)
    if x.dim() != 4 or x.numel() == 0:
        raise ValueError(f"{op}: need a non-empty (N, C, H, W) tensor, got "
                         f"{tuple(x.shape)}")
    if x.dtype not in _DTYPE_CODES:
        raise ValueError(f"{op}: x is {x.dtype}, not float32 or bfloat16")


_kernels: Dict[str, Callable] = {}
_sms: Dict[int, int] = {}  # CUDA device index -> multiprocessor count


def _sm_count(device: torch.device) -> int:
    if device.index not in _sms:
        _sms[device.index] = torch.cuda.get_device_properties(device).multi_processor_count
    return _sms[device.index]


def _kernel(name: str) -> Callable:
    if not _kernels:
        from . import _build

        lib = _build.load("bn_stats")
        ptr, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fwd, bwd = lib.bn_stats_launch, lib.bn_bwd_launch
        fwd.restype = bwd.restype = ctypes.c_int
        fwd.argtypes = [ptr] * 3 + [i, i, i, ll, i, i, ll, ptr]
        bwd.argtypes = [ptr] * 6 + [i, i, i, ll, i, i, ll, ptr]
        _kernels.update(fwd=fwd, bwd=bwd)
    return _kernels[name]


def _launch(op: str, name: str, operands, *ptrs) -> torch.Tensor:
    """Launch kernel ``name`` over the NCHW ``operands`` (x, or dy and x);
    ``ptrs`` are the launcher's leading pointer arguments."""
    x = operands[-1]
    n, c, h, w = x.shape
    aligned = all(t.data_ptr() % 16 == 0 for t in operands)
    vec, s, chunk = launch_grid(tuple(x.shape), x.element_size(), aligned,
                                _sm_count(x.device))
    partial = torch.empty(2 * c * s, dtype=torch.float32, device=x.device)
    out = torch.empty((2, c), dtype=torch.float32, device=x.device)
    fn = _kernel(name)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(*ptrs, partial.data_ptr(), out.data_ptr(), _DTYPE_CODES[x.dtype],
                 n, c, h * w, vec, s, chunk, stream)
    if err != 0:
        raise RuntimeError(f"{op} launch failed: CUDA error {err}")
    return out


def bn_sum_sumsq(x: torch.Tensor) -> torch.Tensor:
    """Per-channel float32 (Σx, Σx²) of an NCHW float32/bf16 tensor, as a
    (2, C) tensor. CUDA tensors go through the ``bn_stats`` kernel (one
    launch, counted in ``bn_sum_sumsq.launches``); CPU tensors through the
    plain version."""
    if x.device.type == "cpu":
        return bn_sum_sumsq_reference(x)
    _check_x("bn_sum_sumsq", x)
    out = _launch("bn_sum_sumsq", "fwd", (x,), x.data_ptr())
    bn_sum_sumsq.launches += 1
    return out


bn_sum_sumsq.launches = 0


def bn_bwd_sums(dy: torch.Tensor, x: torch.Tensor, mean: torch.Tensor,
                inv: torch.Tensor) -> torch.Tensor:
    """Per-channel float32 (Σdy, Σdy·x̂), x̂ = (x − mean)·inv, as a (2, C)
    tensor; dy and x NCHW of one shape and dtype, mean and inv (C,)
    float32. CUDA tensors go through the ``bn_stats`` kernel (one launch,
    counted in ``bn_bwd_sums.launches``); CPU tensors through the plain
    version."""
    if x.device.type == "cpu":
        return bn_bwd_sums_reference(dy, x, mean, inv)
    op = "bn_bwd_sums"
    _check_x(op, x)
    _check(op, "dy", dy, x)
    if dy.shape != x.shape or dy.dtype != x.dtype:
        raise ValueError(f"{op}: dy {tuple(dy.shape)} {dy.dtype} against x "
                         f"{tuple(x.shape)} {x.dtype}")
    c = x.shape[1]
    for name, t in (("mean", mean), ("inv", inv)):
        _check(op, name, t, x)
        if t.shape != (c,) or t.dtype != torch.float32:
            raise ValueError(f"{op}: {name} must be ({c},) float32, got "
                             f"{tuple(t.shape)} {t.dtype}")
    out = _launch(op, "bwd", (dy, x), dy.data_ptr(), x.data_ptr(),
                  mean.data_ptr(), inv.data_ptr())
    bn_bwd_sums.launches += 1
    return out


bn_bwd_sums.launches = 0

KERNEL_REDUCTIONS = (bn_sum_sumsq, bn_bwd_sums)
PLAIN_REDUCTIONS = (bn_sum_sumsq_reference, bn_bwd_sums_reference)


def slice_rows(n_local: int, n_stat: Optional[int], group,
               space: int = 1) -> Tuple[int, int]:
    """(k, k_local) of a training BatchNorm over ``n_local`` samples a
    rank (rows 1/``space`` of each): k samples of the (global) batch give
    the statistics, the first k_local of them on this rank. Without
    ``n_stat`` every sample does."""
    world = (dist.get_world_size(group) if group is not None else 1) // space
    total = n_local * world
    if n_stat is None:
        return total, n_local
    k = min(max(int(n_stat), 1), total)
    first = (dist.get_rank(group) if group is not None else 0) // space * n_local
    return k, min(max(k - first, 0), n_local)


class BatchNormTrain(torch.autograd.Function):
    """``(y, mean, var) = BatchNormTrain.apply(x, scale, bias, eps,
    reductions, group, n_stat, space)``: training-mode BatchNorm over (N,
    H, W) of an NCHW tensor. ``reductions`` is the pair (forward sums, backward
    sums): ``KERNEL_REDUCTIONS``, or ``PLAIN_REDUCTIONS`` to hold the
    kernels against their plain versions on the card; ``group`` is None,
    or the process group whose ranks hold equal shares of the batch;
    ``n_stat`` is None (statistics of the whole batch) or the k of the
    slice variant; ``space`` is the number of ranks whose rows make up
    each sample (spatial partitioning; ``group`` then spans them); mean
    and var are the float32 batch statistics (biased variance) for the
    running averages and carry no gradient."""

    @staticmethod
    def forward(ctx, x, scale, bias, eps: float, reductions, group=None, n_stat=None,
                space: int = 1):
        k, k_local = slice_rows(x.shape[0], n_stat, group, space)
        n = k * (x.numel() // (x.shape[0] * x.shape[1])) * space
        if k_local:
            sums = reductions[0](x[:k_local])
        else:  # this rank holds no sample of the slice
            sums = torch.zeros((2, x.shape[1]), dtype=torch.float32, device=x.device)
        if group is not None:
            dist.all_reduce(sums, group=group)
        mean = sums[0] / n
        var = torch.clamp(sums[1] / n - mean * mean, min=0.0)
        inv = torch.rsqrt(var + eps)
        shape = (1, -1, 1, 1)
        y = ((x.float() - mean.view(shape)) * (inv * scale).view(shape)
             + bias.view(shape)).to(x.dtype)
        ctx.save_for_backward(x, scale, mean, inv)
        ctx.bwd_sums, ctx.group, ctx.n, ctx.k_local = reductions[1], group, n, k_local
        ctx.mark_non_differentiable(mean, var)
        return y, mean, var

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        x, scale, mean, inv = ctx.saved_tensors
        n, kl = ctx.n, ctx.k_local
        dy = dy.contiguous()
        sums = ctx.bwd_sums(dy, x, mean, inv)
        total = sums
        if ctx.group is not None:
            total = sums.clone()
            dist.all_reduce(total, group=ctx.group)
        dbias, dscale = total[0], total[1]
        shape = (1, -1, 1, 1)
        g = dy.float()
        # the statistics' share of the gradient reaches only the samples
        # they were taken from
        xhat = (x[:kl].float() - mean.view(shape)) * inv.view(shape)
        head = g[:kl] - (dbias / n).view(shape) - xhat * (dscale / n).view(shape)
        g = head if kl == x.shape[0] else torch.cat([head, g[kl:]])
        dx = (scale * inv).view(shape) * g
        # the rank's own sums: the trainer's gradient all-reduce adds them up
        return dx.to(x.dtype), sums[1], sums[0], None, None, None, None, None
