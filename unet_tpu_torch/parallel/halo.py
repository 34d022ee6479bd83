"""Halo exchanges and row gathers over a space group: what GSPMD inserts
around every convolution and pool when JAX shards tile height
(``unet_tpu/parallel/mesh.py``), written by hand.

Space rank s of S holds rows [s·h, (s+1)·h) of every sample (h = H/S). A
layer that mixes rows reads the ``space_scope`` it runs in (``current``)
and, instead of padding H itself, pads it with its neighbours' boundary
rows (``exchange``): zeros at the global top and bottom for a
convolution, −inf for max pooling, the first row again for the
replication blur. Self-attention gathers its keys' and values' rows from
every rank (``gather_rows``); a serve gathers its probabilities' rows to
rank 0 alone (``gather_rows_to_first``); GroupNorm and the dice loss sum
over the space group (``all_reduce``).

Each is a ``torch.autograd.Function`` whose forward captures the scope, so
its backward, which runs on autograd's own thread where no context
variable is set, reaches the same group: the halo's gradient goes back to
the rank that owns the rows and is added there; a gather's gradient is
summed over the ranks and each keeps its slice; an all-reduce's is
all-reduced. Every rank of a space group runs the same layers in the same
order, so the collectives of the forward and of the backward pair up.

Boundary rows travel by ``all_gather`` of their bytes (any dtype, gloo and
NCCL alike); sums by ``all_reduce`` (bf16 in float32).
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import List, NamedTuple, Optional

import torch
import torch.distributed as dist


class SpaceScope(NamedTuple):
    """The space group a forward runs in: ``size`` ranks, this one at
    index ``rank`` (``parallel.mesh.space_layout`` makes it)."""

    group: object
    size: int
    rank: int


_scope: contextvars.ContextVar = contextvars.ContextVar("space_scope", default=None)


def current() -> Optional[SpaceScope]:
    """The scope of the enclosing ``space_scope`` block, or None."""
    return _scope.get()


@contextlib.contextmanager
def space_scope(scope: Optional[SpaceScope]):
    """Layers run inside the block see ``scope`` (None: no partitioning)."""
    token = _scope.set(scope)
    try:
        yield scope
    finally:
        _scope.reset(token)


def _all_gather(t: torch.Tensor, scope: SpaceScope) -> List[torch.Tensor]:
    """Every rank's ``t`` (one shape on every rank), in rank order."""
    t = t.contiguous()
    raw = t.view(-1).view(torch.uint8)
    parts = [torch.empty_like(raw) for _ in range(scope.size)]
    dist.all_gather(parts, raw, group=scope.group)
    return [p.view(t.dtype).view(t.shape) for p in parts]


def _all_reduce(t: torch.Tensor, scope: SpaceScope) -> torch.Tensor:
    """``t`` summed over the space group (a new tensor): float32 and
    float64 as they are, narrower floats in float32."""
    wide = t.dtype in (torch.float32, torch.float64)
    out = t.detach().clone() if wide else t.detach().float()
    dist.all_reduce(out, group=scope.group)
    return out if wide else out.to(t.dtype)


def _fill(x: torch.Tensor, n: int, fill: str, top: bool) -> torch.Tensor:
    """``n`` rows past the global edge: zeros, −inf, or the edge row."""
    shape = (*x.shape[:2], n, x.shape[3])
    if fill == "zeros":
        return x.new_zeros(shape)
    if fill == "-inf":
        return x.new_full(shape, float("-inf"))
    edge = x[:, :, :1] if top else x[:, :, -1:]
    return edge.expand(shape)


class _HaloExchange(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, top: int, bottom: int, fill: str, scope: SpaceScope):
        h = x.shape[2]
        if h < max(top, bottom):
            raise ValueError(f"a halo of {max(top, bottom)} rows over {h} local rows")
        r, last = scope.rank, scope.size - 1
        # my first `bottom` rows are the bottom halo of rank r - 1, my last
        # `top` rows the top halo of rank r + 1
        parts = _all_gather(torch.cat([x[:, :, :bottom], x[:, :, h - top:]], dim=2), scope)
        up = parts[r - 1][:, :, bottom:] if r > 0 else _fill(x, top, fill, True)
        down = parts[r + 1][:, :, :bottom] if r < last else _fill(x, bottom, fill, False)
        ctx.top, ctx.bottom, ctx.fill, ctx.scope, ctx.h = top, bottom, fill, scope, h
        return torch.cat([up, x, down], dim=2)

    @staticmethod
    def backward(ctx, g):
        top, bottom, scope, h = ctx.top, ctx.bottom, ctx.scope, ctx.h
        r, last = scope.rank, scope.size - 1
        g_up, g_down = g[:, :, :top], g[:, :, top + h:]
        parts = _all_gather(torch.cat([g_up, g_down], dim=2), scope)
        dx = g[:, :, top:top + h].clone()
        if r < last and top:  # rank r + 1's top halo: my last rows
            dx[:, :, h - top:] += parts[r + 1][:, :, :top]
        if r > 0 and bottom:  # rank r - 1's bottom halo: my first rows
            dx[:, :, :bottom] += parts[r - 1][:, :, top:]
        if ctx.fill == "replicate":  # the edge row stood in for the rows past it
            if r == 0 and top:
                dx[:, :, :1] += g_up.sum(dim=2, keepdim=True)
            if r == last and bottom:
                dx[:, :, -1:] += g_down.sum(dim=2, keepdim=True)
        return dx, None, None, None, None


def exchange(x: torch.Tensor, top: int, bottom: int, fill: str = "zeros",
             scope: Optional[SpaceScope] = None) -> torch.Tensor:
    """(N, C, h, W) local rows → (N, C, top + h + bottom, W): ``top`` rows
    of the rank above and ``bottom`` rows of the rank below, or ``fill``
    (``zeros``, ``-inf``, ``replicate``) past the global top and bottom.
    ``x`` itself when both are 0 or there is no scope (``current()`` by
    default)."""
    scope = scope if scope is not None else current()
    if scope is None or (top == 0 and bottom == 0):
        return x
    return _HaloExchange.apply(x, top, bottom, fill, scope)


def conv_halo(kernel: int, stride: int, pad: int):
    """(top, bottom) halo rows of a convolution or pool with kernel height
    ``kernel``, stride ``stride`` and padding ``pad`` on H: run with H
    padding 0 on the haloed rows, it gives the local rows of the global
    output (the rank's first row a multiple of ``stride``)."""
    return pad, max(kernel - 1 - pad - (stride - 1), 0)


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim: int, scope: SpaceScope):
        ctx.dim, ctx.scope, ctx.n = dim, scope, x.shape[dim]
        return torch.cat(_all_gather(x, scope), dim=dim)

    @staticmethod
    def backward(ctx, g):
        total = _all_reduce(g, ctx.scope)
        start = ctx.scope.rank * ctx.n
        return total.narrow(ctx.dim, start, ctx.n).contiguous(), None, None


def gather_rows(x: torch.Tensor, dim: int = 2,
                scope: Optional[SpaceScope] = None) -> torch.Tensor:
    """Every rank's ``x`` concatenated along ``dim`` in rank order (the
    whole tile's rows, or tokens); the gradient of a rank's slice is the
    sum over the ranks of theirs. ``x`` itself without a scope."""
    scope = scope if scope is not None else current()
    if scope is None:
        return x
    return _GatherRows.apply(x, dim, scope)


def gather_rows_to_first(x: torch.Tensor, dim: int = 2,
                         scope: Optional[SpaceScope] = None) -> Optional[torch.Tensor]:
    """``gather_rows`` for serving, outside autograd: every rank's ``x``
    concatenated along ``dim`` on the space group's rank 0 alone, None on
    the other ranks. ``x`` itself without a scope."""
    scope = scope if scope is not None else current()
    if scope is None:
        return x
    t = x.contiguous()
    raw = t.view(-1).view(torch.uint8)
    parts = [torch.empty_like(raw) for _ in range(scope.size)] if scope.rank == 0 else None
    dist.gather(raw, parts, dst=dist.get_global_rank(scope.group, 0), group=scope.group)
    if parts is None:
        return None
    return torch.cat([q.view(t.dtype).view(t.shape) for q in parts], dim=dim)


def split_rows(x: torch.Tensor, dim: int = 2,
               scope: Optional[SpaceScope] = None) -> torch.Tensor:
    """This rank's rows of a whole tensor: slice s of S equal slices along
    ``dim`` (``ValueError`` when they are not equal)."""
    scope = scope if scope is not None else current()
    if scope is None:
        return x
    n = x.shape[dim]
    if n % scope.size:
        raise ValueError(f"{n} rows do not split into spatial={scope.size} equal shares")
    k = n // scope.size
    return x.narrow(dim, scope.rank * k, k).contiguous()


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scope: SpaceScope):
        ctx.scope = scope
        return _all_reduce(x, scope)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.scope), None


def all_reduce(x: torch.Tensor, scope: Optional[SpaceScope] = None) -> torch.Tensor:
    """``x`` summed over the space group, differentiably (the gradient is
    all-reduced too); ``x`` itself without a scope."""
    scope = scope if scope is not None else current()
    if scope is None:
        return x
    return _AllReduce.apply(x, scope)
