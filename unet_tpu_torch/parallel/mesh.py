"""Multi-process data and spatial parallelism: the process group, its
(data, space) layout, each rank's device and its share of a batch.

Counterpart of ``unet_tpu/parallel/mesh.py`` for processes. JAX shards the
batch axis of one program over a mesh of chips (GSPMD), so its BatchNorm
statistics and its loss normalizers are those of the global batch. The port
runs one process a rank, joined by ``torch.distributed``, and gets the same
step by hand: every rank draws the whole batch's order and augmentation
from the seed and decodes only its own samples (``shard_indices``); each
training BatchNorm all-reduces its ``bn_stats`` sums (``ops/bn.py``); each
loss divides its rank's numerator by the global denominator
(``train/losses.py``); the gradients are summed over the ranks
(``train/loop.py``). A step of W ranks is then the step of one process on
the global batch, up to the order of float sums.

``init_distributed`` is a no-op without a coordinator and a process count,
as in JAX. The default backend is NCCL for a CUDA device and gloo for the
CPU. Ranks that share a card (a loopback coordinator and more ranks than
the host has cards), which NCCL refuses, must ask for gloo: ``backend=
"gloo"``, or ``UNET_TPU_TORCH_BACKEND=gloo`` in the environment of a
command line; under NCCL they raise. A missing NCCL raises. No backend is
ever swapped in for another.

Spatial partitioning (``spatial`` > 1) is JAX's second mesh axis
(``make_mesh(spatial=S)``), done by hand over the same process group: a
world of W = D × S ranks, rank r at data index r // S and space index
r % S, so adjacent ranks form one space group (``space_layout``). Every
space rank of a data index holds the same samples and rows
[s·H/S, (s+1)·H/S) of each; the weights are replicated; the row-mixing
layers exchange halos over the space group (``parallel/halo.py``) and
the BatchNorm statistics, the loss denominators and the gradients are
reduced over the world. ``launch`` starts the S ranks of a command line
that asks for ``spatial`` without a process group: JAX runs one process
over S local chips, PyTorch one process a card.
"""

from __future__ import annotations

import importlib
import ipaddress
import os
import socket
import sys
from typing import Dict, Optional, Sequence, Union

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from ..utils.device import resolve_device
from .halo import SpaceScope


def _loopback(host: str) -> bool:
    if host == "localhost":
        return True
    try:
        return ipaddress.ip_address(host).is_loopback
    except ValueError:
        return False


BACKEND_ENV = "UNET_TPU_TORCH_BACKEND"


def default_backend(device: Union[str, torch.device]) -> str:
    """The backend when the caller names none: ``UNET_TPU_TORCH_BACKEND``
    if set, else NCCL for a CUDA device and gloo for the CPU."""
    return os.environ.get(BACKEND_ENV) or (
        "nccl" if torch.device(device).type == "cuda" else "gloo")


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     backend: Optional[str] = None,
                     device: Union[str, torch.device] = "cuda") -> None:
    """Join the process group at ``tcp://<coordinator_address>`` as rank
    ``process_id`` of ``num_processes``; run the same call in every
    process. A no-op when the address and the count are both absent."""
    if coordinator_address is None and num_processes is None:
        return
    if coordinator_address is None or num_processes is None or process_id is None:
        raise ValueError("a process group needs the coordinator address, the number "
                         "of processes and this process's id")
    if not 0 <= process_id < num_processes:
        raise ValueError(f"process id {process_id} outside 0..{num_processes - 1}")
    backend = backend or default_backend(device)
    _check_backend(backend, coordinator_address.rsplit(":", 1)[0], num_processes)
    dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id)


def _check_backend(backend: str, host: str, n_ranks: int,
                   spatial: Optional[int] = None) -> None:
    """Raise where ``backend`` cannot join ``n_ranks`` ranks whose
    coordinator is ``host``: NCCL missing, or NCCL with more ranks on this
    host than it has cards (``spatial``: the ranks are a command's spatial
    partition, named in the message as JAX names it)."""
    if backend != "nccl":
        return
    if not dist.is_nccl_available():
        raise RuntimeError("NCCL is not available in this PyTorch build; pass "
                           f"backend='gloo' (or set {BACKEND_ENV}=gloo) to use gloo")
    n_cards = torch.cuda.device_count()
    if _loopback(host) and n_ranks > n_cards:
        jax_words = (f"spatial={spatial} needs that many devices, have {n_cards}: "
                     if spatial else "")
        raise ValueError(
            f"{jax_words}{n_ranks} ranks on this host share its {n_cards} CUDA device(s), "
            f"and NCCL refuses two ranks on one card: pass backend='gloo' (or set "
            f"{BACKEND_ENV}=gloo) to share a card over gloo")


def close_distributed() -> None:
    """Leave the process group, if this process is in one (and forget its
    spatial layouts)."""
    global _active
    _scopes.clear()
    _active = None
    if dist.is_initialized():
        dist.destroy_process_group()


_scopes: Dict[int, SpaceScope] = {}  # spatial -> this rank's space group
_active: Optional[SpaceScope] = None  # the layout in use (None: no spatial partitioning)


def space_layout(spatial: int) -> Optional[SpaceScope]:
    """This rank's space group when the process group splits into groups
    of ``spatial`` adjacent ranks (None for ``spatial`` = 1: the plain
    data-parallel layout), and the layout in use from now on (a trainer or
    a predictor asks for its own). Every rank makes the same call; the
    first one for a ``spatial`` creates one space group a data index, in
    every rank, with ``dist.new_group``. Raises ``ValueError`` when the
    world does not divide into groups of ``spatial``, with JAX's words,
    before any compute."""
    global _active
    spatial = int(spatial)
    if spatial < 1:
        raise ValueError(f"spatial={spatial}: expected 1 or more")
    if spatial == 1:
        _active = None
        return None
    if spatial in _scopes:
        _active = _scopes[spatial]
        return _active
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world < spatial:
        raise ValueError(
            f"spatial={spatial} needs that many devices, have {world}: start {spatial} "
            f"ranks, one a card (unet_tpu_torch.parallel.mesh.launch; the command line "
            f"and api.main start them when given spatial)")
    if world % spatial:
        raise ValueError(f"{world} devices do not divide into spatial={spatial} groups")
    r = dist.get_rank()
    groups = [dist.new_group(list(range(d * spatial, (d + 1) * spatial)))
              for d in range(world // spatial)]
    _active = _scopes[spatial] = SpaceScope(groups[r // spatial], spatial, r % spatial)
    return _active


def space_size() -> int:
    """Ranks a space group (1 without spatial partitioning)."""
    return 1 if _active is None else _active.size


def space_rank() -> int:
    """This rank's space index: it holds rows [s·H/S, (s+1)·H/S)."""
    return 0 if _active is None else _active.rank


def space_group():
    """This rank's space group (None without spatial partitioning)."""
    return None if _active is None else _active.group


def data_size() -> int:
    """Number of ways the batch is split: the world over the space groups
    (1 without a process group)."""
    return (dist.get_world_size() if dist.is_initialized() else 1) // space_size()


def data_index() -> int:
    """This rank's data index: the share of the batch it holds."""
    return rank() // space_size()


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def is_primary() -> bool:
    """Rank 0, the one that writes bundles, checkpoints and printed rows."""
    return rank() == 0


def data_group():
    """The group the BatchNorm statistics, the loss denominators and the
    gradients are reduced over: None for one process, else the world
    (every data index and every space rank)."""
    return dist.group.WORLD if dist.is_initialized() and dist.get_world_size() > 1 else None


def rank_device(device: Union[str, torch.device] = "cuda") -> torch.device:
    """This rank's device: ``cuda:{rank % cards}`` when the caller says
    ``cuda``, else the device the caller names (``resolve_device``)."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", rank() % torch.cuda.device_count())
    return dev


def all_reduce_sum(t: torch.Tensor, group) -> torch.Tensor:
    """``t`` summed over the ranks of ``group`` (a new tensor, outside
    autograd); ``t`` itself when ``group`` is None."""
    if group is None:
        return t
    t = t.detach().clone()
    dist.all_reduce(t, group=group)
    return t


def shard_indices(batch_size: int, n_micro: int, world: int, rank_: int) -> np.ndarray:
    """The global sample indices data index ``rank_`` of ``world`` holds of
    a batch split into ``n_micro`` microbatches, each split evenly over the
    data indices: microbatch i's samples ``[i·m, (i+1)·m)`` go to them in
    order, ``m/world`` each (what GSPMD computes on the sharded batch)."""
    m = batch_size // n_micro
    if batch_size % n_micro or m % world:
        raise ValueError(
            f"batch_size {batch_size} with grad_accum={n_micro} does not split "
            f"evenly over {world} processes: each microbatch of {batch_size / n_micro:g} "
            f"samples needs a multiple of {world}")
    w = m // world
    return (np.arange(n_micro)[:, None] * m + rank_ * w + np.arange(w)[None]).reshape(-1)


def free_port() -> int:
    """A TCP port on localhost that nothing listens on now."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def broadcast_from_primary(value, group=None):
    """``value`` as rank 0 of ``group`` (the world by default) has it, on
    every rank of it; ``value`` itself without a process group."""
    if not dist.is_initialized():
        return value
    box = [value]
    dist.broadcast_object_list(box, src=dist.get_global_rank(group, 0) if group else 0,
                               group=group)
    return box[0]


def _launched_rank(rank_: int, n_ranks: int, port: int, device: str, target: str,
                   args: Sequence) -> None:
    """One rank that ``launch`` started: join the group, run ``target``
    (``module:function``) on ``args``, exit with its return code. Rank 0
    alone prints."""
    if rank_:
        sys.stdout = open(os.devnull, "w")
    init_distributed(f"127.0.0.1:{port}", n_ranks, rank_, device=device)
    try:
        module, name = target.split(":")
        code = getattr(importlib.import_module(module), name)(*args)
    finally:
        close_distributed()
    sys.exit(code or 0)


def launch(n_ranks: int, target: str, args: Sequence = (),
           device: Union[str, torch.device] = "cuda") -> int:
    """Run ``target`` (``"module:function"``) on ``args`` in ``n_ranks``
    spawned processes joined by a process group over a loopback
    coordinator on a free port: rank r on card r % cards (``rank_device``)
    or on the CPU when ``device`` says so; the backend as
    ``init_distributed`` picks it, checked here before any process starts.
    Returns 0 when every rank exits 0, else the code of the first rank
    that fails (1 for an exception, whose traceback goes to stderr, or a
    signal); the others are stopped then."""
    _check_backend(default_backend(resolve_device(device)), "127.0.0.1", n_ranks,
                   spatial=n_ranks)
    try:
        mp.start_processes(_launched_rank,
                           (n_ranks, free_port(), str(device), target, tuple(args)),
                           nprocs=n_ranks, start_method="spawn")
    except mp.ProcessExitedException as e:
        return e.exit_code if e.exit_code > 0 else 1
    except mp.ProcessRaisedException as e:
        print(e, file=sys.stderr)
        return 1
    return 0
