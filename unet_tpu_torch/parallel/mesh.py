"""Multi-process data parallelism: the process group, each rank's device and
its share of a batch.

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
"""

from __future__ import annotations

import ipaddress
import os
import socket
from typing import Optional, Union

import numpy as np
import torch
import torch.distributed as dist

from ..utils.device import resolve_device


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
    if backend == "nccl":
        if not dist.is_nccl_available():
            raise RuntimeError("NCCL is not available in this PyTorch build; pass "
                               f"backend='gloo' (or set {BACKEND_ENV}=gloo) to use gloo")
        n_cards = torch.cuda.device_count()
        if _loopback(coordinator_address.rsplit(":", 1)[0]) and num_processes > n_cards:
            raise ValueError(
                f"{num_processes} ranks on this host share its {n_cards} CUDA device(s), "
                f"and NCCL refuses two ranks on one card: pass backend='gloo' (or set "
                f"{BACKEND_ENV}=gloo) to share a card over gloo")
    dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id)


def close_distributed() -> None:
    """Leave the process group, if this process is in one."""
    if dist.is_initialized():
        dist.destroy_process_group()


def data_size() -> int:
    """Number of ranks the batch is split over (1 without a process group)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def is_primary() -> bool:
    """Rank 0, the one that writes bundles, checkpoints and printed rows."""
    return rank() == 0


def data_group():
    """The group to reduce over: None for one process, else the world."""
    return dist.group.WORLD if data_size() > 1 else None


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
    """The global sample indices rank ``rank_`` of ``world`` holds of a
    batch split into ``n_micro`` microbatches, each split evenly over the
    ranks: microbatch i's samples ``[i·m, (i+1)·m)`` go to the ranks in
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
