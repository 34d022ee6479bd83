"""Data-parallel scaling sanity bench over CPU processes.

    python -m unet_tpu_torch.bench_scaling

Counterpart of ``unet_tpu/bench_scaling.py``. JAX jits its sharded train
step over 1, 2, 4 and 8 virtual CPU devices in one process; the port runs
its data-parallel ``Trainer`` step in N processes joined by gloo on the
CPU, one thread each, for N in ``mesh_sizes`` while N does not exceed the
host's cores. Each rank holds a fixed share of the global batch
(``PER_DEVICE`` tiles), so ideal weak scaling keeps the step time flat
while N ≤ cores; the meaningful signal is the ratio's rise beyond that —
the gradients' and BatchNorm sums' all-reduces through gloo — plus proof
that the step runs at every world size. These are CPU processes, not
cards: the section asks for the CPU explicitly.

The processes of the largest world start once and run every world,
largest first (the ranks below N join the N-rank group on a port of its
own, run the steps, and leave it), so that one process start-up serves
all the worlds.

Settings as JAX's: xresnet18 tpu_opt, float32, 64² tiles, 2 tiles a rank,
5 timed steps (rank 0's step times), after one warm step where JAX takes
two (its first compiles; an eager step has nothing to compile).
"""

from __future__ import annotations

import json
import math
import os
import socket
import sys
import tempfile
from pathlib import Path
from typing import List, Sequence, Tuple

import numpy as np

TILE, C_IN, N_CLASSES, PER_DEVICE = 64, 3, 3, 2
WARM, STEPS = 1, 5


def _tiles(root: Path, n_train: int) -> Path:
    """A tile tree of ``n_train`` training tiles and two validation tiles
    (uint8, seeded), as ``tile`` lays it out."""
    from .geo import tiff

    rng = np.random.default_rng(0)
    for split, n in (("trai", n_train), ("vali", 2)):
        for sub in ("img_tiles", "mask_tiles"):
            (root / split / sub).mkdir(parents=True)
        for i in range(n):
            tiff.write(str(root / split / "img_tiles" / f"t_{i}.tif"),
                       rng.integers(0, 255, (C_IN, TILE, TILE)).astype(np.uint8))
            tiff.write(str(root / split / "mask_tiles" / f"t_{i}.tif"),
                       rng.integers(0, N_CLASSES, (TILE, TILE)).astype(np.uint8))
    return root


def rank_worlds(rank: int, worlds: Sequence[Tuple[int, int]], tiles: str, out: str) -> None:
    """One process of the largest world. For each (N, port) of ``worlds``,
    largest first, while this rank is below N: join the N-rank gloo group
    on ``port``, run the float32 data-parallel step on this rank's share of
    a global batch of ``PER_DEVICE`` × N tiles ``WARM`` + ``STEPS`` times,
    and leave the group; rank 0 writes its timed step milliseconds and the
    last loss to ``out/n<N>.json``."""
    import torch

    from .parallel import mesh
    from .train.loop import Trainer, TrainerConfig

    torch.set_num_threads(1)
    for n, port in worlds:
        if rank >= n:
            break
        mesh.init_distributed(f"127.0.0.1:{port}", n, rank, device="cpu")
        try:
            trainer = Trainer(TrainerConfig(
                data_path=tiles, model_path=str(Path(out) / "models"), description="scaling",
                batch_size=PER_DEVICE * n, epochs=1, lr=1e-4, arch="xresnet18",
                codes=["a", "b", "c"], tpu_opt=True, bf16=False, seed=0, loader_threads=2,
                device="cpu"))
            try:
                trainer.init_state()
                host = next(iter(trainer.train_loader))[:2]
                for _ in range(WARM + STEPS):
                    loss = float(trainer.train_step(*host))
            finally:
                trainer.close()
            if not math.isfinite(loss):
                raise RuntimeError(f"non-finite loss {loss} at world {n}")
            if rank == 0:
                (Path(out) / f"n{n}.json").write_text(
                    json.dumps({"step_ms": trainer.step_ms()[WARM:], "loss": loss}))
        finally:
            mesh.close_distributed()


def _free_ports(k: int) -> List[int]:
    """``k`` distinct TCP ports on localhost that nothing listens on now."""
    socks = [socket.socket(socket.AF_INET, socket.SOCK_STREAM) for _ in range(k)]
    try:
        for s in socks:
            s.bind(("127.0.0.1", 0))
        return [s.getsockname()[1] for s in socks]
    finally:
        for s in socks:
            s.close()


def main(mesh_sizes: Sequence[int] = (1, 2, 4, 8)) -> dict:
    import torch.multiprocessing as mp

    from .utils.timing import spread

    cores = os.cpu_count() or 1
    sizes: List[int] = []
    for n in mesh_sizes:
        if n > cores:
            break
        sizes.append(n)
    results = {}
    with tempfile.TemporaryDirectory() as d:
        tiles = _tiles(Path(d) / "tiles", PER_DEVICE * max(sizes))
        worlds = list(zip(sorted(sizes, reverse=True), _free_ports(len(sizes))))
        try:
            mp.start_processes(rank_worlds, (worlds, str(tiles), d), nprocs=max(sizes),
                               start_method="spawn")
        except (mp.ProcessRaisedException, mp.ProcessExitedException) as e:
            raise RuntimeError(f"a scaling rank failed: {e}") from None
        t1 = None
        for n in sizes:
            ms = json.loads((Path(d) / f"n{n}.json").read_text())["step_ms"]
            step_ms = float(np.mean(ms))
            if t1 is None:
                t1 = step_ms
            results[f"n{n}"] = {
                "step_ms": round(step_ms, 2),
                "ratio_vs_1dev": round(step_ms / t1, 3),
                "global_batch": PER_DEVICE * n,
                "spread": {"step_ms": spread(ms)},
            }
    return {
        "caveat": f"CPU processes over gloo on this host's {cores} cores, one thread "
                  "each: weak scaling of the data-parallel step (gradients and "
                  "BatchNorm sums all-reduced), NOT cards; ideal ratio ~1 while N <= "
                  "cores",
        "per_device_batch": PER_DEVICE,
        "tile": TILE,
        **results,
        "device": "cpu",
    }


if __name__ == "__main__":
    print(json.dumps(main()))
    sys.exit(0)
