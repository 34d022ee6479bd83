"""Host-side batched tile loader with threaded prefetch.

Counterpart of ``unet_tpu/data/loader.py``: tiles decode in a thread pool
through the pure-Python codec of ``geo/`` (the native batch decoder is not
ported yet) and whole batches are built ahead of the device. Batches are
NCHW in the tiles' storage dtype, ready for ``torch.from_numpy``.
"""

from __future__ import annotations

import concurrent.futures as cf
from collections import deque
from pathlib import Path
from typing import Iterator, List, Sequence, Tuple

import numpy as np

from .dataset import TileDataset

Batch = Tuple[np.ndarray, np.ndarray, int]  # images, masks, n_valid
PREFETCH = 2  # batch builds in flight ahead of the consumer


class TileLoader:
    """Iterates (images (B,C,H,W), masks (B,H,W), n_valid) batches.

    Training: shuffled by a numpy generator seeded with ``seed`` (a new
    permutation each epoch), incomplete final batch dropped. Validation:
    ordered, final batch padded by repeating the last tile; ``n_valid``
    says how many samples are real so metrics stay exact.
    """

    def __init__(self, dataset: TileDataset, files: Sequence[Path],
                 batch_size: int, shuffle: bool = False,
                 drop_last: bool = False, seed: int = 0, n_threads: int = 8):
        self.dataset = dataset
        self.files = list(files)
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.rng = np.random.default_rng(seed)
        self._pool = cf.ThreadPoolExecutor(max_workers=n_threads)  # tile decodes
        self._batcher = cf.ThreadPoolExecutor(max_workers=PREFETCH)  # batch builds

    def __len__(self) -> int:
        n = len(self.files)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _make_batch(self, paths: List[Path]) -> Batch:
        pairs = list(self._pool.map(self.dataset.load_pair, paths))
        n_valid = len(pairs)
        pairs += [pairs[-1]] * (self.batch_size - n_valid)  # pad the last eval batch
        images = np.stack([p[0] for p in pairs])
        masks = np.stack([p[1] for p in pairs])
        return images, masks, n_valid

    def __iter__(self) -> Iterator[Batch]:
        order = np.arange(len(self.files))
        if self.shuffle:
            order = self.rng.permutation(order)
        batches: List[List[Path]] = []
        for i in range(0, len(order), self.batch_size):
            idx = order[i:i + self.batch_size]
            if self.drop_last and len(idx) < self.batch_size:
                break
            batches.append([self.files[j] for j in idx])

        # keep PREFETCH batch builds in flight
        inflight: deque = deque()
        it = iter(batches)
        for paths in it:
            inflight.append(self._batcher.submit(self._make_batch, paths))
            if len(inflight) >= PREFETCH:
                break
        while inflight:
            fut = inflight.popleft()
            nxt = next(it, None)
            if nxt is not None:
                inflight.append(self._batcher.submit(self._make_batch, nxt))
            yield fut.result()

    def close(self) -> None:
        self._batcher.shutdown(wait=False)
        self._pool.shutdown(wait=False)
