"""Host-side batched tile loader with threaded prefetch.

Counterpart of ``unet_tpu/data/loader.py``. A batch decodes either through
the native C++ batch decoder (``native/``: the whole batch in native
threads, in the tiles' storage dtype) or tile by tile in a thread pool
through the Python codec of ``geo/``. Which path is faster depends on the
tiles' format and the host's cores, so the first batch is decoded both
ways once and the faster path is kept, as the JAX package does; ``path``
and ``first_batch_ms`` record the choice. Whole batches are built ahead of
the device. Batches are NCHW in the tiles' storage dtype, ready for
``torch.from_numpy``; the native decoder's NHWC output is transposed in the
batch worker, where prefetch hides it.

Under data parallelism every rank orders the batches alike (the same seed)
and decodes only its ``shard``: the global sample indices of each batch
that it holds (``parallel.mesh.shard_indices``).
"""

from __future__ import annotations

import concurrent.futures as cf
import threading
import time
from collections import deque
from pathlib import Path
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from .. import native
from ..geo import tiff as tiff_codec
from .dataset import TileDataset, get_mask_path

Batch = Tuple[np.ndarray, np.ndarray, int]  # images, masks, n_valid
PREFETCH = 2  # batch builds in flight ahead of the consumer


class TileLoader:
    """Iterates (images (B,C,H,W), masks (B,H,W), n_valid) batches.

    Training: shuffled by a numpy generator seeded with ``seed`` (a new
    permutation each epoch), incomplete final batch dropped. Validation:
    ordered, final batch padded by repeating the last tile; ``n_valid``
    says how many samples are real so metrics stay exact.

    ``path`` is ``"native"`` or ``"python"`` once the first batch has been
    built (None before); ``first_batch_ms`` holds that batch's decode time
    each way (None for a path that was not timed: no native library, or a
    native decode that failed).

    ``shard`` (default: every index) are the samples of each ``batch_size``
    batch this process decodes, increasing; ``n_valid`` then counts the
    real samples among them, which come first.
    """

    def __init__(self, dataset: TileDataset, files: Sequence[Path],
                 batch_size: int, shuffle: bool = False,
                 drop_last: bool = False, seed: int = 0, n_threads: int = 8,
                 shard: Optional[Sequence[int]] = None):
        self.dataset = dataset
        self.files = list(files)
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.rng = np.random.default_rng(seed)
        self.shard = np.arange(batch_size) if shard is None else np.asarray(shard)
        if np.any(np.diff(self.shard) <= 0):
            raise ValueError(f"shard {self.shard.tolist()} is not increasing")
        self.n_threads = n_threads
        self._pool = cf.ThreadPoolExecutor(max_workers=n_threads)  # tile decodes
        self._batcher = cf.ThreadPoolExecutor(max_workers=PREFETCH)  # batch builds
        self._decide_lock = threading.Lock()
        self.path: Optional[str] = None
        self.first_batch_ms: Dict[str, Optional[float]] = {"native": None, "python": None}
        # the native path needs the library and the tiles' shape and dtypes
        self._tile_shape: Optional[Tuple[int, int, int]] = None
        self._tile_dtype: Optional[np.dtype] = None
        self._mask_dtype: Optional[np.dtype] = None
        self._native = False
        if self.files and native.available() and not dataset.regression:
            # the native decoder serves integer masks: float regression
            # masks take the Python codec, and so do float images under the
            # truncation quirk
            try:
                info = tiff_codec.read_info(str(self.files[0]))
                minfo = tiff_codec.read_info(str(get_mask_path(self.files[0])))
                self._tile_shape = (info.height, info.width, info.bands)
                self._tile_dtype, self._mask_dtype = info.dtype, minfo.dtype
                self._native = not (dataset.reference_quirks and info.dtype.kind == "f")
            except (OSError, ValueError):
                self._native = False

    def __len__(self) -> int:
        n = len(self.files)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _make_batch(self, paths: List[Path], n_valid: int) -> Batch:
        """Decode ``paths``, padded to the shard's size; ``n_valid`` of them
        are real (0 where ``paths`` is only the batch's last tile)."""
        if self.path is None:
            # prefetch workers run this concurrently; decide exactly once
            with self._decide_lock:
                if self.path is None:
                    self._choose_path(paths)
        if self.path == "native":
            try:
                return (*self.make_batch_native(paths)[:2], n_valid)
            except RuntimeError:
                self.path = "python"  # permanent fallback to the Python codec
        return (*self.make_batch_python(paths)[:2], n_valid)

    def _choose_path(self, paths: List[Path]) -> None:
        """Decode the first batch both ways once and keep the faster path.
        Runs under ``_decide_lock``; sets ``path`` last, so other workers
        either wait here or see the final choice."""
        chosen = "python"
        if self._native:
            try:
                t0 = time.perf_counter()
                self.make_batch_native(paths)
                self.first_batch_ms["native"] = (time.perf_counter() - t0) * 1e3
                t0 = time.perf_counter()
                self.make_batch_python(paths)
                self.first_batch_ms["python"] = (time.perf_counter() - t0) * 1e3
                if self.first_batch_ms["native"] <= self.first_batch_ms["python"]:
                    chosen = "native"
            except RuntimeError:
                pass
        self.path = chosen

    def make_batch_python(self, paths: List[Path]) -> Batch:
        """The batch of ``paths`` decoded tile by tile by the Python codec."""
        pairs = list(self._pool.map(self.dataset.load_pair, paths))
        n_valid = len(pairs)
        pairs += [pairs[-1]] * (len(self.shard) - n_valid)  # pad the last eval batch
        images = np.stack([p[0] for p in pairs])
        masks = np.stack([p[1] for p in pairs])
        return images, masks, n_valid

    def make_batch_native(self, paths: List[Path]) -> Batch:
        """The batch of ``paths`` decoded by the native batch decoder, the
        same arrays as ``make_batch_python``. Raises ``RuntimeError`` when
        the library is missing or a tile does not decode."""
        if not self._native:
            raise RuntimeError("native decoder unavailable for these tiles")
        h, w, c = self._tile_shape
        n_valid = len(paths)
        full = list(paths) + [paths[-1]] * (len(self.shard) - n_valid)
        nhwc = native.decode_batch_raw(full, h, w, c, self._tile_dtype, self.n_threads)
        images = np.ascontiguousarray(nhwc.transpose(0, 3, 1, 2))
        mask_paths = [get_mask_path(p) for p in full]
        if self._mask_dtype.kind in "iu":
            # class masks in their storage dtype, as dataset.load_pair keeps them
            masks = native.decode_batch_raw(mask_paths, h, w, 1, self._mask_dtype,
                                            self.n_threads)[..., 0]
        else:
            masks = native.decode_masks(mask_paths, h, w, self.n_threads)
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
            # this process's real samples; make_batch_* pad them (the last
            # eval batch); a share holding none decodes the batch's last tile
            real = [self.files[idx[j]] for j in self.shard if j < len(idx)]
            batches.append((real or [self.files[idx[-1]]], len(real)))

        # keep PREFETCH batch builds in flight
        inflight: deque = deque()
        it = iter(batches)
        for batch in it:
            inflight.append(self._batcher.submit(self._make_batch, *batch))
            if len(inflight) >= PREFETCH:
                break
        while inflight:
            fut = inflight.popleft()
            nxt = next(it, None)
            if nxt is not None:
                inflight.append(self._batcher.submit(self._make_batch, *nxt))
            yield fut.result()

    def one_batch(self) -> Batch:
        """The first batch of a new iteration, as the JAX loader's
        ``one_batch``: a shuffled loader draws that iteration's
        permutation, so every later epoch's order is the one JAX's loader
        gives after its ``one_batch``."""
        it = iter(self)
        try:
            return next(it)
        finally:
            it.close()

    def close(self) -> None:
        self._batcher.shutdown(wait=False)
        self._pool.shutdown(wait=False)
