"""Per-tile progress reporting (a copy of ``unet_tpu/utils/progress.py``).

The reference shows a tqdm bar over prediction tiles (predict.py:191) —
the UX for hour-long merge runs. tqdm is used when it imports; otherwise a
plain-text fallback prints every ~10%.
"""

from __future__ import annotations


class TileProgress:
    """Counts processed tiles; renders tqdm when available."""

    def __init__(self, total: int, desc: str = "tiles", enabled: bool = True):
        self.total = int(total)
        self.n = 0
        self._bar = None
        self._next_print = 0
        self.enabled = enabled
        if not enabled:
            return
        try:
            from tqdm import tqdm

            self._bar = tqdm(total=self.total, desc=desc, unit="tile")
        except Exception:
            self._bar = None

    def update(self, n: int = 1) -> None:
        self.n += n
        if not self.enabled:
            return
        if self._bar is not None:
            self._bar.update(n)
        elif self.n >= self._next_print:
            print(f"Processing tiles: {self.n}/{self.total}", flush=True)
            self._next_print = self.n + max(self.total // 10, 1)

    def close(self) -> None:
        if self._bar is not None:
            self._bar.close()
            self._bar = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
