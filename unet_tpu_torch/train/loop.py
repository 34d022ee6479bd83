"""The training engine: one-cycle fit of the tpu_opt U-Net on one device.

Counterpart of ``unet_tpu/train/loop.py`` for its default path:

* a train step = uint8 tiles to the device → flip + scale
  (``fused_flip_scale``) → bf16 forward in training mode (every BatchNorm
  through the ``bn_stats`` kernels) → class-weighted cross-entropy on the
  folded logits → backward → fastai Adam under the one-cycle schedule;
* validation after every epoch on full-resolution logits, with padded
  samples masked out, and ``dice_multi`` over the epoch;
* SaveModelCallback: the best epoch's weights (by ``monitor``) are kept and
  restored at the end;
* a CSVLogger-schema history (epoch, train_loss, valid_loss, dice_multi,
  time) with fastai's smoothed train loss (β = 0.98);
* ``export`` writes the bundle ``unet_tpu`` reads: ``<desc>.json``, flax
  msgpack weights, ``best-model.msgpack`` and ``<desc>_history.csv``.

The LR finder, transfer learning and pretrained encoders, gradient
accumulation, regression, the parity topology, self-attention, resume and
step checkpoints, multi-process training and profiling are not ported yet;
``TrainerConfig`` has no fields for them.
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..data import (NOOP_AUGMENT, AugmentConfig, TileDataset, TileLoader,
                    augment_batch, get_datatype, get_patch_size,
                    resolve_class_weights)
from ..models import TPU_OPT_TOPOLOGY_VERSION, build_unet, init_weights
from ..utils.device import resolve_device
from . import checkpoint as ckpt
from .losses import build_loss, fold_loss_layout
from .metrics import dice_multi_init, dice_multi_update, dice_multi_value
from .optimizer import OneCycleAdam

MONITORS = ("dice_multi", "valid_loss", "train_loss")


@dataclass
class TrainerConfig:
    """The ported part of ``unet_tpu.train.loop.TrainerConfig``, plus the
    ``device`` (default ``cuda``)."""

    data_path: Union[str, Path] = "."
    model_path: Union[str, Path] = "."
    description: str = "model"
    batch_size: int = 4
    epochs: int = 15
    lr: float = 1e-4
    arch: str = "xresnet34"
    codes: Sequence[str] = ("background", "foreground")
    class_weights: Union[str, Sequence[float]] = "even"
    encoder_factor: float = 10.0
    loss_func: Optional[str] = None
    monitor: Optional[str] = None
    valid_scenes: Sequence[str] = ("vali",)
    transforms: bool = True
    split_idx: Optional[int] = 0
    n_transform_imgs: float = 1.0
    aug: AugmentConfig = field(default_factory=AugmentConfig)
    info: str = ""
    class_zero: bool = False
    normalize: str = "reference"
    bf16: bool = True
    seed: int = 0
    loader_threads: int = 8
    device: str = "cuda"


def _monitor_defaults(monitor: Optional[str]) -> Tuple[str, Callable]:
    """The monitored history column and its comparator (greater is better
    for metrics, less for losses)."""
    monitor = monitor or "dice_multi"
    if monitor not in MONITORS:
        raise ValueError(f"monitor {monitor!r} not in {MONITORS}")
    return monitor, (np.less if monitor.endswith("_loss") else np.greater)


def _fmt_time(seconds: float) -> str:
    s = int(round(seconds))
    return f"{s // 60:02d}:{s % 60:02d}"


class Trainer:
    def __init__(self, cfg: TrainerConfig):
        self.cfg = cfg
        self.device = resolve_device(cfg.device)
        if cfg.transforms and not cfg.aug.flips_only():
            raise NotImplementedError(
                f"augmentations other than flips ({cfg.aug.describe()}) are not yet ported")
        self.data_path = Path(cfg.data_path)
        self.dataset = TileDataset(self.data_path, valid_scenes=cfg.valid_scenes)
        self.dtype_str = get_datatype(self.data_path)
        self.train_loader = TileLoader(self.dataset, self.dataset.train_files,
                                       cfg.batch_size, shuffle=True, drop_last=True,
                                       seed=cfg.seed, n_threads=cfg.loader_threads)
        self.valid_loader = TileLoader(self.dataset, self.dataset.valid_files,
                                       cfg.batch_size, n_threads=cfg.loader_threads)
        if len(self.train_loader) == 0:
            raise ValueError(f"batch_size {cfg.batch_size} exceeds "
                             f"{self.dataset.n_train} training tiles")
        if self.dataset.n_valid == 0:
            raise ValueError(
                f"No validation tiles: no scene folder named {list(cfg.valid_scenes)} "
                f"under {self.data_path} contains img_tiles")
        sample_img, _ = self.dataset.load_pair(self.dataset.train_files[0])
        self.c_in = sample_img.shape[0]
        self.tile_hw = sample_img.shape[1:]
        self.n_out = len(cfg.codes)
        if self.tile_hw[0] % 4 or self.tile_hw[1] % 4:
            raise NotImplementedError(
                f"tile size {self.tile_hw} is not divisible by 4: the parity "
                "topology it needs is not yet ported")
        self.model = build_unet(cfg.arch, n_out=self.n_out, c_in=self.c_in,
                                dtype=torch.bfloat16 if cfg.bf16 else torch.float32)
        self.class_weights = resolve_class_weights(cfg.class_weights, cfg.codes,
                                                   self.data_path)
        self.loss_fn = build_loss(cfg.loss_func, torch.tensor(
            self.class_weights, dtype=torch.float32, device=self.device))
        self.monitor, self.comp = _monitor_defaults(cfg.monitor)
        self.aug_cfg = cfg.aug if cfg.transforms else NOOP_AUGMENT
        self.steps_per_epoch = len(self.train_loader)
        self.total_steps = self.steps_per_epoch * cfg.epochs
        self.history: List[Dict[str, Any]] = []
        self.optimizer: Optional[OneCycleAdam] = None
        self.best_state: Optional[Dict[str, torch.Tensor]] = None
        self.generator = torch.Generator().manual_seed(cfg.seed + 1)  # flip flags
        self._step_times: List[Any] = []  # per step: CUDA event pair or seconds

    def close(self) -> None:
        self.train_loader.close()
        self.valid_loader.close()

    # --- state ---------------------------------------------------------------

    def init_state(self, variables: Optional[Dict[str, Any]] = None) -> None:
        """Set the weights — a flax ``{'params', 'batch_stats'}`` tree when
        given, else ``init_weights`` from the config's seed — and start a
        fresh optimizer."""
        self.model.cpu()
        if variables is None:
            init_weights(self.model, torch.Generator().manual_seed(self.cfg.seed))
        else:
            sd = ckpt.from_flax_variables(variables)
            self.model.load_state_dict({k: torch.from_numpy(np.array(a, np.float32))
                                        for k, a in sd.items()}, strict=True)
        self.model.to(self.device)
        self.optimizer = OneCycleAdam(self.model.named_parameters(), self.cfg.lr,
                                      self.total_steps,
                                      encoder_factor=self.cfg.encoder_factor)

    # --- steps -----------------------------------------------------------------

    def to_device(self, images: np.ndarray, masks: np.ndarray
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
        """A host batch onto the device, in its storage dtypes."""
        return (torch.from_numpy(images).to(self.device),
                torch.from_numpy(masks).to(self.device))

    def augment(self, images: torch.Tensor, masks: Optional[torch.Tensor],
                split: str, generator: torch.Generator, **kwargs):
        cfg = self.cfg
        return augment_batch(images, masks, self.aug_cfg, generator,
                             n_transform_imgs=cfg.n_transform_imgs,
                             dtype_str=self.dtype_str, normalize=cfg.normalize,
                             split=split, split_idx=cfg.split_idx, **kwargs)

    def loss_and_grads(self, images: torch.Tensor, masks: torch.Tensor) -> torch.Tensor:
        """Training-mode forward on scaled float images, the loss on the
        folded logits, and its backward into the parameters' ``.grad``."""
        self.model.train()
        for p in self.model.parameters():
            p.grad = None
        logits, targets = fold_loss_layout(self.model(images, fold_logits=True), masks)
        loss = self.loss_fn(logits, targets)
        loss.backward()
        return loss.detach()

    def train_step(self, images: np.ndarray, masks: np.ndarray) -> torch.Tensor:
        """One optimizer step on a host batch; returns the loss as a device
        scalar (not fetched, so steps queue without a host sync)."""
        if self.device.type == "cuda":
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
        else:
            t0 = time.perf_counter()
        x, y = self.augment(*self.to_device(images, masks), "train", self.generator)
        loss = self.loss_and_grads(x, y)
        self.optimizer.step()
        if self.device.type == "cuda":
            end.record()
            self._step_times.append((start, end))
        else:
            self._step_times.append(time.perf_counter() - t0)
        return loss

    def step_ms(self) -> List[float]:
        """Milliseconds of every train step so far (device time on CUDA,
        from the host copy of the batch to the optimizer update)."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
            return [s.elapsed_time(e) for s, e in self._step_times]
        return [t * 1e3 for t in self._step_times]

    # --- validation --------------------------------------------------------------

    @torch.no_grad()
    def evaluate(self) -> Dict[str, float]:
        self.model.eval()
        state = dice_multi_init(self.n_out, self.device)
        losses: List[torch.Tensor] = []
        counts: List[int] = []
        generator = torch.Generator().manual_seed(self.cfg.seed + 7)
        for images, masks, n_valid in self.valid_loader:
            x, y = self.augment(*self.to_device(images, masks), "valid", generator)
            sample_mask = torch.arange(x.shape[0], device=self.device) < n_valid
            logits = self.model(x)
            losses.append(self.loss_fn(logits, y, sample_mask=sample_mask))
            state = dice_multi_update(state, logits, y, sample_mask)
            counts.append(n_valid)
        values = torch.stack(losses).cpu().tolist()
        valid_loss = sum(v * n for v, n in zip(values, counts)) / max(sum(counts), 1)
        return {"valid_loss": valid_loss, "dice_multi": float(dice_multi_value(state))}

    # --- fit -----------------------------------------------------------------------

    def fit(self) -> List[Dict[str, Any]]:
        cfg = self.cfg
        if self.optimizer is None:
            self.init_state()
        best_metric = None
        smooth_loss, smooth_count, beta = 0.0, 0, 0.98  # fastai AvgSmoothLoss
        for epoch in range(cfg.epochs):
            t0 = time.monotonic()
            losses = [self.train_step(images, masks)
                      for images, masks, _ in self.train_loader]
            for loss in torch.stack(losses).cpu().tolist():
                if math.isfinite(loss):
                    smooth_count += 1
                    smooth_loss = beta * smooth_loss + (1 - beta) * loss
            row: Dict[str, Any] = {
                "epoch": epoch,
                "train_loss": smooth_loss / (1 - beta ** max(smooth_count, 1))}
            row.update(self.evaluate())
            row["time"] = _fmt_time(time.monotonic() - t0)
            self.history.append(row)
            print("  ".join(f"{k}={v if isinstance(v, str) else round(v, 5)}"
                            for k, v in row.items()))
            current = row[self.monitor]
            if best_metric is None or self.comp(current, best_metric):
                best_metric = current
                self.best_state = {k: v.detach().cpu().clone()
                                   for k, v in self.model.state_dict().items()}
        if self.best_state is not None:  # SaveModelCallback: restore the best epoch
            self.model.load_state_dict(self.best_state)
        return self.history

    # --- export ----------------------------------------------------------------------

    def manifest(self) -> Dict[str, Any]:
        """The run manifest ``unet_tpu train`` writes: the reference's
        description.json fields plus what rebuilds the model."""
        width, resolution, data_type, bands = get_patch_size(self.data_path)
        cfg = self.cfg
        return {
            "transforms": bool(cfg.transforms),
            "patch_size": width,
            "resolution": list(resolution) if resolution else None,
            "data_type": data_type,
            "number_of_bands": bands,
            "aug_params_": self.aug_cfg.describe() if cfg.transforms else None,
            "BATCH_SIZE": cfg.batch_size,
            "EPOCHS": cfg.epochs,
            "enable_regression": False,
            "LEARNING_RATE": cfg.lr,
            "LR_FINDER": None,
            "ENCODER_FACTOR": cfg.encoder_factor,
            "CLASS_WEIGHTS": cfg.class_weights if isinstance(cfg.class_weights, str)
            else list(cfg.class_weights),
            "loss_func": cfg.loss_func,
            "self_attention": False,
            "monitor": self.monitor,
            "VALID_SCENES": list(cfg.valid_scenes),
            "ARCHITECTURE": cfg.arch,
            "CODES": list(cfg.codes),
            "n_transform_imgs": cfg.n_transform_imgs,
            "info": cfg.info,
            "class_zero": cfg.class_zero,
            "n_out": self.n_out,
            "c_in": self.c_in,
            "tpu_opt": True,
            "tpu_opt_topology": TPU_OPT_TOPOLOGY_VERSION,
            "dtype_str": self.dtype_str,
            "normalize": cfg.normalize,
            "resolved_class_weights": list(self.class_weights),
        }

    def export(self) -> Path:
        """Write the bundle of the model as it stands (after ``fit``, the
        best epoch's weights)."""
        cfg = self.cfg
        bundle_dir = Path(cfg.model_path) / cfg.description
        ckpt.export_bundle(bundle_dir, cfg.description,
                           ckpt.to_flax_variables(self.model.state_dict()),
                           self.manifest())
        if self.best_state is not None:
            ckpt.save_weights(bundle_dir / "best-model.msgpack",
                              ckpt.to_flax_variables(self.best_state))
        if self.history:
            cols = list(self.history[0].keys())
            lines = [",".join(cols)] + [",".join(str(r[c]) for c in cols)
                                        for r in self.history]
            (bundle_dir / f"{cfg.description}_history.csv").write_text("\n".join(lines) + "\n")
        return bundle_dir


def train_model(cfg: TrainerConfig, trainer: Optional[Trainer] = None) -> Path:
    """Build a trainer (unless given), fit, export the bundle; returns the
    bundle directory."""
    trainer = trainer or Trainer(cfg)
    try:
        print(f"Train files: {trainer.dataset.n_train}, Test files: {trainer.dataset.n_valid}")
        print(f"Class weights: {trainer.class_weights}")
        trainer.fit()
        return trainer.export()
    finally:
        trainer.close()
