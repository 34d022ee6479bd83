"""The training engine: one-cycle fit of the U-Net on one device.

Counterpart of ``unet_tpu/train/loop.py`` for one device, in both
topologies (tpu_opt, the default, and parity, ``tpu_opt=False``; tiles
whose sides are not divisible by 4 fall back to parity before the model
is built, as the JAX trainer does), with or without self-attention:

* a train step = storage-dtype tiles to the device → augmentation
  (``augment_batch``: rot90, then one ``flip_scale`` launch that flips
  and scales, then the photometric passes) → per microbatch (``grad_accum``
  equal slices of the batch): bf16 forward in training mode (every
  BatchNorm through the ``bn_stats`` kernels at the microbatch's size,
  its running statistics advancing microbatch by microbatch) → the loss on
  the folded logits (tpu_opt) or the full-resolution ones (parity):
  class-weighted cross-entropy, focal, dice, or for ``regression`` (one
  output channel, float masks) MSE, L1 or smooth L1 on channel 0 →
  backward, the gradients summed in float32; then their mean goes to the
  fastai Adam under the one-cycle schedule, and the loss is the mean of
  the microbatch losses;
* validation after every epoch on full-resolution logits, with padded
  samples masked out: ``dice_multi``, or ``rmse`` and ``r2_score`` for
  regression, over the epoch;
* SaveModelCallback: the best epoch's weights (by ``monitor``) are kept and
  restored at the end;
* a CSVLogger-schema history (epoch, train_loss, valid_loss, the metrics,
  time) with fastai's smoothed train loss (β = 0.98);
* the LR finder (``lr_finder``: an exponential sweep on weights of its
  own, then ``fit`` starts from fresh weights of the seed at the suggested
  LR), transfer learning (``existing_model``: the bundle's topology and
  weights) and pretrained encoders (``pretrained_weights``, ``.pth`` or
  ``.npz``);
* a phase timer always on, and with ``profile_dir`` a ``torch.profiler``
  trace of the first epoch;
* ``export`` writes the bundle ``unet_tpu`` reads: ``<desc>.json``, flax
  msgpack weights, ``best-model.msgpack``, ``<desc>_history.csv``,
  ``<desc>_profile.txt`` and, after a sweep, ``<desc>_lr_find.csv``.

Resume and step checkpoints, multi-process training, the plots and the
model summary are not ported yet; ``TrainerConfig`` has no fields for
them.
"""

from __future__ import annotations

import math
import time
import warnings
from dataclasses import dataclass, field, replace
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..data import (NOOP_AUGMENT, AugmentConfig, TileDataset, TileLoader,
                    augment_batch, get_datatype, get_patch_size,
                    resolve_class_weights)
from ..models import TPU_OPT_TOPOLOGY_VERSION, build_unet, init_weights
from ..utils.device import resolve_device
from ..utils.profiling import StepTimer, device_trace
from . import checkpoint as ckpt
from . import metrics as M
from .losses import build_loss, fold_loss_layout
from .optimizer import OneCycleAdam, constant_lr_adam
from .schedule import SUGGESTERS, lr_finder_lrs, suggest_lr


@dataclass
class TrainerConfig:
    """The one-device part of ``unet_tpu.train.loop.TrainerConfig``, plus
    the ``device`` (default ``cuda``)."""

    data_path: Union[str, Path] = "."
    model_path: Union[str, Path] = "."
    description: str = "model"
    batch_size: int = 4
    epochs: int = 15
    lr: float = 1e-4
    arch: str = "xresnet34"
    codes: Sequence[str] = ("background", "foreground")
    regression: bool = False
    class_weights: Union[str, Sequence[float]] = "even"
    encoder_factor: float = 10.0
    lr_finder: Optional[str] = None
    loss_func: Optional[str] = None
    monitor: Optional[str] = None
    self_attention: bool = False
    valid_scenes: Sequence[str] = ("vali",)
    transforms: bool = True
    split_idx: Optional[int] = 0
    n_transform_imgs: float = 1.0
    aug: AugmentConfig = field(default_factory=AugmentConfig)
    existing_model: Optional[str] = None
    pretrained_weights: Optional[str] = None  # xresnet state_dict (.pth) or .npz
    info: str = ""
    class_zero: bool = False
    normalize: str = "reference"
    reference_quirks: bool = False
    tpu_opt: bool = True
    bf16: bool = True
    seed: int = 0
    loader_threads: int = 8
    # sequential microbatches a step: BatchNorm uses each microbatch's
    # statistics, the gradients average; batch_size must divide evenly
    grad_accum: int = 1
    profile_dir: Optional[str] = None  # torch.profiler trace of the first epoch
    device: str = "cuda"


def _monitor_defaults(monitor: Optional[str], regression: bool) -> Tuple[str, Callable]:
    """The monitored history column and its comparator, as the JAX
    trainer decides them: ``r2_score`` (regression) or ``dice_multi`` by
    default; the losses are minimized, every other monitor maximized (an
    unknown one with a warning)."""
    if monitor is None:
        monitor = "r2_score" if regression else "dice_multi"
    if monitor in ("train_loss", "valid_loss"):
        return monitor, np.less
    if monitor not in ("r2_score", "dice_multi", "rmse"):
        warnings.warn("Monitor not recognised. Assuming maximization.")
    return monitor, np.greater


def _fmt_time(seconds: float) -> str:
    s = int(round(seconds))
    return f"{s // 60:02d}:{s % 60:02d}"


LR_FIND_WINDOW = 10  # sweep losses fetched this many at a time, not a host sync a step


class Trainer:
    def __init__(self, cfg: TrainerConfig):
        if cfg.grad_accum > 1 and cfg.batch_size % cfg.grad_accum:
            raise ValueError(f"batch_size {cfg.batch_size} must divide into "
                             f"grad_accum={cfg.grad_accum} microbatches")
        if cfg.existing_model:
            # transfer learning: the bundle defines the architecture
            m = ckpt.load_manifest(ckpt.bundle_paths(cfg.existing_model)[1])
            adopted = {}
            for field_name, key in (("arch", "ARCHITECTURE"), ("tpu_opt", "tpu_opt"),
                                    ("self_attention", "self_attention")):
                v = m.get(key)
                if v is not None and getattr(cfg, field_name) != v:
                    adopted[field_name] = v
            if adopted:
                print(f"existing_model: adopting bundle topology {adopted}")
                cfg = replace(cfg, **adopted)
        self.cfg = cfg
        self.device = resolve_device(cfg.device)
        self.data_path = Path(cfg.data_path)
        self.dataset = TileDataset(self.data_path, valid_scenes=cfg.valid_scenes,
                                   regression=cfg.regression,
                                   reference_quirks=cfg.reference_quirks)
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
        self.n_out = 1 if cfg.regression else len(cfg.codes)
        if cfg.tpu_opt and (self.tile_hw[0] % 4 or self.tile_hw[1] % 4):
            # decided here, before the model is built, so the manifest
            # stamps the topology actually trained
            print(f"Tile size {self.tile_hw} not divisible by 4: tpu_opt "
                  "topology unavailable — using the parity topology "
                  "(tpu_opt=False). Pad tiles to a multiple of 4 to use the "
                  "TPU-optimized decoder.")
            cfg = self.cfg = replace(cfg, tpu_opt=False)
        self.model = build_unet(cfg.arch, n_out=self.n_out, c_in=self.c_in,
                                self_attention=cfg.self_attention, tpu_opt=cfg.tpu_opt,
                                dtype=torch.bfloat16 if cfg.bf16 else torch.float32)
        self.class_weights = resolve_class_weights(cfg.class_weights, cfg.codes,
                                                   self.data_path, cfg.regression,
                                                   reference_quirks=cfg.reference_quirks)
        weight = None if cfg.regression else torch.tensor(
            self.class_weights, dtype=torch.float32, device=self.device)
        self.loss_fn = build_loss(cfg.loss_func, weight, regression=cfg.regression)
        self.monitor, self.comp = _monitor_defaults(cfg.monitor, cfg.regression)
        self.aug_cfg = cfg.aug if cfg.transforms else NOOP_AUGMENT
        self.steps_per_epoch = len(self.train_loader)
        self.total_steps = self.steps_per_epoch * cfg.epochs
        self.history: List[Dict[str, Any]] = []
        self.optimizer: Optional[OneCycleAdam] = None
        self.best_state: Optional[Dict[str, torch.Tensor]] = None
        self.generator = torch.Generator().manual_seed(cfg.seed + 1)  # augmentation draws
        self.timer = StepTimer()
        self.lr_find_result: Optional[Dict[str, Any]] = None
        self._step_times: List[Any] = []  # per step: CUDA event pair or seconds

    def close(self) -> None:
        self.train_loader.close()
        self.valid_loader.close()

    # --- state ---------------------------------------------------------------

    def init_variables(self) -> Dict[str, Any]:
        """The flax ``{'params', 'batch_stats'}`` tree a run starts from:
        the existing model's weights, else ``init_weights`` from the
        config's seed with the pretrained encoder grafted in."""
        cfg = self.cfg
        if cfg.existing_model:
            return ckpt.load_weights(ckpt.bundle_paths(cfg.existing_model)[2])
        self.model.cpu()
        init_weights(self.model, torch.Generator().manual_seed(cfg.seed))
        variables = ckpt.to_flax_variables(self.model.state_dict())
        if cfg.pretrained_weights:
            from ..models.torch_import import load_encoder_any

            variables = load_encoder_any(variables, cfg.pretrained_weights, cfg.arch)
        return variables

    def set_weights(self, variables: Optional[Dict[str, Any]] = None) -> None:
        """Load a flax tree into the model (``init_variables()`` when none
        is given) and move it to the device."""
        if variables is None:
            variables = self.init_variables()
        self.model.cpu()
        sd = ckpt.from_flax_variables(variables)
        self.model.load_state_dict({k: torch.from_numpy(np.array(a, np.float32))
                                    for k, a in sd.items()}, strict=True)
        self.model.to(self.device)

    def init_state(self, variables: Optional[Dict[str, Any]] = None,
                   lr: Optional[float] = None) -> None:
        """Set the weights (``set_weights``) and start a fresh one-cycle
        optimizer at ``lr`` (default the config's)."""
        self.set_weights(variables)
        self.optimizer = OneCycleAdam(self.model.named_parameters(),
                                      self.cfg.lr if lr is None else lr, self.total_steps,
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
                             split=split, split_idx=cfg.split_idx,
                             reference_quirks=cfg.reference_quirks, **kwargs)

    def _preds(self, logits: torch.Tensor) -> torch.Tensor:
        """What the loss takes: the logits, or for regression channel 0."""
        return logits[:, 0] if self.cfg.regression else logits

    def loss_and_grads(self, images: torch.Tensor, masks: torch.Tensor) -> torch.Tensor:
        """Training-mode forward on scaled float images, the loss on the
        logits (in the folded layout where the model returns sub-pixel
        logits, tpu_opt; as they are where it returns full-resolution ones,
        parity), and its backward into the parameters' ``.grad``: per
        microbatch under ``grad_accum``, the gradients summed and divided
        by their count. Returns the mean loss."""
        self.model.train()
        params = list(self.model.parameters())
        for p in params:
            p.grad = None
        accum = max(1, self.cfg.grad_accum)
        losses = []
        for x, y in zip(images.chunk(accum), masks.chunk(accum)):
            logits = self.model(x, fold_logits=True)
            if logits.shape[-1] != y.shape[-1]:
                logits, y = fold_loss_layout(logits, y)
            loss = self.loss_fn(self._preds(logits), y)
            loss.backward()
            losses.append(loss.detach())
        if accum == 1:
            return losses[0]
        with torch.no_grad():
            for p in params:
                if p.grad is not None:
                    p.grad.div_(accum)
        return torch.stack(losses).sum() / accum

    def train_step(self, images: np.ndarray, masks: np.ndarray,
                   optimizer: Optional[OneCycleAdam] = None,
                   generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """One optimizer step on a host batch (the trainer's optimizer and
        augmentation draws unless given); returns the loss as a device
        scalar (not fetched, so steps queue without a host sync)."""
        if self.device.type == "cuda":
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
        else:
            t0 = time.perf_counter()
        x, y = self.augment(*self.to_device(images, masks), "train",
                            generator or self.generator)
        loss = self.loss_and_grads(x, y)
        (optimizer or self.optimizer).step()
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
        regression = self.cfg.regression
        state = (M.regression_init(self.device) if regression
                 else M.dice_multi_init(self.n_out, self.device))
        losses: List[torch.Tensor] = []
        counts: List[int] = []
        generator = torch.Generator().manual_seed(self.cfg.seed + 7)
        for images, masks, n_valid in self.valid_loader:
            x, y = self.augment(*self.to_device(images, masks), "valid", generator)
            sample_mask = torch.arange(x.shape[0], device=self.device) < n_valid
            preds = self._preds(self.model(x))
            losses.append(self.loss_fn(preds, y, sample_mask=sample_mask))
            state = (M.regression_update if regression else M.dice_multi_update)(
                state, preds, y, sample_mask)
            counts.append(n_valid)
        values = torch.stack(losses).cpu().tolist()
        out = {"valid_loss": sum(v * n for v, n in zip(values, counts)) / max(sum(counts), 1)}
        if regression:
            out.update(rmse=float(M.rmse_value(state)), r2_score=float(M.r2_value(state)))
        else:
            out["dice_multi"] = float(M.dice_multi_value(state))
        return out

    # --- fit -----------------------------------------------------------------------

    def fit(self) -> List[Dict[str, Any]]:
        """Train ``epochs`` epochs. With ``lr_finder`` the sweep runs first
        and the run starts from fresh weights at the suggested LR; else from
        the state ``init_state`` set (``init_state()`` when none is)."""
        cfg = self.cfg
        if cfg.lr_finder is not None:
            lr = self.lr_find(cfg.lr_finder)
            print(f"Optimized learning rate: {lr}")
            self.init_state(lr=lr)
        elif self.optimizer is None:
            self.init_state()
        best_metric = None
        smooth_loss, smooth_count, beta = 0.0, 0, 0.98  # fastai AvgSmoothLoss
        for epoch in range(cfg.epochs):
            t0 = time.monotonic()
            with device_trace(cfg.profile_dir if epoch == 0 else None, self.device,
                              f"{cfg.description}_epoch0"):
                losses = []
                batches = iter(self.train_loader)
                while True:
                    with self.timer.phase("h2d"):
                        batch = next(batches, None)
                    if batch is None:
                        break
                    with self.timer.phase("train_step"):
                        losses.append(self.train_step(*batch[:2]))
            with self.timer.phase("loss_fetch"):
                for loss in torch.stack(losses).cpu().tolist():
                    if math.isfinite(loss):
                        smooth_count += 1
                        smooth_loss = beta * smooth_loss + (1 - beta) * loss
            row: Dict[str, Any] = {
                "epoch": epoch,
                "train_loss": smooth_loss / (1 - beta ** max(smooth_count, 1))}
            with self.timer.phase("evaluate"):
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

    # --- lr finder -------------------------------------------------------------------

    def lr_find(self, method: str = "valley", num_it: int = 100,
                start_lr: float = 1e-7, end_lr: float = 10.0) -> float:
        """fastai lr_find: from ``init_variables()``, ``num_it`` steps of
        the constant-schedule Adam with the LR rising exponentially from
        ``start_lr`` to ``end_lr``, cycling the train loader; the losses
        are fetched ``LR_FIND_WINDOW`` at a time, a non-finite one counts as
        1e9, and the sweep stops once a loss exceeds 4× the best after 10.
        All four suggestions are kept in ``lr_find_result``; the one of
        ``method`` is returned. The sweep leaves the model's weights
        changed: ``fit`` sets fresh ones after it."""
        t0 = time.perf_counter()
        n_timed = len(self._step_times)
        self.set_weights()
        ratio = end_lr / start_lr

        def lr_fn(step: int) -> np.float32:  # float32, as the JAX package's schedule
            pos = np.float32(min(step, num_it - 1)) / np.float32(max(num_it - 1, 1))
            return np.float32(start_lr) * np.float32(ratio) ** pos

        optimizer = constant_lr_adam(self.model.named_parameters(), lr_fn)
        generator = torch.Generator().manual_seed(self.cfg.seed + 2)
        losses: List[float] = []
        window: List[torch.Tensor] = []
        best = math.inf

        def drain() -> bool:
            """Fetch the window's losses at once; True if the sweep diverged."""
            nonlocal best
            values = torch.stack(window).cpu().tolist()
            window.clear()
            for v in values:
                losses.append(v if math.isfinite(v) else 1e9)
                best = min(best, losses[-1])
                if losses[-1] > 4 * best and len(losses) > 10:  # fastai's stop
                    return True
            return False

        it, diverged = 0, False
        while it < num_it and not diverged:
            for images, masks, _ in self.train_loader:
                if it >= num_it:
                    break
                window.append(self.train_step(images, masks, optimizer, generator))
                it += 1
                if len(window) >= LR_FIND_WINDOW:
                    diverged = drain()
                    if diverged:
                        break
        if window and not diverged:
            drain()
        del self._step_times[n_timed:]  # step_ms() reports the fit's steps
        lrs = lr_finder_lrs(start_lr, end_lr, num_it)[:len(losses)]
        self.lr_find_result = {
            "lrs": [float(v) for v in lrs], "losses": losses, "method": method,
            "iterations": len(losses), "steps": it, "diverged": diverged,
            "suggestions": {m: suggest_lr(lrs, losses, m) for m in SUGGESTERS},
            "seconds": time.perf_counter() - t0}
        self.lr_find_result["lr"] = suggest_lr(lrs, losses, method)
        return self.lr_find_result["lr"]

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
            "enable_regression": cfg.regression,
            "LEARNING_RATE": cfg.lr,
            "LR_FINDER": cfg.lr_finder,
            "ENCODER_FACTOR": cfg.encoder_factor,
            "CLASS_WEIGHTS": cfg.class_weights if isinstance(cfg.class_weights, str)
            else list(cfg.class_weights),
            "loss_func": cfg.loss_func,
            "self_attention": cfg.self_attention,
            "monitor": self.monitor,
            "VALID_SCENES": list(cfg.valid_scenes),
            "ARCHITECTURE": cfg.arch,
            "CODES": list(cfg.codes),
            "n_transform_imgs": cfg.n_transform_imgs,
            "info": cfg.info,
            "class_zero": cfg.class_zero,
            "n_out": self.n_out,
            "c_in": self.c_in,
            "tpu_opt": cfg.tpu_opt,
            "tpu_opt_topology": TPU_OPT_TOPOLOGY_VERSION if cfg.tpu_opt else None,
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
        if self.timer.samples:
            (bundle_dir / f"{cfg.description}_profile.txt").write_text(
                self.timer.report() + "\n")
        if self.lr_find_result:
            r = self.lr_find_result
            lines = ["lr,loss"] + [f"{lr!r},{loss!r}" for lr, loss in zip(r["lrs"], r["losses"])]
            (bundle_dir / f"{cfg.description}_lr_find.csv").write_text("\n".join(lines) + "\n")
        return bundle_dir


def train_model(cfg: TrainerConfig, trainer: Optional[Trainer] = None) -> Path:
    """Build a trainer (unless given), fit, export the bundle; returns the
    bundle directory."""
    trainer = trainer or Trainer(cfg)
    try:
        print(f"Train files: {trainer.dataset.n_train}, Test files: {trainer.dataset.n_valid}")
        if not trainer.cfg.regression:
            print(f"Class weights: {trainer.class_weights}")
        trainer.fit()
        return trainer.export()
    finally:
        trainer.close()
