"""Training traffic: the trainer's step, epoch after epoch, fed by its tile
loader from uint8 GeoTIFF tiles on disk.

Set-up writes the mix's train and validation tiles from the seed, builds
one ``Trainer`` with the configuration's model, puts the seed's weights
in it, and drives it through its first three steps with the loader's
first batches, as a user's training does: the loader decides its
decoder on the first of them (the window's own call and feed): their losses, the first
gradient (from Adam's first moment after one step) and the parameters'
change over the three are kept. The window then goes on with the same
trainer, loader iteration and augmentation generator, one step after
another until ``seconds`` have passed, and waits for the card.

After the window the program is dropped and the float32 reference
(``reference/``) follows the same three steps from the generated arrays:
it identifies each tile the loader gave by its bytes, draws the same
flips from a generator of the same seed, and runs the forward, the loss,
the backward and Adam. Numbers read: the worst step's loss gap and the
first step's; the worst leaf's gap of the first gradient's norm and of the
change's norm, each relative to the reference leaf's norm or the median
leaf's, whichever is larger.
Leaves whose reference gradient is under a thousandth of the median
leaf's are left out. A cell compares those its file gives a limit.
"""

from __future__ import annotations

import hashlib
import math
import time
from types import SimpleNamespace
from typing import Dict, List

import numpy as np
import torch

from perfbench.harness import data, weights
from perfbench.harness.context import (Context, Marks, float32_exact, free, peak_bytes,
                                       reference_module, reset_peak, sync)
from perfbench.reference import train as rtrain

CHECKED_STEPS = 3
LEAF_FLOOR = 1e-3   # of the median leaf's reference gradient norm
TEMPER_TILES = 4


def _key(image: np.ndarray, mask: np.ndarray) -> bytes:
    return hashlib.blake2b(image.tobytes() + mask.tobytes(), digest_size=16).digest()


def _program(ctx: Context, tiles_dir, seed: int):
    from unet_tpu_torch.data import AugmentConfig
    from unet_tpu_torch.train.loop import Trainer, TrainerConfig

    cfg, p = ctx.config, ctx.mix["params"]
    return Trainer(TrainerConfig(
        data_path=tiles_dir, model_path=ctx.workdir / "models", description="perfbench",
        batch_size=p["batch"], epochs=p["epochs"], lr=p["lr"], arch=cfg["arch"],
        codes=cfg["codes"], class_weights=p["class_weights"],
        self_attention=cfg["self_attention"], tpu_opt=cfg["topology"] == "tpu_opt",
        bf16=cfg["dtype"] == "bfloat16", seed=seed, loader_threads=p["loader_threads"],
        aug=AugmentConfig(hflip_p=p["hflip_p"], vflip_p=p["vflip_p"]),
        device=str(ctx.device)))


def _norms(names, tensors) -> Dict[str, float]:
    return {n: float(t.double().norm()) for n, t in zip(names, tensors)}


def prepare(ctx: Context) -> SimpleNamespace:
    """Set-up: the tiles on disk, one trainer with the seed's weights, and
    its first ``CHECKED_STEPS`` steps with their readings."""
    cfg, p, dev = ctx.config, ctx.mix["params"], ctx.device
    data_seed, weight_seed, flip_seed, loader_seed = data.seeds(ctx.seed, 4)
    n_train, n_valid = p["train_tiles"], p["valid_tiles"]
    images, masks = data.labelled(data_seed, n_train + n_valid, p["tile"], p["tile"],
                                  cfg["bands"], cfg["classes"], dev)
    host_images, host_masks = images.cpu().numpy(), masks.cpu().numpy()
    del images, masks
    tiles_dir = ctx.workdir / "tiles"
    data.write_tiles(tiles_dir, "trai", host_images[:n_train], host_masks[:n_train])
    data.write_tiles(tiles_dir, "vali", host_images[n_train:], host_masks[n_train:])
    index = {_key(host_images[i], host_masks[i]): i for i in range(n_train)}

    state = train_state(ctx, weight_seed, host_images)
    trainer = _program(ctx, tiles_dir, loader_seed)
    trainer.init_state()
    trainer.model.load_state_dict(state, strict=True)
    opt = trainer.optimizer
    flips = torch.Generator().manual_seed(flip_seed)
    batches = iter(trainer.train_loader)

    p0 = [t.detach().clone() for t in opt.params]
    seen, losses, grad_norms = [], [], None
    for k in range(CHECKED_STEPS):
        imgs, msks, _ = next(batches)
        seen.append([index.get(_key(imgs[i], msks[i]), -1) for i in range(len(imgs))])
        losses.append(trainer.train_step(imgs, msks, generator=flips))
        if k == 0:
            b1 = float(opt.hypers(0)[1])
            grad_norms = {n: v / (1.0 - b1) for n, v in _norms(opt.names, opt.mu).items()}
    delta_norms = _norms(opt.names, [t.detach() - t0 for t, t0 in zip(opt.params, p0)])
    del p0
    return SimpleNamespace(
        trainer=trainer, batches=batches, flips=flips, flip_seed=flip_seed, state=state,
        host_images=host_images, host_masks=host_masks, seen=seen,
        readings={"loss": [float(v) for v in losses], "grad": grad_norms, "delta": delta_norms})


def measure(ctx: Context, s: SimpleNamespace) -> dict:
    """The window: steps until ``seconds`` have passed, then the card
    drained; the trainer is dropped after it."""
    dev, trainer, b = ctx.device, s.trainer, ctx.mix["params"]["batch"]
    n_before = len(trainer.step_ms())
    sync(dev)
    reset_peak(dev)
    marks = Marks(dev)
    losses = []
    t0 = time.perf_counter()
    setup_s = t0 - ctx.t_start
    marks.mark()
    while (elapsed := time.perf_counter() - t0) < ctx.seconds:
        ctx.tracer.boundary(elapsed)
        with ctx.spans("loader_next"):
            batch = next(s.batches, None)
            if batch is None:
                s.batches = iter(trainer.train_loader)
                batch = next(s.batches)
        with ctx.spans("train_step"):
            losses.append(trainer.train_step(batch[0], batch[1], generator=s.flips))
        marks.mark()
    sync(dev)
    window_s = time.perf_counter() - t0
    ctx.tracer.finish()
    steps = len(losses)
    failed = sum(not math.isfinite(v) for v in torch.stack(losses).cpu().tolist())
    ctx.record.update(step_ms=trainer.step_ms()[n_before:], steps=steps, batch=b,
                      tile=ctx.mix["params"]["tile"], window_s=window_s,
                      loader_path=trainer.train_loader.path,
                      first_batch_ms=trainer.train_loader.first_batch_ms)
    out = {"e2e": {"train_tiles_per_s": steps * b / window_s,
                   "train_step_p95_ms": float(np.percentile(marks.intervals_ms(), 95)),
                   "setup_s": setup_s},
           "attempted": steps, "failed": failed, "memory_peak_bytes": peak_bytes(dev)}
    drop(ctx, s)
    return out


def drop(ctx: Context, s: SimpleNamespace) -> None:
    """Free the program's state before the reference runs."""
    s.trainer.close()
    s.trainer = s.batches = None
    free(ctx.device)


def judge(ctx: Context, s: SimpleNamespace, leaves: bool = False) -> list:
    """The reference follows the checked steps; [(name, value)] of the
    numbers compared (``compare``)."""
    reference = follow(ctx, s.host_images, s.host_masks, s.seen, s.state, s.flip_seed)
    return compare(s.readings, reference, leaves)


def run(ctx: Context) -> dict:
    s = prepare(ctx)
    out = measure(ctx, s)
    out["checks"] = judge(ctx, s)
    return out


def train_state(ctx: Context, weight_seed: int, host_images: np.ndarray) -> dict:
    """The initial weights, on the host: the seed's, with the head tempered
    (``weights.temper_head``) over the first ``TEMPER_TILES`` training
    tiles in training mode."""
    cfg, dev = ctx.config, ctx.device
    with float32_exact():
        model = reference_module(cfg).UNet(cfg).to(dev).train()
        state = weights.make(model, weight_seed, dev)
        model.load_state_dict(state)
        x = torch.from_numpy(host_images[:TEMPER_TILES]).to(dev).float() * cfg["value_scale"]
        weights.temper_head(model, state, x)
    return {k: v.detach().cpu().clone() for k, v in state.items()}


def follow(ctx: Context, host_images: np.ndarray, host_masks: np.ndarray, seen,
           state: dict, flip_seed: int, quant=None) -> Dict[str, list]:
    """The reference's three steps on the tiles ``seen`` (indices into the
    generated arrays): losses, the first gradient's leaf norms, the
    change's leaf norms. ``quant="fp8"`` is the lower-precision control."""
    cfg, p, dev = ctx.config, ctx.mix["params"], ctx.device
    flat = [i for batch in seen for i in batch]
    if min(flat) < 0 or len(set(flat)) < len(flat):  # a tile not made here, or one twice
        return {"unknown_tile": True}
    n_train = p["train_tiles"]
    with float32_exact():
        model = reference_module(cfg).UNet(cfg, quant=quant).to(dev).train()
        model.load_state_dict(state)
        named = list(model.named_parameters())
        steps_per_epoch = n_train // p["batch"]
        opt = rtrain.OneCycleAdam(named, p["lr"], steps_per_epoch * p["epochs"],
                                  cfg["encoder_factor"])
        w = torch.tensor(rtrain.class_weights(host_masks[:n_train], cfg["classes"]),
                         dtype=torch.float32, device=dev)
        flips = torch.Generator().manual_seed(flip_seed)
        p0 = [t.detach().clone() for _, t in named]
        out = {"loss": []}
        for k, idx in enumerate(seen):
            hflip, vflip = rtrain.flip_draws(flips, len(idx), p["hflip_p"], p["vflip_p"])
            x, y = rtrain.augment(torch.from_numpy(host_images[idx]).to(dev),
                                  torch.from_numpy(host_masks[idx]).to(dev), hflip, vflip,
                                  cfg["value_scale"])
            for _, t in named:
                t.grad = None
            loss = rtrain.weighted_cross_entropy(model(x), y, w)
            loss.backward()
            out["loss"].append(float(loss.detach()))
            if k == 0:
                out["grad"] = _norms(opt.names, [t.grad for _, t in named])
            opt.step()
        out["delta"] = _norms(opt.names, [t.detach() - t0 for (_, t), t0 in zip(named, p0)])
    return out


def relative_gaps(prog: Dict[str, float], ref: Dict[str, float], keep: List[str]):
    """(gap, leaf) of the worst kept leaf: |‖prog‖ − ‖ref‖| over max(‖ref‖,
    the median kept leaf's ‖ref‖); a leaf the program lacks counts as
    infinite."""
    median = float(np.median([ref[n] for n in keep]))
    return max((abs(prog.get(n, math.inf) - ref[n]) / max(ref[n], median), n) for n in keep)


def median_gap(prog: Dict[str, float], ref: Dict[str, float], keep: List[str]) -> float:
    """The median kept leaf's gap, measured as ``relative_gaps`` measures
    each."""
    median = float(np.median([ref[n] for n in keep]))
    return float(np.median([abs(prog.get(n, math.inf) - ref[n]) / max(ref[n], median)
                            for n in keep]))


def kept_leaves(reference: dict) -> List[str]:
    """The leaves compared: a reference gradient of at least ``LEAF_FLOOR``
    of the median leaf's."""
    median = float(np.median(list(reference["grad"].values())))
    return [n for n, g in reference["grad"].items() if g >= LEAF_FLOOR * median]


def compare(program: dict, reference: dict, leaves: bool = False) -> list:
    """[(name, value)] of the numbers compared (limits come from the cell);
    with ``leaves`` each gap's worst leaf follows its value."""
    if reference.get("unknown_tile"):
        return [("tiles_known", math.inf)]
    gaps = [abs(a - r) / abs(r) for a, r in zip(program["loss"], reference["loss"])]
    keep = kept_leaves(reference)
    out = [("loss_gap", (max(gaps), None)), ("loss1_gap", (gaps[0], None)),
           ("grad_gap", relative_gaps(program["grad"], reference["grad"], keep)),
           ("delta_gap", relative_gaps(program["delta"], reference["delta"], keep))]
    return [(k, v if leaves else v[0]) for k, v in out]


def explain(program: dict, reference: dict) -> dict:
    """What the limits were chosen from, beyond ``compare``: each step's
    loss gap and the median leaf's gaps."""
    keep = kept_leaves(reference)
    out = {"loss_steps": [abs(a - r) / abs(r) for a, r in zip(program["loss"],
                                                             reference["loss"])]}
    for key in ("grad", "delta"):
        out[f"{key}_median_leaf"] = median_gap(program[key], reference[key], keep)
    return out
