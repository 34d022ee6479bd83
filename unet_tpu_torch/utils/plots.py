"""Plot helpers: batch histograms, loss curves with min annotation, the LR
finder's curve.

Counterpart of ``unet_tpu/utils/plots.py`` (the reference's utils.py:58-69
``annot_min``, utils.py:120-143 ``visualize_data`` and the loss-plot
assembly at train.py:253-281): the same figures, sizes, dpi and styling, so
on the same inputs and the same matplotlib each PNG is byte-equal to the
JAX package's. matplotlib (Agg) is imported when a function is called, not
when this module is: the port runs where matplotlib is not installed, and
callers skip a figure there (``missing_modules``).
"""

from __future__ import annotations

import importlib
from pathlib import Path
from typing import List, Sequence

import numpy as np


def missing_modules(*names: str) -> List[str]:
    """The modules of ``names`` that cannot be imported here."""
    out = []
    for name in names:
        try:
            importlib.import_module(name)
        except ImportError:
            out.append(name)
    return out


def _pyplot():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def annot_min(y: Sequence[float], ax=None) -> None:
    """Arrow annotation at the lowest loss point, with utils.py:58-69's
    label format, box and arrow styling and anchor position."""
    plt = _pyplot()
    curve = np.asarray(y)
    best_ep = int(curve.argmin())
    ax = ax or plt.gca()
    ax.annotate(
        f"Lowest Loss={float(curve[best_ep]):.2f}, Ep. {best_ep}",
        xy=(best_ep, float(curve[best_ep])),
        xytext=(0.06, 0.96),
        xycoords="data",
        textcoords="axes fraction",
        ha="left",
        va="top",
        bbox={"boxstyle": "square,pad=0.3", "fc": "w", "ec": "k", "lw": 0.72},
        arrowprops={"arrowstyle": "->",
                    "connectionstyle": "angle,angleA=0,angleB=120"},
    )


def visualize_data_path(inputs: np.ndarray, model_path) -> Path:
    """The PNG ``visualize_data`` writes for ``inputs``: an image batch of
    several bands gets ``*_image_plot.png``, anything else (a mask batch,
    a one-band image batch) ``*_mask_plot.png``."""
    several = np.ndim(inputs) == 4 and np.shape(inputs)[-1] > 1
    return Path(str(model_path).rsplit(".", 1)[0]
                + ("_image_plot.png" if several else "_mask_plot.png"))


def visualize_data(inputs: np.ndarray, model_path) -> Path:
    """Per-band histograms of a sample batch (utils.py:120-143): an image
    batch (B, H, W, C), bands last as the JAX loader gives them, or a mask
    batch (B, H, W), into ``visualize_data_path(inputs, model_path)``."""
    plt = _pyplot()
    inputs = np.asarray(inputs)
    is_image = inputs.ndim == 4
    n_bands = inputs.shape[-1] if is_image else 1
    out = visualize_data_path(inputs, model_path)
    fig, axes = plt.subplots(nrows=2, ncols=max(n_bands, 1), sharey="row", figsize=(10, 10))
    if is_image and n_bands > 1:
        for band in range(n_bands):
            band_data = inputs[..., band].ravel()
            axes[0, band].hist(band_data[band_data > 0], bins=255)
            axes[0, band].set_title(f"Band {band + 1}")
            axes[1, band].hist(band_data[band_data > 0], bins=255, range=(0, 1))
        plt.suptitle("Image batch example histogram")
    else:
        flat = inputs.ravel()
        ax0 = axes[0] if np.ndim(axes) == 1 else axes[0, 0]
        ax1 = axes[1] if np.ndim(axes) == 1 else axes[1, 0]
        ax0.hist(flat, bins=255)
        ax1.hist(flat, bins=255, range=(0, 1))
        plt.suptitle("Mask batch example histogram")
    plt.savefig(out)
    plt.close(fig)
    return out


def plot_lr_find(
    lrs: Sequence[float], losses: Sequence[float], suggestions: dict, out_path
) -> Path:
    """Loss-vs-LR curve of an LR-finder sweep with suggester markers: raw
    and smoothed loss on a log-x LR axis, one marker per suggester at its
    suggested LR (the figure fastai's ``learn.lr_find`` draws for
    utils.py:150-167)."""
    from ..train.schedule import _smooth

    plt = _pyplot()
    lrs = np.asarray(lrs, dtype=np.float64)
    losses = np.asarray(losses, dtype=np.float64)
    smoothed = _smooth(losses)
    plt.figure(figsize=(7, 5))
    plt.plot(lrs, losses, color="#bbbbbb", lw=0.8, label="loss")
    plt.plot(lrs, smoothed, color="#1f77b4", lw=1.6, label="smoothed loss")
    markers = {"minimum": "o", "steep": "s", "valley": "^", "slide": "D"}
    for name, lr in suggestions.items():
        # marker y: smoothed loss at the sweep point nearest the suggestion
        idx = int(np.argmin(np.abs(np.log(lrs) - np.log(max(lr, 1e-12)))))
        plt.plot([lr], [smoothed[idx]], markers.get(name, "x"), ms=8,
                 label=f"{name}: {lr:.2e}")
    plt.xscale("log")
    plt.xlabel("Learning rate")
    plt.ylabel("Loss")
    # divergence blows the y-range; clamp to the informative region
    finite = smoothed[np.isfinite(smoothed)]
    if finite.size:
        plt.ylim(float(finite.min()) * 0.9 - 1e-6, float(np.median(finite)) * 3 + 1e-6)
    plt.title("LR finder")
    plt.legend(fontsize=8)
    out = Path(str(out_path))
    plt.savefig(out, dpi=150, bbox_inches="tight")
    plt.close()
    return out


def plot_training_overview(history: List[dict], monitor: str, out_path) -> Path:
    """Loss plot with lowest-loss annotation (train.py:264-281)."""
    plt = _pyplot()
    valid_loss = [h["valid_loss"] for h in history]
    plt.figure(figsize=(7, 7))
    plt.plot(valid_loss, label="Validation")
    if monitor not in ("train_loss", "valid_loss"):
        train_loss = [h["train_loss"] for h in history]
        plt.plot(train_loss, label="Training")
        annot_min(train_loss)
        plt.ylim(0, float(np.max(train_loss)) * 1.3)
    else:
        annot_min(valid_loss)
        plt.ylim(0, 1.1)
    plt.xlabel("Episode")
    plt.ylabel("Loss")
    plt.title("Model Training Overview")
    plt.legend()
    out = Path(str(out_path))
    plt.savefig(out, dpi=200)
    plt.close()
    return out
