"""Validation figures: the tile-majority confusion matrix and
classification report of a predicted tile folder.

Counterpart of ``unet_tpu/predict/figures.py`` (the reference's
predict.py:56-143 ``plot_valid_predict``): each tile's majority class
(``argmax(bincount(...))``) in the prediction and in its ground-truth mask,
then the confusion matrix and the classification report, printed and
returned, and drawn as seaborn heatmaps into ``<output>/Valid_figures/``.
Merge and regression modes are refused, as in the reference
(predict.py:57-60).

The numbers need no sklearn or pandas: ``confusion_matrix`` and
``classification_report`` compute what sklearn's functions of those names
return for these inputs (labels the sorted union of truth and prediction,
``zero_division=1``, ``digits=2``), the report laid out character for
character as sklearn 1.9 lays it out. Only the two PNGs need matplotlib,
seaborn and pandas, imported when drawing; without them the figures are
skipped with one line naming what is missing.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import List, Sequence, Tuple

import numpy as np

from ..geo import read_raster
from ..utils.plots import missing_modules

HEADERS = ("precision", "recall", "f1-score", "support")


def confusion_matrix(y_true: Sequence[int], y_pred: Sequence[int]
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """(labels, cm): the sorted union of the labels, and the int64 counts
    with the truth in rows and the prediction in columns."""
    y_true, y_pred = np.asarray(y_true), np.asarray(y_pred)
    labels = np.union1d(y_true, y_pred)
    cm = np.zeros((len(labels), len(labels)), np.int64)
    np.add.at(cm, (np.searchsorted(labels, y_true), np.searchsorted(labels, y_pred)), 1)
    return labels, cm


def _divide(num: np.ndarray, den: np.ndarray, zero_division: float) -> np.ndarray:
    num = np.asarray(num, np.float64)
    den = np.array(den, np.float64)
    zero = den == 0
    den[zero] = 1
    out = num / den
    out[zero] = zero_division
    return out


def classification_report(y_true: Sequence[int], y_pred: Sequence[int],
                          zero_division: float = 1, digits: int = 2
                          ) -> Tuple[str, List[dict]]:
    """(text, rows): the report's text and one row a label (``class``,
    ``precision``, ``recall``, ``f1_score``, ``support``). Per label:
    precision tp / predicted, recall tp / true, F1 2·tp / (true +
    predicted), ``zero_division`` where a denominator is 0; then the
    accuracy row (micro F1), the macro average and the average weighted by
    support."""
    labels, cm = confusion_matrix(y_true, y_pred)
    tp, pred_sum, true_sum = np.diag(cm), cm.sum(axis=0), cm.sum(axis=1)
    if not tp.any():
        # sklearn counts in float when no prediction is right, and then
        # prints the supports as floats ("1.0")
        tp, pred_sum, true_sum = (a.astype(np.float64) for a in (tp, pred_sum, true_sum))

    def scores(tp, pred_sum, true_sum):
        return (_divide(tp, pred_sum, zero_division), _divide(tp, true_sum, zero_division),
                _divide(2.0 * tp, true_sum + pred_sum, zero_division))

    p, r, f1 = scores(tp, pred_sum, true_sum)
    micro = scores(np.array([tp.sum()]), np.array([pred_sum.sum()]), np.array([true_sum.sum()]))
    names = [str(label) for label in labels]
    n = true_sum.sum()
    width = max(max(len(name) for name in names), len("weighted avg"), digits)
    row_fmt = "{:>{width}s} " + " {:>9.{digits}f}" * 3 + " {:>9}\n"
    text = ("{:>{width}s} " + " {:>9}" * len(HEADERS)).format("", *HEADERS, width=width)
    text += "\n\n"
    for row in zip(names, p, r, f1, true_sum):
        text += row_fmt.format(*row, width=width, digits=digits)
    text += "\n"
    text += ("{:>{width}s} " + " {:>9.{digits}}" * 2 + " {:>9.{digits}f}" + " {:>9}\n").format(
        "accuracy", "", "", micro[2][0], n, width=width, digits=digits)
    text += row_fmt.format("macro avg", *(float(np.nanmean(a)) for a in (p, r, f1)), n,
                           width=width, digits=digits)
    text += row_fmt.format("weighted avg",
                           *(float(np.average(a, weights=true_sum)) for a in (p, r, f1)), n,
                           width=width, digits=digits)
    rows = [{"class": name, "precision": float(pv), "recall": float(rv),
             "f1_score": float(fv), "support": int(s)}
            for name, pv, rv, fv, s in zip(names, p, r, f1, true_sum)]
    return text, rows


def tile_majorities(output_folder, predict_path, class_zero: bool = False
                    ) -> Tuple[List[int], List[int]]:
    """(y_true, y_pred): the majority class of each predicted ``*.tif`` in
    ``output_folder`` that has a mask of its name beside ``predict_path``
    (``img_tiles`` → ``mask_tiles``), in name order. With ``class_zero``
    tiles whose mask is mostly 0 (nodata) are dropped and the mask's
    classes shifted down by one, as the predicted tiles were."""
    truth_dir = Path(str(predict_path).replace("img_tiles", "mask_tiles"))
    y_true, y_pred = [], []
    for file_name in sorted(os.listdir(output_folder)):
        if not file_name.endswith(".tif"):
            continue
        true_path = truth_dir / file_name
        if not true_path.exists():
            continue
        pred_data = read_raster(Path(output_folder) / file_name).data[0].astype(np.int64)
        true_data = read_raster(true_path).data[0].astype(np.int64)
        pred_class = int(np.argmax(np.bincount(pred_data.ravel())))
        true_class = int(np.argmax(np.bincount(true_data.ravel())))
        if class_zero:
            if true_class == 0:
                continue
            true_class -= 1
        y_true.append(true_class)
        y_pred.append(pred_class)
    return y_true, y_pred


def _draw(valid_path: Path, cm: np.ndarray, rows: List[dict]) -> None:
    """The two heatmaps, drawn as the JAX package draws them."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    import pandas as pd

    df = pd.DataFrame(rows)
    class_names = [row["class"] for row in rows]
    valid_path.mkdir(parents=True, exist_ok=True)
    try:
        import seaborn as sns

        plt.figure(figsize=(10, 7))
        sns.heatmap(df.set_index("class"), annot=True, fmt=".2f", cmap="crest")
        plt.title("Classification Report")
        plt.savefig(valid_path / "classification_report.png")
        plt.close()

        plt.figure(figsize=(10, 7))
        sns.heatmap(cm, annot=True, fmt="d", cmap="crest",
                    xticklabels=class_names, yticklabels=class_names)
        plt.xlabel("Predicted")
        plt.ylabel("True")
        plt.title("Confusion Matrix")
        plt.savefig(valid_path / "Confusion_Matrix.png")
        plt.close()
    except Exception as e:  # figures are best-effort; the numbers are returned
        print(f"Figure rendering failed: {e}")


def plot_valid_predict(
    output_folder: str,
    predict_path: str,
    regression: bool = False,
    merge: bool = False,
    class_zero: bool = False,
) -> Tuple[np.ndarray, str]:
    """(cm, report) of the predicted tiles in ``output_folder`` against the
    masks beside ``predict_path``; both printed, and drawn into
    ``<output_folder>/Valid_figures/`` where the plotting packages are
    installed. Raises ``ValueError`` for merged tiles, regression, or no
    tile with a mask."""
    if merge:
        raise ValueError("It's not possible to calculate the confusion matrix with merged tiles")
    if regression:
        raise ValueError("This function is just for classification problems")

    y_true, y_pred = tile_majorities(output_folder, predict_path, class_zero)
    if not y_true:
        raise ValueError("No valid tiles found for evaluation")
    _, cm = confusion_matrix(y_true, y_pred)
    class_report, rows = classification_report(y_true, y_pred, zero_division=1)

    valid_path = Path(output_folder) / "Valid_figures"
    missing = missing_modules("matplotlib", "seaborn", "pandas")
    if missing:
        print(f"{valid_path}: figures skipped, {', '.join(missing)} not installed")
    else:
        _draw(valid_path, cm, rows)

    print("Confusion Matrix:")
    print(cm)
    print("\nClassification Report:")
    print(class_report)
    return cm, class_report
