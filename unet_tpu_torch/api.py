"""Public parameter surface + stage dispatcher.

Counterpart of ``unet_tpu/api.py`` (the reference's params_and_main.py):
the same knob names and defaults, the same three-stage ``Create_tiles /
Train / Predict`` dispatch, the same two-tier parameter semantics ("extra"
parameters reset to hard-coded defaults unless ``enable_extra_parameters``
is set), the list-broadcast multi-run entry point and the JSON-config front
door, plus the ``device`` (default ``cuda``). Before any stage runs,
``main`` and ``main_multi`` refuse, by name, each field whose feature is
not ported yet (``check_ported``), so a JSON config does not fail only
after training. With ``spatial`` = N > 1 and no process group, each
starts N ranks (``parallel.mesh.launch``), one a card, that run it in a
group: rank 0 tiles, every rank trains and predicts on its rows, rank 0
writes.
"""

from __future__ import annotations

import dataclasses
import json
import time
import warnings
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, Optional, Sequence, Union

from .data.augment import AugmentConfig
from .parallel import mesh
from .predict.artifact import is_artifact
from .tiling import split_raster
from .train.loop import TrainerConfig, train_model
from .utils.device import resolve_device
from .utils.multirun import broadcast


@dataclass
class Params:
    """Every user-facing knob, named as in params_and_main.py:22-118."""

    # stage switches (params_and_main.py:22-24)
    Create_tiles: bool = False
    Train: bool = False
    Predict: bool = False

    # tiling (params_and_main.py:31-38)
    image_path: Optional[str] = None
    mask_path: Optional[str] = None
    base_dir: Optional[str] = None
    patch_size: int = 400
    patch_overlap: float = 0.0
    split: Sequence[float] = (0.8, 0.2)

    # training (params_and_main.py:46-62)
    data_path: Optional[str] = None
    model_path: Optional[str] = None
    description: str = "model"
    info: str = ""
    existing_model: Optional[str] = None
    pretrained_weights: Optional[str] = None  # torch xresnet state_dict (.pth)
    BATCH_SIZE: int = 4
    EPOCHS: int = 15
    LEARNING_RATE: float = 0.0001
    enable_regression: bool = False
    visualize_data_example: bool = True
    export_model_summary: bool = True
    CODES: Sequence[str] = ("NO_Data", "Background", "Class_1")
    CLASS_WEIGHTS: Union[str, Sequence[float]] = "even"

    # prediction (params_and_main.py:67-73)
    predict_path: Optional[str] = None
    predict_model: Optional[str] = None
    AOI: Optional[str] = None
    year: Optional[str] = None
    merge: bool = False
    regression: bool = False
    validation_vision: bool = True

    # extra parameters (params_and_main.py:81-104)
    enable_extra_parameters: bool = False
    self_attention: bool = False
    ENCODER_FACTOR: float = 10.0
    LR_FINDER: Optional[str] = None
    VALID_SCENES: Sequence[str] = ("vali",)
    loss_func: Optional[str] = None
    monitor: Optional[str] = None
    all_classes: bool = False
    specific_class: Optional[int] = None
    large_file: bool = False
    max_empty: float = 0.2
    class_zero: bool = False
    ARCHITECTURE: str = "xresnet34"
    transforms: bool = True
    split_idx: Optional[int] = 0
    n_transform_imgs: float = 1.0
    aug_pipe: AugmentConfig = field(default_factory=AugmentConfig)

    # the JAX package's own knobs (no reference equivalent)
    normalize: str = "reference"
    reference_quirks: bool = False
    tpu_opt: bool = True
    bf16: bool = True
    seed: int = 0
    predict_batch_size: int = 16
    checkpoint_every: int = 0
    resume: bool = False
    spatial: int = 1  # shard tile height over N ranks (parallel/mesh.py)
    tta: bool = False
    grad_accum: int = 1
    tile_compress: Optional[str] = None
    predict_compress: Optional[str] = None

    # the port's own
    device: str = "cuda"


def apply_extra_parameter_gate(p: Params) -> Params:
    """params_and_main.py:130-146: without ``enable_extra_parameters``,
    reset the expert knobs to hard-coded defaults (and warn otherwise)."""
    if p.enable_extra_parameters:
        warnings.warn(
            "Extra parameters are enabled. Code may behave in unexpected ways. "
            "Please disable unless experienced with the code."
        )
        return p
    return dataclasses.replace(
        p,
        ENCODER_FACTOR=10.0,
        LR_FINDER=None,
        VALID_SCENES=("vali",),
        loss_func=None,
        monitor=None,
        all_classes=False,
        specific_class=None,
        enable_regression=False,
        large_file=False,
        max_empty=0.9,
        ARCHITECTURE="xresnet34",
        self_attention=False,
    )


def trainer_config(p: Params) -> TrainerConfig:
    return TrainerConfig(
        data_path=p.data_path,
        model_path=p.model_path,
        description=p.description,
        batch_size=p.BATCH_SIZE,
        epochs=p.EPOCHS,
        lr=p.LEARNING_RATE,
        arch=p.ARCHITECTURE,
        codes=list(p.CODES),
        regression=p.enable_regression,
        class_weights=p.CLASS_WEIGHTS,
        encoder_factor=p.ENCODER_FACTOR,
        lr_finder=p.LR_FINDER,
        loss_func=p.loss_func,
        monitor=p.monitor,
        self_attention=p.self_attention,
        valid_scenes=list(p.VALID_SCENES),
        transforms=p.transforms,
        split_idx=p.split_idx,
        n_transform_imgs=p.n_transform_imgs,
        aug=p.aug_pipe,
        existing_model=p.existing_model,
        pretrained_weights=p.pretrained_weights,
        export_model_summary=p.export_model_summary,
        visualize_data_example=p.visualize_data_example,
        info=p.info,
        class_zero=p.class_zero,
        normalize=p.normalize,
        reference_quirks=p.reference_quirks,
        tpu_opt=p.tpu_opt,
        bf16=p.bf16,
        seed=p.seed,
        checkpoint_every=p.checkpoint_every,
        resume=p.resume,
        spatial=p.spatial,
        grad_accum=p.grad_accum,
        device=p.device,
    )


def check_ported(p: Params) -> None:
    """Raise ``NotImplementedError`` naming every field of ``p`` that asks
    for a feature the port does not have yet."""
    refused = []
    models = p.predict_model if isinstance(p.predict_model, (list, tuple)) else [p.predict_model]
    if p.Predict and any(m is not None and is_artifact(m) for m in models):
        refused.append("a .uta predict_model (the Predict stage loads a model bundle, "
                       "as in unet_tpu; serve an artifact with python -m unet_tpu_torch "
                       "predict or serve)")
    if refused:
        raise NotImplementedError("not yet ported: " + "; ".join(refused))


def _start(p: Params) -> Params:
    """The gate, the refusals and the device, before any stage runs."""
    p = apply_extra_parameter_gate(p)
    check_ported(p)
    dev = resolve_device(p.device)
    import torch

    print(f"Devices: {[torch.cuda.get_device_name(i) for i in range(torch.cuda.device_count())]}"
          if dev.type == "cuda" else "Devices: ['cpu'] (asked for)")
    return p


def _launched(entry: str, p: Params) -> bool:
    """With ``spatial`` > 1 and no process group: run ``entry`` (``main``
    or ``main_multi``) in ``p.spatial`` ranks and return True (a rank's
    failure raises ``RuntimeError``); else False."""
    import torch.distributed as dist

    if p.spatial <= 1 or dist.is_initialized():
        return False
    check_ported(apply_extra_parameter_gate(p))
    code = mesh.launch(p.spatial, f"unet_tpu_torch.api:{entry}", (p,), device=p.device)
    if code:
        raise RuntimeError(f"spatial={p.spatial}: a rank exited with code {code}")
    return True


def _barrier() -> None:
    """Every rank of the process group (if any) waits here."""
    import torch.distributed as dist

    if dist.is_initialized():
        dist.barrier()


def _tile(p: Params, image_path, mask_path, base_dir) -> None:
    """One scene's tiles; under a process group rank 0 writes them."""
    if not mesh.is_primary():
        return
    split_raster(
        path_to_raster=image_path,
        path_to_mask=mask_path,
        patch_size=p.patch_size,
        patch_overlap=p.patch_overlap,
        base_dir=base_dir,
        split=list(p.split),
        max_empty=p.max_empty,
        class_zero=p.class_zero,
        seed=p.seed,
        reference_quirks=p.reference_quirks,
        compress=p.tile_compress,
    )


def main(p: Params) -> None:
    """Stage dispatcher (params_and_main.py:121-180)."""
    if _launched("main", p):
        return
    start_time = time.time()
    p = _start(p)

    if p.Create_tiles:
        _tile(p, p.image_path, p.mask_path, p.base_dir)
        _barrier()

    if p.Train:
        train_model(trainer_config(p))
        _barrier()  # rank 0 has written the bundle the Predict stage loads

    if p.Predict:
        from .predict.predict import save_predictions

        save_predictions(
            p.predict_model,
            p.predict_path,
            p.regression,
            p.merge,
            p.all_classes,
            p.specific_class,
            p.large_file,
            p.AOI,
            p.year,
            p.validation_vision,
            class_zero=p.class_zero,
            batch_size=p.predict_batch_size,
            spatial=p.spatial,
            tta=p.tta,
            reference_quirks=p.reference_quirks,
            out_compress=p.predict_compress,
            device=p.device,
        )

    elapsed = time.time() - start_time
    print(f"The operation took {elapsed:.2f} seconds or {elapsed / 60:.2f} minutes")


def main_multi(p: Params) -> None:
    """Multi-run entry point (create_tiles_train_predict_multi.py):
    list-valued paths/params are broadcast to a common length and looped."""
    if _launched("main_multi", p):
        return
    start_time = time.time()
    p = _start(p)

    if p.Create_tiles:
        image_paths = p.image_path if isinstance(p.image_path, (list, tuple)) else [p.image_path]
        n = len(image_paths)
        for img, msk, base in zip(image_paths, broadcast(p.mask_path, n),
                                  broadcast(p.base_dir, n)):
            _tile(p, img, msk, base)
        _barrier()

    if p.Train:
        model_paths = p.model_path if isinstance(p.model_path, (list, tuple)) else [p.model_path]
        n = len(model_paths)
        fields = ["data_path", "description", "existing_model", "BATCH_SIZE", "EPOCHS",
                  "LEARNING_RATE", "CLASS_WEIGHTS", "ARCHITECTURE", "CODES",
                  "enable_regression", "LR_FINDER", "monitor", "loss_func"]
        cols = {f: broadcast(getattr(p, f), n) for f in fields}
        for i, model_path in enumerate(model_paths):
            run = dataclasses.replace(
                p, model_path=model_path,
                **{f: cols[f][i] for f in fields},
            )
            train_model(trainer_config(run))
        _barrier()

    if p.Predict:
        from .predict.predict import save_predictions

        models = p.predict_model if isinstance(p.predict_model, (list, tuple)) else [p.predict_model]
        n = len(models)
        paths = broadcast(p.predict_path, n)
        merges = broadcast(p.merge, n)
        all_cls = broadcast(p.all_classes, n)
        # JAX's multi-run predicts on a data-parallel mesh (no spatial, the
        # call as JAX makes it); the ranks of a spatial run share each
        # forward, so they pass it on
        spatial = {"spatial": p.spatial} if p.spatial > 1 else {}
        for model, path, merge, ac in zip(models, paths, merges, all_cls):
            save_predictions(model, path, p.regression, merge, ac, p.specific_class,
                             p.large_file, p.AOI, p.year, p.validation_vision,
                             class_zero=p.class_zero, batch_size=p.predict_batch_size,
                             reference_quirks=p.reference_quirks,
                             out_compress=p.predict_compress, device=p.device, **spatial)

    elapsed = time.time() - start_time
    print(f"The operation took {elapsed:.2f} seconds or {elapsed / 60:.2f} minutes")


def params_from_json(path: Union[str, Path]) -> Params:
    """Load a Params config from JSON (field names as in the dataclass)."""
    raw: Dict[str, Any] = json.loads(Path(path).read_text())
    aug = raw.pop("aug_pipe", None)
    known = {f.name for f in dataclasses.fields(Params)}
    unknown = set(raw) - known
    if unknown:
        raise ValueError(f"Unknown parameters in {path}: {sorted(unknown)}")
    p = Params(**raw)
    if aug is not None:
        p.aug_pipe = AugmentConfig(**aug)
    return p
