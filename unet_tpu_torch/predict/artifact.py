"""Serving artifacts: the prediction program, exported and frozen.

Counterpart of ``unet_tpu/predict/artifact.py``. The artifact is the
scaled-input → probabilities forward (``predict.make_probs_fn``) captured
with ``torch.export`` and stored next to the raw weight arrays:

* **No model-building code at load time.** ``load_artifact`` never calls
  ``build_unet`` or ``load_bundle``: the program is a frozen graph of ATen
  operations, so a change of topology that invalidates bundles leaves an
  artifact serving.
* **No pickle.** The container is a plain ``.npz`` read with
  ``allow_pickle=False``, and the program archive is refused unless it
  holds no pickled weights, constants or sample inputs, so nothing in it
  can execute on load.
* **Both platforms.** The header lists where the artifact may load
  (``cpu``, ``cuda``, default both); the program is moved to the device it
  is loaded on (``torch.export.passes.move_to_device_pass``), whichever it
  was exported on.
* **Symbolic batch.** The batch dimension is a ``torch.export.Dim``, so
  any batch size runs through one program.

Weights ride OUTSIDE the program, as call inputs, rather than as constants
of the graph: at full width they are ~145 MB that would otherwise be
serialized into the program archive, and as inputs they live in device
memory like any other tensor.

Container layout (one ``.npz`` file, numpy's zip format)::

    __utaot__   uint8[]  header JSON: format, patch size, bands, n_out,
                         regression/scale/codes, topology and BatchNorm
                         variant, torch version, compute dtype,
                         platforms, leaf names, quantization
    __program__ uint8[]  the torch.export program archive
    w00000...   ndarray  weight leaves in state_dict order
    s00000...   float32  int8 artifacts: the scales of the quantized
                         leaves, in order

The exported call is ``fn(weights, scales, x)`` with ``x`` raw tile
values, float32 (B, H, W, C); the dtype scaling (``data.augment.
image_scale``) is inside, and the result is (B, n_out, H, W)
probabilities, or (B, 1, H, W) values for a regression model. A port
artifact (format ``utaot-torch-v1``) and a ``unet_tpu`` artifact
(``utaot-v1``, a StableHLO program) do not load in each other's package;
bundles do.
"""

from __future__ import annotations

import io
import json
import zipfile
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ..data.augment import image_scale
from ..utils.device import resolve_device
from ..utils.profiling import DeviceSpans, StepTimer
from .predict import BatchPredictor, make_probs_fn

MAGIC = "utaot-torch-v1"
JAX_MAGIC = "utaot-v1"
PLATFORMS = ("cpu", "cuda")
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _quantizable(leaf: np.ndarray) -> bool:
    """Weight-quantization policy: float tensors with a real contraction
    (conv kernels, attention projections; ndim >= 2). Biases and BatchNorm
    scale/bias/mean/var leaves are tiny and precision-critical: float32."""
    return np.issubdtype(np.asarray(leaf).dtype, np.floating) and np.ndim(leaf) >= 2


def _quantize_leaf(leaf: np.ndarray, axis: int = -1) -> Tuple[np.ndarray, np.ndarray]:
    """Per-output-channel symmetric int8 quantization over ``axis``:
    scale = max|w| / 127 (1 where that is 0), values rint(w / scale) in
    [-127, 127]. Returns (int8 values, float32 scales shaped to broadcast
    against them)."""
    a = np.asarray(leaf, np.float32)
    axis = axis % a.ndim
    amax = np.max(np.abs(a), axis=tuple(d for d in range(a.ndim) if d != axis),
                  keepdims=True)
    scales = (amax / 127.0).astype(np.float32)
    scales = np.where(scales == 0, 1.0, scales)
    q = np.clip(np.rint(a / scales), -127, 127).astype(np.int8)
    return q, scales


def output_axes(model: nn.Module) -> Dict[str, int]:
    """The output-channel axis of every quantizable state_dict leaf of
    ``model``: 0 for a conv kernel (O, I, kh, kw), 1 for a transposed conv
    (I, O, kh, kw) and for an attention projection (in, out) — the axes
    that map onto the last axis of the JAX package's HWIO / IO kernels."""
    axes = {}
    for prefix, mod in model.named_modules():
        for name, t in list(mod.named_parameters(recurse=False)) + \
                list(mod.named_buffers(recurse=False)):
            key = f"{prefix}.{name}" if prefix else name
            if t.dim() < 2 or not t.is_floating_point():
                continue
            if isinstance(mod, nn.ConvTranspose2d) or name.endswith("_kernel"):
                axes[key] = 1
            elif isinstance(mod, nn.Conv2d):
                axes[key] = 0
            else:
                raise ValueError(f"{key}: no output-channel axis known for a "
                                 f"{type(mod).__name__} leaf of shape {tuple(t.shape)}")
    return axes


class _Program(nn.Module):
    """The function an artifact freezes: ``forward(weights, scales, x)``
    runs ``model`` with ``weights`` in place of its state (dequantizing the
    int8 leaves by their ``scales`` first) on the scaled (B, C, H, W)
    transpose of the raw (B, H, W, C) tiles ``x``. The model is held
    outside the module tree, so no weight of it enters the program."""

    def __init__(self, model: nn.Module, names: Sequence[str],
                 quantized: Sequence[bool], scale: float, regression: bool):
        super().__init__()
        self.__dict__["model"] = model
        self.names, self.quantized, self.scale = list(names), list(quantized), scale
        self.probs_fn = make_probs_fn(self._model_call, regression)
        self._state: Dict[str, torch.Tensor] = {}

    def _model_call(self, x, fold_logits=False):
        return torch.func.functional_call(self.model, self._state, (x,),
                                          {"fold_logits": fold_logits})

    def forward(self, weights: List[torch.Tensor], scales: List[torch.Tensor],
                x: torch.Tensor) -> torch.Tensor:
        it = iter(scales)
        self._state = {n: w.to(torch.float32) * next(it) if q else w
                       for n, w, q in zip(self.names, weights, self.quantized)}
        try:
            return self.probs_fn(x.permute(0, 3, 1, 2) * self.scale)
        finally:
            self._state = {}


def export_artifact(bundle: str, out_path: str,
                    platforms: Sequence[str] = PLATFORMS,
                    patch_size: Optional[int] = None,
                    quantize: Optional[str] = None,
                    dtype: torch.dtype = torch.bfloat16,
                    device="cuda") -> Path:
    """Export a trained bundle as a frozen serving artifact.

    The bundle's model is loaded on ``device`` computing in ``dtype`` (the
    header records it; bf16 is what ``Predictor`` computes in on the card)
    and its forward exported there. ``patch_size`` overrides the
    manifest's tile size: the spatial dims are static in the program, one
    artifact per tile size; the batch dim is symbolic. ``platforms`` lists
    the devices the artifact may load on.

    ``quantize="int8"``: per-output-channel symmetric int8 weights (the
    conv and attention kernels ship as int8 plus float32 channel scales and
    are dequantized on the device inside the program; biases, BatchNorm
    leaves and the attention's u vectors stay float32), the JAX package's
    policy: the artifact and the weights' device memory shrink ~4x while
    the compute stays in ``dtype``."""
    from ..train.checkpoint import load_bundle

    if quantize not in (None, "int8"):
        raise ValueError(f"quantize must be None or 'int8', got {quantize!r}")
    platforms = list(platforms)
    bad = [p for p in platforms if p not in PLATFORMS]
    if bad or not platforms:
        raise ValueError(f"platforms {platforms!r}: each must be one of {', '.join(PLATFORMS)}")
    if dtype not in _DTYPES.values():
        raise ValueError(f"dtype {dtype}: float32 or bfloat16")
    device = resolve_device(device)
    model, manifest = load_bundle(bundle, dtype=dtype)
    model.to(device)
    regression = bool(manifest.get("enable_regression", False))
    dtype_str = manifest.get("dtype_str", "int8")
    normalize = manifest.get("normalize", "reference")
    scale = image_scale(dtype_str, normalize)
    patch = int(patch_size or manifest["patch_size"])
    bands = int(manifest["number_of_bands"])

    state = {n: t.detach().cpu().numpy() for n, t in model.state_dict().items()}
    names = list(state)
    quantized = [quantize == "int8" and _quantizable(a) for a in state.values()]
    axes = output_axes(model) if quantize else {}
    stored, scales = [], []
    for n, q in zip(names, quantized):
        if q:
            qv, s = _quantize_leaf(state[n], axes[n])
            stored.append(qv)
            scales.append(s)
        else:
            stored.append(state[n])
    program = _Program(model, names, quantized, scale, regression)
    batch = torch.export.Dim("batch", min=1)
    example = ([torch.from_numpy(a).to(device) for a in stored],
               [torch.from_numpy(s).to(device) for s in scales],
               torch.zeros((2, patch, patch, bands), dtype=torch.float32, device=device))
    with torch.no_grad():
        exported = torch.export.export(
            program, example,
            dynamic_shapes=([None] * len(stored), [None] * len(scales), {0: batch}))
    exported.example_inputs = None  # else the archive holds every weight, pickled
    buf = io.BytesIO()
    torch.export.save(exported, buf)

    header = {
        "format": MAGIC,
        "patch_size": patch,
        "number_of_bands": bands,
        "n_out": int(manifest["n_out"]),
        "enable_regression": regression,
        "dtype_str": dtype_str,
        "normalize": normalize,
        "scale": scale,
        "codes": manifest.get("codes"),
        "description": manifest.get("description"),
        "ARCHITECTURE": manifest.get("ARCHITECTURE"),
        "tpu_opt": bool(manifest.get("tpu_opt", False)),
        "self_attention": bool(manifest.get("self_attention", False)),
        "bn_variant": model.bn_variant,
        "platforms": platforms,
        "torch_version": torch.__version__,
        "dtype": str(dtype).replace("torch.", ""),
        "n_leaves": len(stored),
        "leaves": names,
        "quantize": quantize,
        "quantized": [i for i, q in enumerate(quantized) if q],
    }
    members = {
        "__utaot__": np.frombuffer(json.dumps(header).encode("utf-8"), dtype=np.uint8),
        "__program__": np.frombuffer(buf.getvalue(), dtype=np.uint8),
    }
    members.update({f"w{i:05d}": a for i, a in enumerate(stored)})
    members.update({f"s{i:05d}": s for i, s in enumerate(scales)})
    out = Path(out_path)
    out.parent.mkdir(parents=True, exist_ok=True)
    with open(out, "wb") as f:
        np.savez(f, **members)
    return out


def is_artifact(path) -> bool:
    """True for a serving artifact (an ``.npz`` holding ``__utaot__``),
    of either package, as against a model bundle."""
    p = Path(str(path))
    if not p.is_file():
        return False
    try:
        with np.load(p, allow_pickle=False) as z:
            return "__utaot__" in z.files
    except (OSError, ValueError):
        return False


def _check_archive(program: bytes, path) -> None:
    """Refuse a program archive that carries pickled data: weights,
    constants or sample inputs, which ``torch.export.load`` would
    unpickle."""
    with zipfile.ZipFile(io.BytesIO(program)) as z:
        for name in z.namelist():
            data = z.read(name)
            if "/data/sample_inputs/" in name and data:
                raise ValueError(f"{path}: the program carries sample inputs")
            if "/data/weights/" in name or "/data/constants/" in name:
                if not name.endswith("_config.json") or json.loads(data).get("config"):
                    raise ValueError(f"{path}: the program carries weights or constants")


def _read(path) -> Tuple[dict, bytes, list, list]:
    """(header, program bytes, weight leaves, scales) of a port artifact;
    ``ValueError`` for a JAX artifact or an unknown format."""
    try:
        with np.load(Path(path), allow_pickle=False) as z:
            header = json.loads(bytes(z["__utaot__"]).decode("utf-8"))
            fmt = header.get("format")
            if fmt == JAX_MAGIC:
                raise ValueError(
                    f"{path} is a unet_tpu artifact (a StableHLO program for JAX); "
                    "export the bundle for this package: python -m unet_tpu_torch "
                    "export <bundle> <artifact>")
            if fmt != MAGIC:
                raise ValueError(f"{path}: unknown artifact format {fmt!r}")
            program = bytes(z["__program__"])
            leaves = [z[f"w{i:05d}"] for i in range(int(header["n_leaves"]))]
            scales = [z[f"s{i:05d}"] for i in range(len(header["quantized"]))]
    except (KeyError, UnicodeDecodeError, json.JSONDecodeError, AttributeError) as e:
        raise ValueError(f"{path}: not a readable serving artifact ({e})") from None
    return header, program, leaves, scales


class ArtifactPredictor(BatchPredictor):
    """A ``predict.Predictor`` over a frozen artifact: the same
    ``predict_batch_device`` / ``predict_batch`` / ``forward_ms`` /
    ``manifest`` / ``scenes`` surface, so ``predict_raster`` (every tier),
    ``predict_raster_streamed``, ``serve_scenes`` and ``save_predictions``
    take one through ``predictor=``.

    The weights move to ``device`` once; the program runs there in the
    header's compute dtype on tiles cast to float32 on the device. ``tta``
    composes outside the program (flip → call → unflip → mean), as in the
    JAX package."""

    def __init__(self, path: str, batch_size: int = 16, tta: bool = False,
                 device="cuda"):
        self.device = resolve_device(device)
        header, program, leaves, scales = _read(path)
        if self.device.type not in header["platforms"]:
            raise ValueError(f"{path} was exported for {', '.join(header['platforms'])}, "
                             f"not {self.device.type}")
        if header["torch_version"].split("+")[0] != torch.__version__.split("+")[0]:
            raise ValueError(
                f"{path} was written with torch {header['torch_version']}, this is "
                f"torch {torch.__version__}: export the bundle again with this version")
        from torch.export.passes import move_to_device_pass

        _check_archive(program, path)
        exported = torch.export.load(io.BytesIO(program))
        self._program = move_to_device_pass(exported, self.device).module()
        self.manifest = header
        self.dtype = _DTYPES[header["dtype"]]
        self.regression = bool(header["enable_regression"])
        self.scale = float(header["scale"])
        self.batch_size = batch_size
        self.tta = bool(tta)
        self._weights = [torch.from_numpy(a).to(self.device) for a in leaves]
        self._scales = [torch.from_numpy(s).to(self.device) for s in scales]
        self._forwards = DeviceSpans(self.device)
        self.timer = StepTimer()
        self.scenes: List[dict] = []

    def _call(self, x: torch.Tensor) -> torch.Tensor:
        return self._program(self._weights, self._scales, x)

    def _forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, n_out, H, W) of raw (B, H, W, C) device tiles; with ``tta``
        the mean over the identity and the three flips, summed in
        ``predict.tta_probs_fn``'s order."""
        x = x.to(torch.float32)
        acc = self._call(x)
        if not self.tta:
            return acc
        for dims_in, dims_out in (((2,), (3,)), ((1,), (2,)), ((1, 2), (2, 3))):
            acc = acc + torch.flip(self._call(torch.flip(x, dims_in)), dims_out)
        return acc / 4


def load_artifact(path: str, batch_size: int = 16, tta: bool = False,
                  device="cuda") -> ArtifactPredictor:
    return ArtifactPredictor(path, batch_size=batch_size, tta=tta, device=device)
