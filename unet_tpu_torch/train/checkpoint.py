"""Model bundles: the same directory layout and files ``unet_tpu train``
writes, read and written without JAX.

    <model_path>/<description>/
        <description>.json     run manifest (everything needed to rebuild)
        <description>.msgpack  {params, batch_stats} in flax msgpack

Weights carry over between the flax tree and a torch ``state_dict`` with
``from_flax_variables`` / ``to_flax_variables`` (numpy arrays throughout):
conv kernels HWIO ↔ OIHW, BatchNorm scale/bias/mean/var ↔
weight/bias/running_mean/running_var, the transposed-conv kernel
(kh, kw, in, out) ↔ (in, out, kh, kw) flipped in both spatial dims (flax's
``ConvTranspose`` does not flip its kernel; torch's transposed conv does),
and SelfAttention's ``*_kernel`` and ``gamma`` params and ``*_u``
batch_stats as they are (parameters and buffers of the same names).
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Dict, Mapping, Tuple, Union

import numpy as np
import torch

from ..io import msgpack_codec
from ..models.unet import TPU_OPT_TOPOLOGY_VERSION, build_unet


def save_manifest(path: Union[str, Path], manifest: Dict[str, Any]) -> None:
    def conv(o):
        if isinstance(o, np.integer):
            return int(o)
        if isinstance(o, np.floating):
            return float(o)
        return str(o)

    Path(path).write_text(json.dumps(manifest, indent=4, default=conv))


def load_manifest(path: Union[str, Path]) -> Dict[str, Any]:
    p = Path(path)
    if not p.exists():
        raise FileNotFoundError(f"JSON file not found: {p}")
    return json.loads(p.read_text())


def bundle_paths(bundle: Union[str, Path]) -> Tuple[Path, Path, Path]:
    """(dir, manifest.json, weights.msgpack) for a bundle dir, its manifest,
    its weights or a ``<description>.pkl`` path."""
    p = Path(bundle)
    if p.is_dir():
        return p, p / f"{p.name}.json", p / f"{p.name}.msgpack"
    return p.parent, p.parent / f"{p.stem}.json", p.parent / f"{p.stem}.msgpack"


def save_weights(path: Union[str, Path], variables: Dict[str, Any]) -> None:
    Path(path).write_bytes(msgpack_codec.serialize(variables))


def load_weights(path: Union[str, Path]) -> Dict[str, Any]:
    return msgpack_codec.restore(Path(path).read_bytes())


def export_bundle(bundle_dir: Union[str, Path], description: str,
                  variables: Dict[str, Any], manifest: Dict[str, Any]) -> Path:
    """Write a bundle; ``variables`` is the flax tree of numpy arrays
    (``to_flax_variables(model.state_dict())`` for a port model)."""
    d = Path(bundle_dir)
    d.mkdir(parents=True, exist_ok=True)
    save_manifest(d / f"{description}.json", manifest)
    save_weights(d / f"{description}.msgpack", variables)
    return d


def _walk(tree: Mapping[str, Any], prefix: Tuple[str, ...] = ()):
    """(path, module dict) for every dict holding array leaves."""
    leaves = {k: v for k, v in tree.items() if not isinstance(v, Mapping)}
    if leaves:
        yield prefix, leaves
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _walk(v, prefix + (k,))


def from_flax_variables(tree: Mapping[str, Any]) -> Dict[str, np.ndarray]:
    """flax ``{'params', 'batch_stats'}`` → torch state_dict (numpy)."""
    sd: Dict[str, np.ndarray] = {}
    for path, leaves in _walk(tree.get("params", {})):
        key = ".".join(path)
        if "scale" in leaves:  # BatchNorm
            sd[f"{key}.weight"] = np.asarray(leaves["scale"])
            sd[f"{key}.bias"] = np.asarray(leaves["bias"])
            continue
        if "kernel" not in leaves:  # SelfAttention: *_kernel and gamma
            sd.update({".".join((*path, k)): np.asarray(a) for k, a in leaves.items()})
            continue
        k = np.asarray(leaves["kernel"])
        if path[-1] == "convt":
            sd[f"{key}.weight"] = np.ascontiguousarray(
                k.transpose(2, 3, 0, 1)[:, :, ::-1, ::-1])
        else:
            sd[f"{key}.weight"] = np.ascontiguousarray(k.transpose(3, 2, 0, 1))
        if "bias" in leaves:
            sd[f"{key}.bias"] = np.asarray(leaves["bias"])
    for path, leaves in _walk(tree.get("batch_stats", {})):
        key = ".".join(path)
        if "mean" not in leaves:  # SelfAttention's power-iteration vectors
            sd.update({".".join((*path, k)): np.asarray(a) for k, a in leaves.items()})
            continue
        sd[f"{key}.running_mean"] = np.asarray(leaves["mean"])
        sd[f"{key}.running_var"] = np.asarray(leaves["var"])
    return sd


def _set(tree: Dict[str, Any], path, leaf, value) -> None:
    for p in path:
        tree = tree.setdefault(p, {})
    tree[leaf] = value


def to_flax_variables(state_dict: Mapping[str, Any]) -> Dict[str, Any]:
    """torch state_dict (tensors or numpy) → flax ``{'params',
    'batch_stats'}`` tree of float32 numpy arrays, copies that later
    changes to the tensors leave alone."""
    bn_modules = {k.rsplit(".", 1)[0] for k in state_dict
                  if k.endswith(".running_mean")}
    params: Dict[str, Any] = {}
    stats: Dict[str, Any] = {}
    for key, v in state_dict.items():
        a = v.detach().cpu().numpy().copy() if isinstance(v, torch.Tensor) else np.array(v)
        mod, _, name = key.rpartition(".")
        path = mod.split(".") if mod else []
        if mod in bn_modules:
            if name in ("running_mean", "running_var"):
                _set(stats, path, name[len("running_"):], a)
            else:
                _set(params, path, "scale" if name == "weight" else "bias", a)
        elif name == "weight":
            if path[-1] == "convt":
                k = a[:, :, ::-1, ::-1].transpose(2, 3, 0, 1)
            else:
                k = a.transpose(2, 3, 1, 0)
            _set(params, path, "kernel", np.ascontiguousarray(k))
        elif name.endswith("_u"):  # SelfAttention's power-iteration vectors
            _set(stats, path, name, a)
        else:
            _set(params, path, name, a)
    return {"params": params, "batch_stats": stats}


def load_bundle(bundle: Union[str, Path], best: bool = False,
                dtype: torch.dtype = torch.bfloat16):
    """(model, manifest): the eval-mode U-Net of the topology the manifest
    records (tpu_opt, or parity when ``tpu_opt`` is false or absent, as the
    JAX loader reads it) with the bundle's weights (on the CPU, float32
    parameters, computing in ``dtype``)."""
    d, manifest_path, weights_path = bundle_paths(bundle)
    manifest = load_manifest(manifest_path)
    tpu_opt = bool(manifest.get("tpu_opt", False))
    v = manifest.get("tpu_opt_topology", 1)
    if tpu_opt and v != TPU_OPT_TOPOLOGY_VERSION:
        raise ValueError(
            f"Bundle {d} was trained with tpu_opt topology v{v}; this "
            f"build uses v{TPU_OPT_TOPOLOGY_VERSION} (parameter shapes "
            "differ). Retrain, or load with the matching framework version. "
            "(The parity topology, tpu_opt=False, is stable across versions.)")
    best_path = d / "best-model.msgpack"
    if best and best_path.exists():
        weights_path = best_path
    model = build_unet(
        arch=manifest["ARCHITECTURE"],
        n_out=int(manifest["n_out"]),
        c_in=int(manifest["number_of_bands"]),
        self_attention=bool(manifest.get("self_attention", False)),
        tpu_opt=tpu_opt,
        dtype=dtype,
    )
    sd = from_flax_variables(load_weights(weights_path))
    model.load_state_dict({k: torch.from_numpy(np.array(a, np.float32))
                           for k, a in sd.items()}, strict=True)
    return model, manifest
