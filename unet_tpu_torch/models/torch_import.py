"""Import torch/fastai weights: a pretrained xresnet encoder, or a whole
fastai-trained DynamicUnet as a model bundle.

Counterpart of ``unet_tpu/models/torch_import.py``.

Pretrained encoders (the reference's ``pretrained=True``): a fastai
``xresnet{18,34,50,101}`` ``state_dict`` saved with ``torch.save`` is
converted (``convert_xresnet_state_dict``) and grafted into a U-Net's flax
variables (``load_encoder``): every ``stem_*`` layer is lenient and keeps
its fresh init where a shape differs (the multispectral first conv, and the
whole tpu_opt folded stem), the residual stages graft strictly.
``import_weights_cli`` writes the converted encoder as an ``.npz`` (keys
``p/...``, ``s/...`` and ``__arch__``, the JAX package's layout, so one
file serves both packages); ``load_encoder_any`` grafts from either file.

The reference exports whole trained Learners; the torch-free migration
path is one line on any machine that can load one::

    torch.save(load_learner("model.pkl").model.state_dict(), "model_sd.pth")

then ``python -m unet_tpu_torch import-model model_sd.pth <bundle>``
writes the prediction-ready bundle both packages read, with the manifest
fields the JAX package writes. Layer indices mirror fastai's DynamicUnet
ModuleList (SequentialEx):

    layers.0 encoder • 1 BatchNorm • 2 ReLU • 3 middle_conv (2 ConvLayers) •
    4.. UnetBlocks • [PixelShuffle_ICNR] • ResizeToOrig • MergeLayer •
    ResBlock (last_cross) • ConvLayer (head)

with the reference's ``norm_type=NormType`` class quirk: decoder
ConvLayers carry a conv bias and no norm. The imported model is the parity
topology (``tpu_opt: false``), with self-attention when the state_dict has
it. Conversion is numpy only; the state_dict is read with
``torch.load(..., weights_only=True)``.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ..train.checkpoint import export_bundle, from_flax_variables, to_flax_variables
from ..utils.device import resolve_device
from .unet import build_unet
from .xresnet import ARCHS


def _conv(w) -> np.ndarray:
    """torch OIHW → flax HWIO."""
    return np.transpose(np.asarray(w), (2, 3, 1, 0))


def _bn(prefix: str, sd: Dict[str, Any]) -> Tuple[Dict, Dict]:
    """A BatchNorm's (params, batch_stats) from keys ``{prefix}.weight`` and
    so on (``weight`` and so on for an empty prefix)."""
    p = f"{prefix}." if prefix else ""
    params = {"scale": np.asarray(sd[f"{p}weight"]), "bias": np.asarray(sd[f"{p}bias"])}
    stats = {"mean": np.asarray(sd[f"{p}running_mean"]),
             "var": np.asarray(sd[f"{p}running_var"])}
    return params, stats


def convert_xresnet_state_dict(sd: Dict[str, Any], arch: str = "xresnet34"
                               ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """A fastai xresnet ``state_dict`` (numpy values) → (params,
    batch_stats) of the encoder: stem ConvLayers at sequential indices
    0..2, stage s at 4 + s (3 is the max pool), each block's convpath convs
    → conv1/conv2[/conv3], its idpath conv → idconv."""
    expansion, layers = ARCHS[arch]
    params: Dict[str, Any] = {}
    stats: Dict[str, Any] = {}
    for i in range(3):
        p, s = _bn(f"{i}.1", sd)
        params[f"stem_{i}"] = {"conv": {"kernel": _conv(sd[f"{i}.0.weight"])}, "bn": p}
        stats[f"stem_{i}"] = {"bn": s}
    n_convs = 2 if expansion == 1 else 3
    for s_idx, n_blocks in enumerate(layers):
        seq = 4 + s_idx
        for b in range(n_blocks):
            name = f"stage_{s_idx}_block_{b}"
            block: Dict[str, Any] = {}
            bstat: Dict[str, Any] = {}
            for c in range(n_convs):
                base = f"{seq}.{b}.convpath.{c}"
                p, st = _bn(f"{base}.1", sd)
                block[f"conv{c + 1}"] = {"conv": {"kernel": _conv(sd[f"{base}.0.weight"])},
                                         "bn": p}
                bstat[f"conv{c + 1}"] = {"bn": st}
            # idpath = [AvgPool?][ConvLayer]: the conv is the module with weights
            for id_idx in (0, 1):
                key = f"{seq}.{b}.idpath.{id_idx}.0.weight"
                if key in sd:
                    p, st = _bn(f"{seq}.{b}.idpath.{id_idx}.1", sd)
                    block["idconv"] = {"conv": {"kernel": _conv(sd[key])}, "bn": p}
                    bstat["idconv"] = {"bn": st}
            params[name] = block
            stats[name] = bstat
    return params, stats


def _copy_tree(tree: Dict[str, Any]) -> Dict[str, Any]:
    """New dicts all the way down, the same leaves."""
    return {k: _copy_tree(v) if isinstance(v, dict) else v for k, v in tree.items()}


def load_encoder(variables: Dict[str, Any], sd: Dict[str, Any],
                 arch: str = "xresnet34") -> Dict[str, Any]:
    """A copy of the U-Net's flax ``variables`` with the converted encoder
    of the xresnet ``state_dict`` ``sd`` (numpy values) grafted in."""
    enc_params, enc_stats = convert_xresnet_state_dict(sd, arch)
    return _graft_encoder(_copy_tree(variables), enc_params, enc_stats)


def _graft_encoder(new_vars: Dict[str, Any], enc_params: Dict[str, Any],
                   enc_stats: Dict[str, Any]) -> Dict[str, Any]:
    tgt_p = new_vars["params"]["encoder"]
    tgt_s = new_vars["batch_stats"]["encoder"]
    skipped = []
    for name, block in enc_params.items():
        # stem_* keeps its fresh init where a shape differs (stem_0 on the
        # input channels, the whole tpu_opt folded stem); the stages are strict
        lenient = name.startswith("stem_")
        n_skip = _graft(tgt_p[name], block, allow_mismatch=lenient)
        n_skip += _graft(tgt_s[name], enc_stats[name], allow_mismatch=lenient)
        if n_skip:
            skipped.append(name)
    if skipped:
        print(f"pretrained: kept fresh init for mismatched stem layers "
              f"{skipped} (multispectral swap / tpu_opt folded stem); "
              "residual stages grafted")
    return new_vars


def _graft(target: Dict, source: Dict, allow_mismatch: bool) -> int:
    """Copy the source leaves into ``target`` in its dtypes; returns the
    number skipped for a shape mismatch (raises unless ``allow_mismatch``)."""
    skipped = 0
    for k, v in source.items():
        if isinstance(v, dict):
            skipped += _graft(target[k], v, allow_mismatch)
        elif np.shape(target[k]) != np.shape(v):
            if not allow_mismatch:
                raise ValueError(
                    f"Shape mismatch for {k}: {np.shape(target[k])} vs {np.shape(v)}")
            skipped += 1
        else:
            target[k] = np.asarray(v, dtype=np.asarray(target[k]).dtype)
    return skipped


def _flatten_tree(tree: Dict[str, Any], prefix: str = "") -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            out.update(_flatten_tree(v, key))
        else:
            out[key] = np.asarray(v)
    return out


def _unflatten_tree(flat: Dict[str, np.ndarray]) -> Dict[str, Any]:
    tree: Dict[str, Any] = {}
    for key, v in flat.items():
        parts = key.split("/")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return tree


def save_converted(path: str, params: Dict[str, Any], stats: Dict[str, Any],
                   arch: str) -> None:
    """Write converted encoder weights as an ``.npz`` archive."""
    flat = {f"p/{k}": v for k, v in _flatten_tree(params).items()}
    flat.update({f"s/{k}": v for k, v in _flatten_tree(stats).items()})
    flat["__arch__"] = np.asarray(arch)
    np.savez(path, **flat)


def load_converted(path: str) -> Tuple[Dict[str, Any], Dict[str, Any], str]:
    """Read a converted ``.npz`` archive → (params, stats, arch)."""
    with np.load(path) as z:
        arch = str(z["__arch__"])
        p = {k[2:]: z[k] for k in z.files if k.startswith("p/")}
        s = {k[2:]: z[k] for k in z.files if k.startswith("s/")}
    return _unflatten_tree(p), _unflatten_tree(s), arch


def _load_state_dict(path: str) -> Dict[str, np.ndarray]:
    sd = torch.load(path, map_location="cpu", weights_only=True)
    return {k: v.numpy() for k, v in sd.items()}


def load_encoder_any(variables: Dict[str, Any], path: str,
                     arch: str = "xresnet34") -> Dict[str, Any]:
    """Graft pretrained encoder weights from a torch ``state_dict``
    (``.pth``/``.pt``) or a converted ``.npz`` (whose arch must be
    ``arch``)."""
    if str(path).endswith(".npz"):
        enc_params, enc_stats, saved_arch = load_converted(path)
        if saved_arch != arch:
            raise ValueError(f"Converted weights are for {saved_arch}, model is {arch}")
        return _graft_encoder(_copy_tree(variables), enc_params, enc_stats)
    return load_encoder(variables, _load_state_dict(path), arch)


def import_weights_cli(src: str, out: str, arch: str = "xresnet34") -> str:
    """``python -m unet_tpu_torch import-weights``: ``.pth`` → ``.npz``."""
    params, stats = convert_xresnet_state_dict(_load_state_dict(src), arch)
    save_converted(out, params, stats, arch)
    n = sum(v.size for v in _flatten_tree(params).values())
    print(f"Converted {arch} encoder ({n / 1e6:.1f}M params) -> {out}")
    return out


def _infer_arch(enc_sd: Dict[str, Any]) -> str:
    """The xresnet variant from the encoder's key structure."""
    stages = []
    expansion = 1
    s = 0
    while f"{4 + s}.0.convpath.0.0.weight" in enc_sd:
        b = 0
        while f"{4 + s}.{b}.convpath.0.0.weight" in enc_sd:
            b += 1
        if f"{4 + s}.0.convpath.2.0.weight" in enc_sd:
            expansion = 4
        stages.append(b)
        s += 1
    for name, (exp, layers) in ARCHS.items():
        if exp == expansion and tuple(layers) == tuple(stages):
            return name
    raise ValueError(
        f"Encoder structure (expansion {expansion}, stages {stages}) matches "
        f"no known architecture; options: {sorted(ARCHS)}")


def _bias_conv(g: Dict[str, Any], prefix: str) -> Dict[str, Any]:
    """A norm-broken decoder ConvLayer: conv with bias, keys {prefix}.0.*."""
    return {"conv": {"kernel": _conv(g[f"{prefix}.0.weight"]),
                     "bias": np.asarray(g[f"{prefix}.0.bias"])}}


def _sa_group(g: Dict[str, Any], prefix: str) -> Tuple[Dict, Dict]:
    """fastai SelfAttention under ConvLayer xtra (keys {prefix}.{query,key,
    value}.0): spectral-normed 1-d convs store ``weight_orig`` (out, in, 1)
    and the power-iteration buffers; the port keeps the transposed kernel
    (in, out) and the ``u`` vector."""
    params: Dict[str, Any] = {"gamma": np.asarray(g[f"{prefix}.gamma"]).reshape(1)}
    stats: Dict[str, Any] = {}
    for name in ("query", "key", "value"):
        w = np.asarray(g[f"{prefix}.{name}.0.weight_orig"])
        params[f"{name}_kernel"] = w[:, :, 0].T
        stats[f"{name}_u"] = np.asarray(g[f"{prefix}.{name}.0.weight_u"])
    return params, stats


def convert_unet_state_dict(sd: Dict[str, Any], arch: Optional[str] = None
                            ) -> Tuple[Dict[str, Any], Dict[str, Any], Dict[str, Any]]:
    """A fastai DynamicUnet ``state_dict`` (numpy values) → (params,
    batch_stats, meta) of the parity DynamicUnet; ``meta`` holds the
    inferred arch, c_in, n_out, self_attention and the number of blocks."""
    groups: Dict[int, Dict[str, Any]] = {}
    for k, v in sd.items():
        if not k.startswith("layers."):
            raise ValueError(
                "Not a DynamicUnet state_dict (expected 'layers.N...' keys; "
                "save it with torch.save(learn.model.state_dict(), path)). "
                f"First key: {next(iter(sd))!r}")
        _, idx, rest = k.split(".", 2)
        groups.setdefault(int(idx), {})[rest] = v
    enc_sd = groups.pop(0)
    arch = arch or _infer_arch(enc_sd)
    params: Dict[str, Any] = {}
    stats: Dict[str, Any] = {}
    params["encoder"], stats["encoder"] = convert_xresnet_state_dict(enc_sd, arch)
    blocks = 0
    self_attention = False
    for idx in sorted(groups):
        g = groups[idx]
        if "running_mean" in g:  # layers.1, the middle BatchNorm
            params["mid_bn"], stats["mid_bn"] = _bn("", g)
        elif "0.0.weight" in g and "1.0.weight" in g:  # middle_conv pair
            params["mid_conv1"] = _bias_conv(g, "0")
            params["mid_conv2"] = _bias_conv(g, "1")
        elif "shuf.0.0.weight" in g:  # a UnetBlock
            name = f"up_{blocks}"
            blocks += 1
            bn_p, bn_s = _bn("bn", g)
            params[name] = {
                "shuf": {"conv": {"kernel": _conv(g["shuf.0.0.weight"]),
                                  "bias": np.asarray(g["shuf.0.0.bias"])}},
                "bn": bn_p, "conv1": _bias_conv(g, "conv1"),
                "conv2": _bias_conv(g, "conv2")}
            stats[name] = {"bn": bn_s}
            if "conv2.2.gamma" in g:  # ConvLayer xtra = SelfAttention
                self_attention = True
                params[name]["sa"], stats[name]["sa"] = _sa_group(g, "conv2.2")
        elif "0.0.weight" in g:  # the trailing PixelShuffle_ICNR
            params["final_shuf"] = {"conv": {"kernel": _conv(g["0.0.weight"]),
                                             "bias": np.asarray(g["0.0.bias"])}}
        elif "convpath.0.0.weight" in g:  # the last_cross ResBlock
            rb = {"conv1": _bias_conv(g, "convpath.0"), "conv2": _bias_conv(g, "convpath.1")}
            for id_idx in (0, 1):
                if f"idpath.{id_idx}.0.weight" in g:
                    rb["idconv"] = _bias_conv(g, f"idpath.{id_idx}")
            params["last_cross"] = rb
        elif "0.weight" in g:  # the head ConvLayer (ks 1, no act)
            params["head"] = {"kernel": _conv(g["0.weight"]), "bias": np.asarray(g["0.bias"])}
        else:
            raise ValueError(f"Unrecognized DynamicUnet layer {idx}: {sorted(g)[:4]}")
    meta = {"arch": arch, "c_in": int(np.shape(enc_sd["0.0.weight"])[1]),
            "n_out": int(np.shape(params["head"]["kernel"])[-1]),
            "self_attention": self_attention, "n_blocks": blocks}
    return params, stats, meta


def import_model_cli(src: str, bundle_dir: str, description: Optional[str] = None,
                     patch_size: int = 400, regression: bool = False,
                     codes: Optional[list] = None, dtype_str: str = "int8",
                     device="cuda") -> str:
    """``python -m unet_tpu_torch import-model``: a fastai DynamicUnet
    state_dict (.pth) → a prediction-ready parity bundle.

    The converted weights load strictly into the parity U-Net on
    ``device`` (every parameter and buffer present, every shape right) and
    are written back from it, so the bundle holds exactly the tree the
    JAX package's importer writes."""
    dev = resolve_device(device)
    params, stats, meta = convert_unet_state_dict(_load_state_dict(src))
    model = build_unet(arch=meta["arch"], n_out=meta["n_out"], c_in=meta["c_in"],
                       self_attention=meta["self_attention"], tpu_opt=False).to(dev)
    weights = from_flax_variables({"params": params, "batch_stats": stats})
    try:
        model.load_state_dict({k: torch.from_numpy(np.array(a, np.float32))
                               for k, a in weights.items()}, strict=True)
    except RuntimeError as e:
        raise ValueError(f"DynamicUnet parameter trees do not line up: {e}") from e
    variables = to_flax_variables(model.state_dict())
    d = Path(bundle_dir)
    manifest = {
        "ARCHITECTURE": meta["arch"],
        "n_out": meta["n_out"],
        "c_in": meta["c_in"],
        "number_of_bands": meta["c_in"],
        "patch_size": patch_size,
        "self_attention": meta["self_attention"],
        "enable_regression": regression,
        "CODES": list(codes) if codes else None,
        "dtype_str": dtype_str,
        "normalize": "reference",
        "tpu_opt": False,
        "imported_from": str(src),
    }
    export_bundle(d, description or d.name, variables, manifest)
    n = sum(p.numel() for p in model.parameters())
    print(f"Imported {meta['arch']} DynamicUnet ({n / 1e6:.1f}M params, "
          f"c_in={meta['c_in']}, n_out={meta['n_out']}, "
          f"self_attention={meta['self_attention']}) -> {d}")
    return str(d)
