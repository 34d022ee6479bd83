"""Scene-serving traffic: one GeoTIFF scene served to a class-map GeoTIFF
again and again through the program's ``predict_raster`` with one
``Predictor`` held across scenes, back to back.

Set-up writes the scene from the seed, makes the seed's weights, gives
their BatchNorms running statistics (each site's batch statistics over a
few of the scene's windows, through the reference: random weights have no
trained statistics, and without them the served probabilities saturate),
exports them as the program's bundle, loads the ``Predictor`` and serves
the scene once, which builds and warms everything the window uses. The
window serves scene after scene, each to its own output file, until the
first scene that ends after ``seconds``.

After the window the program is dropped, the float32 reference computes
the scene's mean window probabilities, and every class map written in the
window is read back from disk and judged: the number compared is the
widest margin, over all pixels of all those maps, by which the
reference's probability of the served class lies below its best.
"""

from __future__ import annotations

import math
import time
from types import SimpleNamespace

import torch

from perfbench.harness import data, tiff, weights
from perfbench.harness.context import (Context, float32_exact, free, peak_bytes,
                                       reference_module, reset_peak, sync)
from perfbench.reference import serve as rserve

CALIBRATION_WINDOWS = 8


def serve_state(ctx: Context, scene: torch.Tensor, weight_seed: int) -> dict:
    """The served weights, on the host: the seed's, with running
    statistics from ``CALIBRATION_WINDOWS`` windows of ``scene`` at
    offsets drawn from the seed, and the head tempered
    (``weights.temper_head``) over the same windows in eval mode."""
    cfg, p, dev = ctx.config, ctx.mix["params"], ctx.device
    patch = p["patch"]
    _, h, w = scene.shape
    with float32_exact():
        model = reference_module(cfg).UNet(cfg).to(dev)
        model.load_state_dict(weights.make(model, weight_seed, dev))
        g = torch.Generator().manual_seed(weight_seed)
        ys = torch.randint(0, h - patch + 1, (CALIBRATION_WINDOWS,), generator=g).tolist()
        xs = torch.randint(0, w - patch + 1, (CALIBRATION_WINDOWS,), generator=g).tolist()
        x = torch.stack([scene[:, y:y + patch, q:q + patch]
                         for y, q in zip(ys, xs)]).float() * cfg["value_scale"]
        model.train().set_calibrate(True)
        with torch.no_grad():
            model(x)
        model.set_calibrate(False)
        model.eval()
        state = model.state_dict()
        weights.temper_head(model, state, x)
    return {k: v.detach().cpu().clone() for k, v in state.items()}


def export_bundle(ctx: Context, state: dict, out_dir) -> None:
    """The program's bundle of ``state`` with the manifest its trainer
    writes for this configuration."""
    from unet_tpu_torch.models import TPU_OPT_TOPOLOGY_VERSION
    from unet_tpu_torch.train import checkpoint as ckpt

    cfg, p = ctx.config, ctx.mix["params"]
    tpu_opt = cfg["topology"] == "tpu_opt"
    manifest = {
        "transforms": True, "patch_size": p["patch"], "data_type": "uint8",
        "number_of_bands": cfg["bands"], "enable_regression": False,
        "ARCHITECTURE": cfg["arch"], "CODES": cfg["codes"],
        "self_attention": cfg["self_attention"], "n_out": cfg["classes"],
        "c_in": cfg["bands"], "tpu_opt": tpu_opt,
        "tpu_opt_topology": TPU_OPT_TOPOLOGY_VERSION if tpu_opt else None,
        "bn_variant": None, "dtype_str": "int8", "normalize": "reference",
    }
    ckpt.export_bundle(out_dir, "perfbench", ckpt.to_flax_variables(state), manifest)


def prepare(ctx: Context) -> SimpleNamespace:
    """Set-up: the scene on disk, the served weights and their bundle, the
    predictor, and one scene served to ``warm.tif``."""
    from unet_tpu_torch.predict import Predictor

    cfg, p, dev = ctx.config, ctx.mix["params"], ctx.device
    data_seed, weight_seed = data.seeds(ctx.seed, 2)
    images, _ = data.labelled(data_seed, 1, p["scene"], p["scene"], cfg["bands"],
                              cfg["classes"], dev)
    scene = images[0]
    scene_path = ctx.workdir / "scene.tif"
    data.write_scene(scene_path, scene.cpu().numpy())
    state = serve_state(ctx, scene, weight_seed)
    bundle = ctx.workdir / "perfbench"  # a bundle is named by its directory
    export_bundle(ctx, state, bundle)
    free(dev)
    predictor = Predictor(str(bundle), batch_size=p["batch"], device=str(dev),
                          dtype=torch.bfloat16 if cfg["dtype"] == "bfloat16" else torch.float32)
    s = SimpleNamespace(scene=scene, scene_path=scene_path, state=state, bundle=bundle,
                        predictor=predictor, warm=ctx.workdir / "warm.tif")
    serve(ctx, s, s.warm)
    s.warm_batches = len(predictor.forward_ms())
    return s


def serve(ctx: Context, s: SimpleNamespace, out_path) -> None:
    """One scene through the program's ``predict_raster`` to ``out_path``."""
    from unet_tpu_torch.predict import predict_raster

    p = ctx.mix["params"]
    predict_raster(str(s.bundle), str(s.scene_path), str(out_path), patch_size=p["patch"],
                   patch_overlap=p["overlap"], batch_size=p["batch"], predictor=s.predictor,
                   device=str(ctx.device))


def measure(ctx: Context, s: SimpleNamespace) -> dict:
    """The window: scenes back to back, each to its own file, until the
    first that ends after ``seconds``; the predictor is dropped after it."""
    dev, p = ctx.device, ctx.mix["params"]
    sync(dev)
    reset_peak(dev)
    s.outs = []
    t0 = time.perf_counter()
    setup_s = t0 - ctx.t_start
    while (elapsed := time.perf_counter() - t0) < ctx.seconds:
        ctx.tracer.boundary(elapsed)
        out = ctx.workdir / f"served_{len(s.outs):03d}.tif"
        with ctx.spans("scene"):
            serve(ctx, s, out)
        s.outs.append(out)
    window_s = time.perf_counter() - t0
    ctx.tracer.finish()
    memory = peak_bytes(dev)
    scenes = s.predictor.scenes[1:]
    ctx.record.update(scenes=scenes, scene_s={
        k: [round(min(r[k] for r in scenes), 4), round(max(r[k] for r in scenes), 4)]
        for k in ("seconds", "read_s", "write_s", "finalize_s")} if scenes else {},
                      forward_ms=s.predictor.forward_ms()[s.warm_batches:],
                      n_scenes=len(s.outs), window_s=window_s, scene=p["scene"],
                      patch=p["patch"], overlap=p["overlap"], batch=p["batch"])
    drop(ctx, s)
    return {"e2e": {"serve_mpix_per_s": len(s.outs) * p["scene"] ** 2 / 1e6 / window_s,
                    "setup_s": setup_s},
            "attempted": len(s.outs), "memory_peak_bytes": memory}


def drop(ctx: Context, s: SimpleNamespace) -> None:
    """Free the program's state before the reference runs."""
    s.predictor = None
    free(ctx.device)


def judge(ctx: Context, s: SimpleNamespace, maps) -> tuple:
    """([(name, value)] of the number compared, maps that could not be
    read) for the class-map files ``maps``."""
    probs = reference_probs(ctx, s.scene, s.state)
    gap, failed = 0.0, 0
    for path in maps:
        try:
            served = torch.from_numpy(tiff.read(path)[0])
        except (OSError, ValueError, KeyError) as e:
            ctx.record.setdefault("unreadable", []).append(f"{path.name}: {e}")
            failed += 1
            gap = math.inf
            continue
        gap = max(gap, rserve.widest_gap(probs, served))
    return [("class_gap", gap)], failed


def run(ctx: Context) -> dict:
    s = prepare(ctx)
    out = measure(ctx, s)
    out["checks"], out["failed"] = judge(ctx, s, s.outs)
    return out


def reference_probs(ctx: Context, scene: torch.Tensor, state: dict,
                    quant=None) -> torch.Tensor:
    """The reference's (classes, H, W) mean probabilities of ``scene``
    under the served weights ``state``; ``quant="fp8"`` computes them in
    the lower-precision control."""
    cfg, p = ctx.config, ctx.mix["params"]
    with float32_exact():
        model = reference_module(cfg).UNet(cfg, quant=quant).to(ctx.device).eval()
        model.load_state_dict(state)
        return rserve.probabilities(model, scene, cfg["classes"], p["patch"], p["overlap"],
                                    cfg["value_scale"])
