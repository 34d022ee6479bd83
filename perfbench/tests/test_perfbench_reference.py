"""The plain reference against the program on the CPU in float32, where the
two must agree to rounding: the forward of both topologies, a whole
training step of the harness, and a served scene. Also the yardstick's
copied arithmetic and the work counted from the reference."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch
from conftest import REPO

from perfbench.harness import data
from perfbench.harness.context import Context
from perfbench.harness.yardstick import bn_work, bound_s, blend_work, flip_work, windows
from perfbench.reference import unet, work

# every configuration file, those whose cells BENCHMARK.json does not hold yet too
CONFIGS = sorted(p.stem for p in (REPO / "perfbench" / "configs").glob("*.json"))


def _config(name):
    return json.loads((REPO / "perfbench" / "configs" / f"{name}.json").read_text())


@pytest.mark.parametrize("name", CONFIGS)
@pytest.mark.parametrize("training", [True, False])
def test_reference_forward_equals_the_programs_in_float32(name, training):
    from perfbench.harness import weights
    from unet_tpu_torch.models import build_unet

    cfg = _config(name)
    ref = unet.UNet(cfg)
    prog = build_unet(cfg["arch"], n_out=cfg["classes"], c_in=cfg["bands"],
                      self_attention=cfg["self_attention"], tpu_opt=cfg["topology"] == "tpu_opt",
                      dtype=torch.float32, bn_variant=None)
    state = weights.make(ref, 7, torch.device("cpu"))
    assert set(state) == set(prog.state_dict())
    ref.load_state_dict(state)
    prog.load_state_dict(state)
    ref.train(training)
    prog.train(training)
    x = torch.rand((2, cfg["bands"], 64, 64), generator=torch.Generator().manual_seed(1)) * 255
    with torch.no_grad():
        a, b = prog(x), ref(x)
    assert a.shape == b.shape == (2, cfg["classes"], 64, 64)
    assert float((a - b).abs().max()) <= 1e-5 * float(b.abs().max())


def _ctx(config, tmp, mix, seed=5):
    return Context(config=dict(_config(config), dtype="float32"), mix=mix,
                   cell={"trace": {"after_frac": 0.0, "units": 1}, "limits": {}}, seed=seed,
                   seconds=0.0, trace=False, device=torch.device("cpu"), workdir=Path(tmp),
                   t_start=0.0)


def test_a_float32_training_step_of_the_program_follows_the_reference(tmp_path):
    """The harness's checked steps with the program in float32: the
    reference's losses, first gradient and change agree to rounding."""
    from perfbench.traffic import train_loop

    mix = {"generator": "train_loop", "params": {
        "batch": 2, "tile": 64, "train_tiles": 8, "valid_tiles": 2, "epochs": 4, "lr": 0.001,
        "class_weights": "weighted", "hflip_p": 0.5, "vflip_p": 0.5, "loader_threads": 2}}
    ctx = _ctx("xresnet34_parity_sa", tmp_path, mix)
    s = train_loop.prepare(ctx)
    train_loop.drop(ctx, s)
    checks = dict(train_loop.judge(ctx, s))
    assert checks["loss_gap"] < 1e-5
    assert checks["grad_gap"] < 1e-3
    # Adam divides by the root of the second moment, so the change of an
    # element whose gradient is near nought follows its rounding: 1e-2
    assert checks["delta_gap"] < 1e-2


def test_a_float32_served_scene_of_the_program_matches_the_reference(tmp_path):
    from perfbench.traffic import scene_serve

    mix = {"generator": "scene_serve", "params": {
        "scene": 192, "patch": 64, "overlap": 0.2, "batch": 4}}
    ctx = _ctx("xresnet34_tpu_opt", tmp_path, mix)
    s = scene_serve.prepare(ctx)
    scene_serve.drop(ctx, s)
    checks, failed = scene_serve.judge(ctx, s, [s.warm])
    assert failed == 0
    assert dict(checks)["class_gap"] == 0.0


def test_the_yardstick_is_the_programs_arithmetic():
    from unet_tpu_torch.utils import timing

    for shape, back in (((16, 64, 128, 128), False), ((16, 512, 16, 16), True)):
        assert bn_work(shape, 2, back) == timing.bn_work(shape, 2, back)
        assert bound_s(*bn_work(shape, 2, back)) * 1e3 == pytest.approx(
            timing.bound(*timing.bn_work(shape, 2, back))[0])
    assert flip_work(16, 3, 512, 512) == timing.flip_work(16, 3, 512, 512)
    offsets = windows(8192, 8192, 512, 0.2)[:32]
    rows, cols = [y for y, _ in offsets], [x for _, x in offsets]
    assert blend_work(32, 3, 512, 512, rows, cols) == timing.blend_work(32, 3, 512, 512, rows,
                                                                          cols)


def test_windows_are_the_programs():
    from unet_tpu_torch.tiling.windows import generate_windows

    for h, w, p, o in ((8192, 8192, 512, 0.2), (1000, 700, 256, 0.3)):
        assert windows(h, w, p, o) == [(win.y, win.x) for win in generate_windows(h, w, p, o)]
    assert len(windows(8192, 8192, 512, 0.2)) == 400


def test_the_work_counted_from_the_reference():
    from unet_tpu_torch.utils.timing import BN_SITES

    tpu_opt = _config("xresnet34_tpu_opt")
    assert work.forward_flops(tpu_opt, 512) == pytest.approx(139.85e9, rel=1e-3)
    assert work.forward_flops(_config("xresnet34_parity_sa"), 512) == pytest.approx(
        269.83e9, rel=1e-3)
    sites = work.bn_sites(tpu_opt, 16, 512)
    counted = {}
    for n, c, h, w in sites:
        assert n == 16 and h == w
        counted[(c, h)] = counted.get((c, h), 0) + 1
    assert counted == {(c, h): k for c, h, k in BN_SITES}


def test_data_are_the_seeds():
    a = data.labelled(2 ** 31 + 5, 2, 64, 64, 3, 3, torch.device("cpu"))
    b = data.labelled(2 ** 31 + 5, 2, 64, 64, 3, 3, torch.device("cpu"))
    c = data.labelled(2 ** 31 + 6, 2, 64, 64, 3, 3, torch.device("cpu"))
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a[0], c[0])
    assert set(np.unique(a[1].numpy())) <= {0, 1, 2}
    assert len(set(data.seeds(2 ** 33 + 1, 4))) == 4
