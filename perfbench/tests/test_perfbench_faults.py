"""A run with the timed path broken underneath comes out not correct: the
harness's look for a card skipped, the rest of a run driven on the CPU
(tiny cells, their own limits), once for each fault a cell can have. One
card: no exchange between cards to leave out."""

import pytest
import torch
from conftest import run_cell


def _false(tiny_repo, capsys, cell):
    rc, result, err = run_cell(tiny_repo, capsys, cell, seed=2 ** 31 + 23)
    assert rc == 0, err
    assert result["correct"] is False, result["checks"]
    return result["checks"]


def test_a_step_that_leaves_the_state_unchanged(tiny_repo, capsys, monkeypatch):
    from unet_tpu_torch.train.optimizer import OneCycleAdam

    monkeypatch.setattr(OneCycleAdam, "step", lambda self: None)
    checks = _false(tiny_repo, capsys, "tiny.train")
    assert checks["delta_gap"]["value"] == pytest.approx(1.0)


def test_half_of_the_batch_left_out(tiny_repo, capsys, monkeypatch):
    from unet_tpu_torch.train.loop import Trainer

    original = Trainer.loss_and_grads

    def halved(self, images, masks):
        half = images.shape[0] // 2
        return original(self, images[:half], masks[:half])

    monkeypatch.setattr(Trainer, "loss_and_grads", halved)
    checks = _false(tiny_repo, capsys, "tiny.train")
    assert checks["grad_gap"]["value"] > checks["grad_gap"]["limit"]


def test_a_served_answer_altered_where_it_is_produced(tiny_repo, capsys, monkeypatch):
    from unet_tpu_torch.predict import merge

    original = merge.finalize_mosaic_torch

    def altered(summed, counter, **mode):
        out, nodata = original(summed, counter, **mode)
        out = out.clone()
        out[:8, :8] = (out[:8, :8] + 1) % summed.shape[0]
        return out, nodata

    monkeypatch.setattr(merge, "finalize_mosaic_torch", altered)
    checks = _false(tiny_repo, capsys, "tiny.serve")
    assert checks["class_gap"]["value"] > checks["class_gap"]["limit"]


def test_a_tile_the_loader_never_read(tiny_repo, capsys, monkeypatch):
    """A batch whose bytes are no tile written at set-up."""
    from unet_tpu_torch.data import TileLoader

    original = TileLoader.make_batch_python

    def corrupt(self, paths):
        images, masks, n = original(self, paths)
        images = images.copy()
        images[0, 0, 0, 0] ^= 1
        return images, masks, n

    monkeypatch.setattr(TileLoader, "make_batch_python", corrupt)
    monkeypatch.setattr(TileLoader, "make_batch_native", corrupt)
    checks = _false(tiny_repo, capsys, "tiny.train")
    assert checks["tiles_known"]["value"] == float("inf")


@pytest.mark.cuda
def test_the_fp8_control_fails_each_cell_at_its_size():
    """On the card, at the cells' own sizes: the control (the reference in
    float8 in the program's place) fails a limit of each cell on one seed."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the control runs at the cells' own sizes")
    import tempfile
    from pathlib import Path

    from conftest import REPO

    from perfbench import calibrate
    from perfbench.harness.context import Context
    from perfbench.harness.spec import Spec

    spec = Spec(REPO)
    for w in spec.bench["workloads"]:
        mix = spec.mix(w["traffic"])
        own = spec.cell_file(w["name"])
        with tempfile.TemporaryDirectory() as tmp:
            ctx = Context(config=spec.config(w["config"]), mix=mix, cell=own, seed=2 ** 31 + 99,
                          seconds=0.0, trace=False, device=torch.device("cuda", 0),
                          workdir=Path(tmp), t_start=0.0)
            got = dict(calibrate.readings(ctx, spec.generator(mix["generator"]), True, False))
        control = {k: v[0] if isinstance(v, tuple) else v for k, v in got["control_fp8"]}
        assert any(v > own["limits"][k] for k, v in control.items() if k in own["limits"]), \
            (w["name"], control)
