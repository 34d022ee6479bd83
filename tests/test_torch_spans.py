"""PyTorch port, the span facility (``utils/profiling.py``) and the serve
loop's host phases, on the CPU: each tier's scene record sums every phase
of its host work in ``host_s``; under ``torch.profiler`` the phases are
ranges of their names, none inside another; without a profiler a phase
makes no range; the benchmark's readers of the phases; the device-time
spans behind ``Predictor.forward_ms()`` and ``Trainer.step_ms()``; and the
staging of a batch in ``serve.stack`` and ``serve.h2d``: a batch gathered
from a CHW scene keeps its planar byte order on the host, one of
interleaved rows its interleaved order, reaches ``_forward`` as the
contiguous (B, H, W, C) tile it would have been, and serves the same maps.

Port only: the bundle is the port's own export, nothing of JAX runs."""

import json
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from unet_tpu_torch.geo import read_raster, write_raster
from unet_tpu_torch.models import build_unet, init_weights
from unet_tpu_torch.models.unet import TPU_OPT_TOPOLOGY_VERSION
from unet_tpu_torch.predict import predict as tp
from unet_tpu_torch.train import checkpoint as ckpt
from unet_tpu_torch.train import loop
from unet_tpu_torch.utils import profiling

torch.set_num_threads(2)
ROOT = Path(__file__).resolve().parents[1]
H, W, PATCH, BATCH, N_OUT = 200, 232, 64, 4, 3
TRANSFORM = (500000.0, 0.2, 0.0, 5400000.0, 0.0, -0.2)
CODES = ("background", "building", "vegetation")

PHASES = {"serve.read", "serve.plan", "serve.stack", "serve.h2d", "serve.forward",
          "serve.add", "serve.finalize", "serve.fetch", "serve.write"}
# the banded tiers build batches on a thread, which the loop waits for
TIER_PHASES = {"full": PHASES, "banded": PHASES | {"serve.wait"},
               "streamed": PHASES | {"serve.wait"}}
# the read-ahead thread's phases: the stacking, and on the streamed tier the reads
AHEAD = {"full": set(), "banded": {"serve.stack"},
         "streamed": {"serve.stack", "serve.read"}}
TIER_KW = {"full": {}, "banded": {"device_budget_bytes": 0}, "streamed": {"host_budget_bytes": 1}}


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """A tiny tpu_opt bundle of the port's own export and a 200×232 uint8
    scene."""
    root = tmp_path_factory.mktemp("spans")
    model = build_unet("xresnet18", n_out=N_OUT, c_in=3, tpu_opt=True, dtype=torch.float32)
    init_weights(model, torch.Generator().manual_seed(0))
    manifest = {"ARCHITECTURE": "xresnet18", "n_out": N_OUT, "number_of_bands": 3,
                "patch_size": PATCH, "enable_regression": False, "dtype_str": "uint8",
                "normalize": "unit", "self_attention": False, "tpu_opt": True,
                "tpu_opt_topology": TPU_OPT_TOPOLOGY_VERSION, "bn_variant": None}
    ckpt.export_bundle(root / "m", "m", ckpt.to_flax_variables(model.state_dict()), manifest)
    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, (3, H, W)).astype(np.uint8)
    write_raster(root / "scene.tif", img, transform=TRANSFORM, crs="EPSG:25832")
    return {"root": root, "bundle": str(root / "m"), "scene": str(root / "scene.tif")}


def _predictor(served):
    return tp.Predictor(served["bundle"], batch_size=BATCH, device="cpu", dtype=torch.float32)


def _serve(served, predictor, out, tier):
    tp.predict_raster(served["bundle"], served["scene"], str(out), patch_size=PATCH,
                      batch_size=BATCH, predictor=predictor, device="cpu",
                      dtype=torch.float32, **TIER_KW[tier])


@pytest.mark.parametrize("tier", ["full", "banded", "streamed"])
def test_each_tier_records_every_phase_of_its_host_work(served, tmp_path, tier):
    """``host_s`` names every phase of the tier, each above 0; the loop's
    own phases sum to at most the scene's seconds, and so do the read-ahead
    thread's, which run beside them."""
    pred = _predictor(served)
    _serve(served, pred, tmp_path / "o.tif", tier)
    (scene,) = pred.scenes
    assert scene["tier"] == tier
    host = scene["host_s"]
    assert set(host) == TIER_PHASES[tier]
    assert all(v > 0 for v in host.values()), host
    loop_s = sum(v for k, v in host.items() if k not in AHEAD[tier])
    assert loop_s <= scene["seconds"]
    assert sum(host[k] for k in AHEAD[tier]) <= scene["seconds"]
    # the records the benchmark reads keep their meaning
    assert len(pred.forward_ms()) == scene["batches"]
    assert scene["write_s"] <= host["serve.write"]
    if tier != "streamed":
        assert scene["read_s"] == pytest.approx(host["serve.read"])


def _flat(ranges):
    """True if no (start, end) range of one thread lies inside another."""
    for i, (ti, si, ei) in enumerate(ranges):
        for j, (tj, sj, ej) in enumerate(ranges):
            if i != j and ti == tj and si <= sj and ej <= ei:
                return False
    return True


@pytest.mark.parametrize("tier", ["full", "banded"])
def test_served_scene_ranges_lie_in_the_trace_none_inside_another(served, tmp_path, tier):
    """Under ``torch.profiler`` every ``serve.*`` phase of the serve loop's
    thread is a range of its name in the trace, and no ``serve.*`` range
    encloses another: a range names the host's phase at any instant."""
    pred = _predictor(served)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        _serve(served, pred, tmp_path / "o.tif", tier)
    ranges = [(e.start_thread_id(), e.start_ns(), e.start_ns() + e.duration_ns(), e.name())
              for e in prof.profiler.kineto_results.events() if e.name().startswith("serve.")]
    names = {n for *_, n in ranges}
    assert TIER_PHASES[tier] - AHEAD[tier] <= names <= TIER_PHASES[tier]
    assert _flat([r[:3] for r in ranges])
    # each range is one sample of the scene's host seconds
    counts = {n: sum(r[3] == n for r in ranges) for n in names - AHEAD[tier]}
    assert counts == {n: len(pred.timer.samples[n]) for n in counts}


def test_a_phase_makes_a_range_only_while_a_profiler_runs(monkeypatch):
    made = []
    real = torch.profiler.record_function

    def counting(name):
        made.append(name)
        return real(name)

    monkeypatch.setattr(torch.profiler, "record_function", counting)
    timer = profiling.StepTimer()
    for _ in range(3):
        with timer.phase("serve.stack"):
            pass
    assert made == [] and len(timer.samples["serve.stack"]) == 3
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with timer.phase("serve.stack"):
            torch.ones(2).add_(1)
    assert made == ["serve.stack"]
    assert "serve.stack" in {e.name() for e in prof.profiler.kineto_results.events()}
    with timer.phase("serve.stack"):
        pass
    assert made == ["serve.stack"] and len(timer.samples["serve.stack"]) == 5
    assert timer.totals() == {"serve.stack": pytest.approx(sum(timer.samples["serve.stack"]))}


def _reader(name):
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    from perfbench.harness.spec import Spec

    return Spec(ROOT).reader(name)


READERS = {"stack_ms.serve": "serve.stack", "h2d_ms.serve": "serve.h2d",
           "add_ms.serve": "serve.add"}


@pytest.mark.parametrize("metric", sorted(READERS))
def test_host_phase_readers_give_the_mean_ms_a_batch(metric):
    """Σ over the scenes of the phase's seconds / Σ batches, in ms; nothing
    from records without ``host_s`` (a program without the phases)."""
    phase = READERS[metric]
    scenes = [{"batches": 7, "host_s": {phase: 0.70, "serve.other": 9.0}},
              {"batches": 7, "host_s": {phase: 1.40}},
              {"batches": 2, "host_s": {phase: 0.50}}]
    run = SimpleNamespace(record={"scenes": scenes})
    assert _reader(metric).read(run) == pytest.approx(1e3 * 2.6 / 16)
    old = SimpleNamespace(record={"scenes": [{"batches": 7, "read_s": 0.5, "write_s": 0.2}]})
    assert _reader(metric).read(old) is None
    assert _reader(metric).read(SimpleNamespace(record={})) is None


def test_the_readers_are_entries_of_the_benchmark():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    entries = {m["name"]: m for m in bench["per_layer"]}
    for name in READERS:
        m = entries[name]
        assert (m["unit"], m["better"], m["source"], m["moves"]) == (
            "ms", "lower", "program_span", "serve_mpix_per_s")
        assert m["layer"] == "serve loop (predict/predict.py)"
        assert m["workloads"] == ["serve.tpu_opt.scene8k"]


def test_device_spans_give_one_value_a_span():
    spans = profiling.DeviceSpans(torch.device("cpu"))
    for _ in range(3):
        spans.start()
        torch.ones(64).sum()
        spans.stop()
    ms = spans.ms()
    assert len(ms) == 3 and all(v >= 0 for v in ms)


def test_forward_ms_gives_one_value_a_forward(served):
    pred = _predictor(served)
    batch = np.zeros((BATCH, PATCH, PATCH, 3), np.uint8)
    for k in range(1, 4):
        pred.predict_batch_device(batch)
        assert len(pred.forward_ms()) == k
    assert len(pred.timer.samples["serve.forward"]) == 3
    assert len(pred.timer.samples["serve.h2d"]) == 3


@pytest.fixture(scope="module")
def tiles(tmp_path_factory):
    """4 trai and 1 vali 64² uint8 tiles."""
    root = tmp_path_factory.mktemp("span_tiles")
    rng = np.random.default_rng(0)
    for scene, n in (("trai", 4), ("vali", 1)):
        for sub in ("img_tiles", "mask_tiles"):
            (root / scene / sub).mkdir(parents=True)
        for i in range(n):
            img = rng.integers(0, 256, (3, PATCH, PATCH)).astype(np.uint8)
            mask = (img[0] > 128).astype(np.uint8) + (img[1] > 200)
            for sub, a in (("img_tiles", img), ("mask_tiles", mask[None])):
                write_raster(root / scene / sub / f"{i}.tif", a, transform=TRANSFORM,
                             crs="EPSG:25832")
    return root


def test_step_ms_gives_one_value_a_step(tiles, tmp_path):
    t = loop.Trainer(loop.TrainerConfig(
        data_path=tiles, model_path=tmp_path, description="s", codes=CODES,
        arch="xresnet18", batch_size=2, epochs=1, bf16=False, transforms=False,
        loader_threads=2, device="cpu"))
    try:
        t.init_state()
        assert t.step_ms() == []
        for k, (images, masks, _) in enumerate(t.train_loader, start=1):
            t.train_step(images, masks)
            assert len(t.step_ms()) == k
        assert k == 2 and all(v > 0 for v in t.step_ms())
    finally:
        t.close()


PLANAR = (3 * PATCH * PATCH, PATCH, 1, PATCH * PATCH)  # (B, H, W, C) strides of a (B, C, H, W) block


def _windows(hwc, n=BATCH):
    return [hwc[7 * k:7 * k + PATCH, 11 * k:11 * k + PATCH] for k in range(n)]


def _planar_batch(seed=0, dtype=np.uint8, n=BATCH):
    """A batch as the serve loop built it before staging: ``np.stack`` of
    windows of an HWC view of a CHW scene."""
    chw = np.random.default_rng(seed).integers(0, 256, (3, 120, 140)).astype(dtype)
    return np.stack(_windows(np.moveaxis(chw, 0, 2), n))


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16, np.float32])
def test_a_gathered_batch_is_staged_in_its_planar_order(dtype):
    """``np.stack`` keeps the CHW scene's stride order, and staging keeps it
    too: no byte is reordered on the host. A ``host_batch`` block gathers
    the same bytes in that order, pads a short batch with its last window
    and crosses as it is."""
    cpu = torch.device("cpu")
    batch = _planar_batch(dtype=dtype)
    assert tuple(s // batch.itemsize for s in batch.strides) == PLANAR
    staged = tp.stage_batch(batch, cpu)
    assert staged.stride() == PLANAR and not staged.is_contiguous()
    assert staged.data_ptr() == batch.ctypes.data
    chw = np.random.default_rng(0).integers(0, 256, (3, 120, 140)).astype(dtype)
    block = tp.host_batch(_windows(np.moveaxis(chw, 0, 2)), BATCH, cpu)
    assert tuple(s // block.itemsize for s in block.strides) == PLANAR
    np.testing.assert_array_equal(block, batch)
    assert tp.stage_batch(block, cpu).data_ptr() == block.ctypes.data
    short = tp.host_batch(_windows(np.moveaxis(chw, 0, 2), 2), BATCH, cpu)
    np.testing.assert_array_equal(short, batch[[0, 1, 1, 1]])


@pytest.fixture(scope="module")
def artifact(served):
    """The float32 ``.uta`` artifact of the served bundle, exported on the CPU."""
    from unet_tpu_torch.predict import artifact as tart

    return str(tart.export_artifact(served["bundle"], str(served["root"] / "m.uta"),
                                    dtype=torch.float32, device="cpu"))


FORMS = {"planar": lambda b: b, "contiguous": np.ascontiguousarray,
         "host_batch": lambda b: tp.host_batch(list(b), len(b), torch.device("cpu")),
         "flipped": lambda b: np.ascontiguousarray(b[:, ::-1])[:, ::-1]}


@pytest.mark.parametrize("form", sorted(FORMS))
@pytest.mark.parametrize("kind", ["bundle", "artifact"])
def test_forward_receives_the_contiguous_batch(served, artifact, kind, form):
    """Whatever the batch's strides, ``_forward`` gets the contiguous
    (B, H, W, C) tensor that ``np.ascontiguousarray`` of it gives, and the
    probabilities are those of that tensor; ``planar_batches`` counts the
    batches interleaved on the device."""
    from unet_tpu_torch.predict import artifact as tart

    pred = (_predictor(served) if kind == "bundle"
            else tart.load_artifact(artifact, batch_size=BATCH, device="cpu"))
    batch = _planar_batch(seed=1)
    images = FORMS[form](batch)
    seen = []
    real = pred._forward

    def capture(x):
        seen.append(x.clone())
        return real(x)

    pred._forward = capture
    got = pred.predict_batch_device(images)
    assert pred.planar_batches == (form in ("planar", "host_batch"))
    want = pred.predict_batch_device(np.ascontiguousarray(batch))
    first, ref = seen
    assert first.is_contiguous() and first.shape == (BATCH, PATCH, PATCH, 3)
    assert torch.equal(first, torch.from_numpy(np.ascontiguousarray(batch)))
    assert torch.equal(first, ref) and torch.equal(got, want)


@pytest.mark.parametrize("tier", ["full", "banded", "streamed"])
def test_served_map_equals_the_map_of_contiguous_batches(served, tmp_path, tier):
    """A scene served through staged batches writes the class map, byte for
    byte, that batches made contiguous on the host first write; the last
    batch is padded. The whole-scene and banded tiers window the CHW scene,
    so their batches are planar and every one is interleaved on the device;
    the streamed tier's rows are decoded (rows, W, C), so its batches are
    contiguous and none is."""
    maps, records, handed = [], [], []
    for contiguous in (False, True):
        pred = tp.Predictor(served["bundle"], batch_size=3, device="cpu", dtype=torch.float32)
        staged = pred.predict_batch_device
        if contiguous:
            pred.predict_batch_device = lambda images, **kw: staged(
                np.ascontiguousarray(images), **kw)
        else:
            def observe(images, **kw):
                handed.append(images)
                return staged(images, **kw)

            pred.predict_batch_device = observe
        out = tmp_path / f"{contiguous}.tif"
        tp.predict_raster(served["bundle"], served["scene"], str(out), patch_size=PATCH,
                          batch_size=3, predictor=pred, device="cpu", dtype=torch.float32,
                          **TIER_KW[tier])
        maps.append(read_raster(out).data)
        (record,) = pred.scenes
        records.append(record)
    np.testing.assert_array_equal(maps[0], maps[1])
    planar, contiguous = records
    assert planar["tier"] == tier and planar["windows"] % 3
    assert len(handed) == planar["batches"] > 0
    if tier == "streamed":
        assert planar["planar_batches"] == 0
        assert all(b.flags.c_contiguous for b in handed)
    else:
        assert planar["planar_batches"] == planar["batches"]
        assert all(tuple(s // b.itemsize for s in b.strides) == (3 * PATCH * PATCH, PATCH, 1,
                                                                PATCH * PATCH) for b in handed)
    assert contiguous["planar_batches"] == 0


@pytest.mark.parametrize("layout", ["chw", "hwc"])
def test_host_batch_keeps_the_windows_byte_order(layout):
    """Windows of a CHW scene are gathered into a planar block, windows of
    an interleaved (rows, W, C) block, as the streamed tier decodes them,
    into a contiguous one: whole rows are copied and no byte is reordered
    on the host, and a batch of interleaved windows crosses with no
    interleave on the device."""
    cpu = torch.device("cpu")
    chw = np.random.default_rng(2).integers(0, 256, (3, 120, 140)).astype(np.uint8)
    hwc = np.moveaxis(chw, 0, 2) if layout == "chw" else np.ascontiguousarray(
        np.moveaxis(chw, 0, 2))
    block = tp.host_batch(_windows(hwc, 3), BATCH, cpu)
    np.testing.assert_array_equal(block, np.stack(_windows(hwc, 3) + _windows(hwc, 3)[-1:]))
    assert block.flags.c_contiguous == (layout == "hwc")
    strides = tuple(s // block.itemsize for s in block.strides)
    assert strides == (PLANAR if layout == "chw" else (3 * PATCH * PATCH, 3 * PATCH, 3, 1))
    assert tp.stage_batch(block, cpu).is_contiguous() == (layout == "hwc")
