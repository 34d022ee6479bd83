"""The readings a cell's limits are set from, on the card at the cell's own
size: for each seed, the program's numbers against the float32 reference
(the set-up's checked steps, or its warm-up scene), and on some seeds the
fp8 control's numbers (the reference computed in float8 e4m3 in the
program's place) and, for training, the program with half of each batch
left out. One JSON line a reading on standard output.

    python3 perfbench/calibrate.py --workload <cell> --seeds 1,2,3 [--control 3] [--faults 3]

``--control N`` and ``--faults N`` read them on the first N seeds. The
benchmark's own runs never run this.
"""

import argparse
import json
import shutil
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]


def readings(ctx, generator, control: bool, fault: bool):
    """[(what, [(name, value)])] for one seed."""
    import torch

    from perfbench.harness import tiff
    from perfbench.reference import serve as rserve

    out = []
    s = generator.prepare(ctx)
    generator.drop(ctx, s)
    if hasattr(s, "readings"):  # training
        ref = generator.follow(ctx, s.host_images, s.host_masks, s.seen, s.state, s.flip_seed)
        out.append(("program", generator.compare(s.readings, ref, leaves=True)))
        out.append(("program_explained", list(generator.explain(s.readings, ref).items())))
        if control:
            fp8 = generator.follow(ctx, s.host_images, s.host_masks, s.seen, s.state, s.flip_seed,
                                quant="fp8")
            out.append(("control_fp8", generator.compare(fp8, ref, leaves=True)))
            out.append(("control_fp8_explained", list(generator.explain(fp8, ref).items())))
        if fault:
            out.append(("half_batch", half_batch(ctx, generator)))
    else:  # serving
        probs = generator.reference_probs(ctx, s.scene, s.state)
        served = torch.from_numpy(tiff.read(s.warm)[0])
        out.append(("program", [("class_gap", rserve.widest_gap(probs, served))]))
        if control:
            fp8 = generator.reference_probs(ctx, s.scene, s.state, quant="fp8")
            out.append(("control_fp8", [("class_gap", rserve.widest_gap(probs, fp8.argmax(0)))]))
    return out


def half_batch(ctx, generator):
    """The program's checked steps with half of each batch left out of the
    forward and the loss (the mean over the rest), against the reference."""
    from unet_tpu_torch.train.loop import Trainer

    original = Trainer.loss_and_grads

    def halved(self, images, masks):
        half = images.shape[0] // 2
        return original(self, images[:half], masks[:half])

    Trainer.loss_and_grads = halved
    try:
        s = generator.prepare(ctx)
    finally:
        Trainer.loss_and_grads = original
    generator.drop(ctx, s)
    return generator.judge(ctx, s, leaves=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control", type=int, default=0)
    ap.add_argument("--faults", type=int, default=0)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(REPO))
    from perfbench import run as bench_run

    bench_run.cache_dirs(REPO)
    import torch

    from perfbench.harness.context import Context
    from perfbench.harness.spec import Spec

    spec = Spec(REPO)
    cell = spec.cell(args.workload)
    mix = spec.mix(cell["traffic"])
    generator = spec.generator(mix["generator"])
    if not torch.cuda.is_available():
        print("calibrate needs a CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    for k, seed in enumerate(int(v) for v in args.seeds.split(",")):
        workdir = Path(tempfile.mkdtemp(prefix="perfbench-calibrate-"))
        t0 = time.perf_counter()
        try:
            ctx = Context(config=spec.config(cell["config"]), mix=mix,
                          cell=spec.cell_file(args.workload), seed=seed, seconds=0.0,
                          trace=False, device=dev, workdir=workdir, t_start=t0)
            for what, checks in readings(ctx, generator, k < args.control, k < args.faults):
                print(json.dumps({"workload": args.workload, "seed": seed, "what": what,
                                  "checks": dict(checks),
                                  "seconds": time.perf_counter() - t0}), flush=True)
        finally:
            shutil.rmtree(workdir, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
