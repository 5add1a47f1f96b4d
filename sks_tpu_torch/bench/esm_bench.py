"""ESM tracker throughput on the card, and the polish's share of a VO call.

The counterpart of ``sks_tpu/bench/esm_bench.py`` with the gather sampler
only (the JAX package's one-hot matmul sampler is the TPU's): a batch of 64
templates (64 x 64) tracked in their own 128 x 128 images for 10 iterations,
one batched :func:`sks_tpu_torch.slam.tracking.esm_track` call.  Images are
smoothed random textures (three passes of a 4-neighbour mean), each template
is the image's central crop, and each start is the truth displaced by up to
2 px.  Times are device times (CUDA events around calls queued behind a spin
kernel, ``bench.table8.device_ms``), medians over ``reps`` batches drawn
anew; templates/s = batch / device seconds.  Beside them: the aten ops one
batched call dispatches to the card (:func:`dispatched_ops`, the launches'
count: each launches one kernel or a few), the median translation error
left against the truth and the share of templates tracked to within
0.01 px (on the CPU with the same inputs the JAX package leaves the same 9
of 64 at their start: they never accept a step).

:func:`polish_split` traces one ``frames_to_poses(esm_iters=8)`` and one
``planar_slam`` (its default ``esm_iters=8``) call at the pipeline
benchmark's configuration (``bench/pipeline_fps.py``) and reads the
``vo/esm`` stage's host and device ms and the call's idle share, beside
the call's untraced device and host ms.

Run on a machine with a CUDA card, from the repository root:

    python -m sks_tpu_torch.bench.esm_bench [--split] [--out PATH]
"""

from __future__ import annotations

import json
import statistics
from collections import Counter

import torch
import torch.nn.functional as F
from torch.utils._python_dispatch import TorchDispatchMode

from sks_tpu_torch.bench.table8 import card_line, device_ms
from sks_tpu_torch.slam.tracking import esm_track

__all__ = ["make_batch", "dispatched_ops", "run", "polish_split"]


def make_batch(generator: torch.Generator, batch: int = 64, tpl: int = 64,
               img: int = 128):
    """(templates (B, tpl, tpl), images (B, img, img), starts (B, 3, 3),
    truth offset o): smooth random textures, template = the central crop at
    (o, o), start = the truth displaced by up to 2 px."""
    dev = generator.device
    x = torch.rand((batch, img + 8, img + 8), generator=generator,
                   device=dev)
    for _ in range(3):
        x = 0.25 * (x[:, :-2, 1:-1] + x[:, 2:, 1:-1] + x[:, 1:-1, :-2]
                    + x[:, 1:-1, 2:])
        x = F.pad(x[:, None], (1, 1, 1, 1), mode="replicate")[:, 0]
    imgs = x[:, :img, :img].contiguous()
    o = (img - tpl) // 2
    tpls = imgs[:, o:o + tpl, o:o + tpl].contiguous()
    shift = torch.rand((batch, 2), generator=generator, device=dev) * 4 - 2
    h0 = torch.eye(3, device=dev).repeat(batch, 1, 1)
    h0[:, :2, 2] = o + shift
    return tpls, imgs, h0, o


class _Dispatched(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if not func.is_view:
            self.ops[func.overloadpacket.__name__] += 1
        return func(*args, **(kwargs or {}))


def dispatched_ops(fn) -> tuple:
    """(result, Counter of the non-view aten ops ``fn`` dispatches)."""
    with _Dispatched() as mode:
        out = fn()
    return out, mode.ops


def run(batch: int = 64, tpl: int = 64, img: int = 128, iters: int = 10,
        reps: int = 5, device="cuda") -> dict:
    """Templates tracked per second of device time, gather sampler."""
    gen = torch.Generator(device=device).manual_seed(0)
    batches = [make_batch(gen, batch, tpl, img) for _ in range(reps + 1)]

    def track(b):
        return esm_track(b[0], b[1], b[2], iters=iters, sampler="gather")[0]

    (h, _), ops = dispatched_ops(lambda: esm_track(
        *batches[0][:3], iters=iters, sampler="gather"))
    torch.cuda.synchronize()
    ms = statistics.median(device_ms(lambda b=b: track(b), 1)
                           for b in batches[1:])
    err = (h[:, :2, 2] - batches[0][3]).abs().amax(-1)
    sec = ms * 1e-3
    return {
        "card": card_line(), "torch": torch.__version__,
        "metric": "esm_templates_tracked_per_sec_per_chip",
        "sampler": "gather", "batch_templates": batch,
        "template": [tpl, tpl], "image": [img, img],
        "iters_per_track": iters, "reps": reps,
        "device_ms_per_batch": ms, "templates_per_sec": batch / sec,
        "esm_iterations_per_sec": batch * iters / sec,
        "aten_ops_per_call": sum(ops.values()),
        "median_translation_err_px": err.median().item(),
        "tracked_share": (err < 0.01).float().mean().item(),
    }


def polish_split(device="cuda") -> list:
    """The ``vo/esm`` stage of one traced ``frames_to_poses(esm_iters=8)``
    and one ``planar_slam`` call at (240, 320), after a warm-up call each."""
    from sks_tpu_torch.bench import pipeline_fps

    rows = []
    for capstone in (False, True):
        row = pipeline_fps.measure((240, 320), capstone=capstone, runs=1,
                                   device=device, esm_iters=8)
        row["trace"] = pipeline_fps.profile_call(
            (240, 320), capstone=capstone, device=device, esm_iters=8)
        rows.append(row)
    return rows


def main(argv=None) -> None:
    """Console entry point: print the row; ``--split`` adds the traced
    calls; ``--out`` writes the JSON."""
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--split", action="store_true",
                    help="also trace the polish inside two VO calls")
    ap.add_argument("--out", default=None, help="JSON output path")
    args = ap.parse_args(argv)
    result = {"esm_bench": run()}
    if args.split:
        result["polish_split"] = polish_split()
    print(json.dumps(result))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)


if __name__ == "__main__":
    main()
