"""CIFAR-10 Natural-Inference sampling on the card (port of
``naturaldiffusion_tpu/apps/cifar10_ni.py``, after
``src/CIFAR10NaturalInference.py:241-317``).

The NCSN++ VP backbone with random weights from ``--seed`` (same FLOPs as
``checkpoint_8.pth``), a Natural-Inference matrix (a learned
``weights/step_*_weight_*.npz`` via ``--weights``, else the derived DDPM
matrix at ``--steps``), and N images in micro-batches.  Prints img/s.

Run: ``python -m naturaldiffusion_tpu_torch.apps.cifar10_ni --num 256``.
``--ckpt``, ``--fid-stats`` and ``--outdir`` are not ported yet.
"""

from __future__ import annotations

import argparse
import copy
import sys
import time

import torch

from ..coeffs import registry
from ..coeffs.matrix import CoeffMatrix
from ..device import resolve_device
from ..engine import NISchedule, natural_inference
from ..models.ncsnpp import CIFAR10_DDPMPP_CONTINUOUS, NCSNpp


def make_sampler(model, matrix: CoeffMatrix, *, micro: int = 64,
                 dtype=torch.bfloat16, device="cuda"):
    """``run(init, noises=None, generator=None) -> samples`` (float32).

    A copy of ``model`` in ``dtype`` on ``device`` predicts eps; the engine
    converts it to x0 with f32 accumulation.  ``init`` [B, 32, 32, 3] runs
    in chunks of ``micro`` images, one after another, when ``micro``
    divides B and is smaller; ``noises`` [n, B, ...] or ``generator``
    supply the injected noises of a stochastic matrix."""
    dev = resolve_device(device)
    net = copy.deepcopy(model).to(device=dev, dtype=dtype).eval()
    sched = NISchedule.from_matrix(matrix, device=dev)

    def eps_fn(z, t):
        return net(z, t.reshape(1).expand(z.shape[0]))

    @torch.no_grad()
    def run(init, noises=None, generator=None):
        bb = init.shape[0]
        step = micro if micro and bb % micro == 0 and bb > micro else bb
        outs = []
        for c in range(0, bb, step):
            outs.append(natural_inference(
                eps_fn, sched, init[c:c + step],
                noises=None if noises is None else noises[:, c:c + step],
                generator=generator, prediction_type="eps",
                model_dtype=dtype))
        return torch.cat(outs)

    return run


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--weights", default=None,
                   help="NI weight npz (e.g. weights/step_10_weight_42.npz); "
                        "default: derived ddpm matrix at --steps")
    p.add_argument("--steps", type=int, default=10)
    p.add_argument("--num", type=int, default=512)
    p.add_argument("--batch", type=int, default=512)
    p.add_argument("--micro", type=int, default=64,
                   help="images per chunk inside a batch (0 = whole batch)")
    p.add_argument("--seed", type=int, default=888)   # the reference seed
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    dev = resolve_device(args.device)
    matrix = (CoeffMatrix.load(args.weights) if args.weights
              else registry.derive("ddpm", args.steps))
    model = NCSNpp(CIFAR10_DDPMPP_CONTINUOUS, device=dev, seed=args.seed)
    run = make_sampler(model, matrix, micro=args.micro, device=dev)
    gen = torch.Generator(device=dev).manual_seed(args.seed)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    done = timed = 0
    t0 = None
    while done < args.num:
        b = min(args.batch, args.num - done)
        init = torch.randn((b, 32, 32, 3), generator=gen, device=dev)
        out = run(init, generator=gen)
        sync()
        if not torch.isfinite(out).all():
            raise FloatingPointError("non-finite samples")
        done += b
        if t0 is None:              # the first batch warms up
            t0 = time.perf_counter()
        else:
            timed += b
        rate = timed / (time.perf_counter() - t0) if timed else float("nan")
        print(f"{done}/{args.num} ({rate:.1f} img/s steady)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
