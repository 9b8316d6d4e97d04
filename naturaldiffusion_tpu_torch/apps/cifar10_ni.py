"""CIFAR-10 Natural-Inference sampling on the card (port of
``naturaldiffusion_tpu/apps/cifar10_ni.py``, after
``src/CIFAR10NaturalInference.py:241-317``).

The NCSN++ VP backbone (a converted ``checkpoint_8.pth`` via ``--ckpt``,
else random weights from ``--seed``: the same FLOPs), a Natural-Inference
matrix (a learned ``weights/step_*_weight_*.npz`` via ``--weights``, else
the derived DDPM matrix at ``--steps``), and N images in micro-batches.
Prints img/s, and writes to ``--outdir`` the first 64 samples as a PNG grid
(PIL), all samples as ``samples_{prov}.npy`` and ``meta.json`` with the
weights' provenance (``prov``: ``converted`` or ``random``).

With ``--fid-stats`` (an npz of ``mu``/``sigma``, the
``cifar10_mu_sigma.npz`` layout) it prints the samples' FID against those
statistics through ``eval.fid.fid_from_samples``, and the Inception's
provenance beside it: ``inception=converted`` from ``--inception
pt_inception-2015-12-05.pth``, else ``inception=random`` (random weights:
the pipeline, not a real FID; the repository holds no such file).

Sampling is data-parallel over ``parallel.make_mesh()`` (every rank of
the process group; one rank without a group): each batch is padded up to a
multiple of the ranks, every rank samples its rows, and the samples are
gathered (JAX ``apps/cifar10_ni.py:179-196``).

Run: ``python -m naturaldiffusion_tpu_torch.apps.cifar10_ni --num 256``.
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import sys
import time

import numpy as np
import torch
from torch.distributed.tensor import DTensor

from ..coeffs import registry
from ..coeffs.matrix import CoeffMatrix
from ..device import resolve_device
from ..engine import NISchedule, natural_inference
from ..engine.graph import GraphedNI
from ..models.ncsnpp import CIFAR10_DDPMPP_CONTINUOUS, NCSNpp
from ..parallel.mesh import (axis_index, axis_size, batch_sharding,
                             fold_in_shard, make_mesh, shard_batch)


def make_sampler(model, matrix: CoeffMatrix, *, micro: int = 64,
                 dtype=torch.bfloat16, device="cuda", graph: bool = False,
                 mesh=None, data_axis: str = "data"):
    """``run(init, noises=None, generator=None) -> samples`` (float32).

    A copy of ``model`` in ``dtype`` on ``device`` predicts eps; the engine
    converts it to x0 with f32 accumulation.  ``init`` [B, 32, 32, 3] runs
    in chunks of ``micro`` images, one after another, when ``micro``
    divides B and is smaller; ``noises`` [n, B, ...] or ``generator``
    supply the injected noises of a stochastic matrix.
    ``run.with_params(state)`` loads another state (a port model's
    ``state_dict()``: the same names and shapes, or ``load_state_dict``
    raises) into the sampler's copy in place, cast to ``dtype``, and
    returns ``run``.

    With ``graph`` (a CUDA device only) each chunk is one replay of a CUDA
    graph of the NI run over ``micro`` images (:class:`..engine.graph.
    GraphedNI`), captured at the first call and kept in ``run.graphed``;
    B must then be a multiple of ``micro``.  A replay reads the weights the
    copy holds at that time.

    ``mesh`` (DP sampling, JAX ``apps/cifar10_ni.py:45-135``): ``init`` is
    a batch-sharded DTensor (``parallel.shard_batch``) or the global batch,
    the same on every rank; each rank samples its own rows, and the output
    is the batch-sharded DTensor of the samples.  Chunking is
    device-aligned: chunk c takes ``micro / shards`` rows of every rank's
    local batch, so nothing moves between ranks (no collective in the
    run).  ``noises`` are the global ones (each rank takes its rows);
    ``generator`` draws this rank's (give each rank its own, e.g.
    ``parallel.fold_in_shard``)."""
    dev = resolve_device(device)
    if graph and (dev.type != "cuda" or not micro):
        raise ValueError("graph=True needs a CUDA device and micro > 0")
    net = copy.deepcopy(model).to(device=dev, dtype=dtype).eval()
    sched = NISchedule.from_matrix(matrix, device=dev)

    def eps_fn(z, t):
        return net(z, t.reshape(1).expand(z.shape[0]))

    def graphed(x, noises, generator):
        if run.graphed is None:
            run.graphed = GraphedNI(eps_fn, sched, x.shape,
                                    prediction_type="eps",
                                    model_dtype=dtype).capture()
        g = run.graphed
        g.load(x, generator)
        if noises is not None:
            g.noises.copy_(noises)
        return g.replay().clone()

    def chunked(init, noises, generator, micro):
        bb = init.shape[0]
        if graph and bb % micro:
            raise ValueError(f"a graphed sampler takes multiples of "
                             f"{micro} images, got {bb}")
        step = micro if micro and bb % micro == 0 and bb > micro else bb
        outs = []
        for c in range(0, bb, step):
            nz = None if noises is None else noises[:, c:c + step]
            if graph:
                outs.append(graphed(init[c:c + step], nz, generator))
                continue
            outs.append(natural_inference(
                eps_fn, sched, init[c:c + step], noises=nz,
                generator=generator, prediction_type="eps",
                model_dtype=dtype))
        return torch.cat(outs)

    @torch.no_grad()
    def run(init, noises=None, generator=None):
        if mesh is None:
            return chunked(init, noises, generator, micro)
        shards = axis_size(mesh, data_axis)
        if isinstance(init, DTensor):
            loc, bb = init.to_local(), init.shape[0]
        else:
            bb = init.shape[0]
            if bb % shards:
                raise ValueError(f"batch {bb} is not a multiple of the "
                                 f"{shards} ranks of {data_axis!r}")
            loc = init.chunk(shards)[axis_index(mesh, data_axis)]
        if noises is not None:
            r = axis_index(mesh, data_axis) * loc.shape[0]
            noises = noises[:, r:r + loc.shape[0]]
        # device-aligned chunks: micro / shards local rows each
        ml = (micro // shards if micro and bb % micro == 0 and bb > micro
              and micro % shards == 0 else 0)
        out = chunked(loc, noises, generator, ml)
        return DTensor.from_local(out, mesh, batch_sharding(
            mesh, out.dim(), data_axis).placements, run_check=False)

    def with_params(state):
        net.load_state_dict({k: torch.as_tensor(v) for k, v in state.items()})
        return run

    run.with_params = with_params
    run.graphed = None
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
    p.add_argument("--ckpt", default=None, help="torch checkpoint_8.pth")
    p.add_argument("--outdir", default="samples")
    p.add_argument("--fid-stats", default=None,
                   help="npz with mu/sigma (cifar10_mu_sigma.npz layout)")
    p.add_argument("--inception", default=None,
                   help="pt_inception-2015-12-05.pth for --fid-stats "
                        "(random weights if omitted: not a real FID)")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    dev = resolve_device(args.device)
    matrix = (CoeffMatrix.load(args.weights) if args.weights
              else registry.derive("ddpm", args.steps))
    model = NCSNpp(CIFAR10_DDPMPP_CONTINUOUS, device=dev, seed=args.seed)
    if args.ckpt:
        from ..models.convert import fill_from_torch, load_torch_checkpoint
        unused = fill_from_torch(model, load_torch_checkpoint(args.ckpt))
        print(f"loaded {args.ckpt} ({len(unused)} unused torch keys)")
    mesh = make_mesh(device=dev)
    ndev = mesh.size()
    run = make_sampler(model, matrix, micro=args.micro, device=dev,
                       mesh=mesh)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    # the injected noises: each rank draws its own rows' stream
    noise_gen = gen if ndev == 1 else fold_in_shard(args.seed, mesh,
                                                    device=dev)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    done = timed = 0
    t0 = None
    images = []
    while done < args.num:
        b = min(args.batch, args.num - done)
        # the tail batch padded to a multiple of the ranks, so that every
        # batch is sharded; the padded rows are dropped below
        pad = -b % ndev
        init = torch.randn((b + pad, 32, 32, 3), generator=gen, device=dev)
        out = run(shard_batch(mesh, init), generator=noise_gen)
        out = out.full_tensor()[:b]
        sync()
        if not torch.isfinite(out).all():
            raise FloatingPointError("non-finite samples")
        images.append(out.float().cpu().numpy())
        done += b
        if t0 is None:              # the first batch warms up
            t0 = time.perf_counter()
        else:
            timed += b
        rate = timed / (time.perf_counter() - t0) if timed else float("nan")
        print(f"{done}/{args.num} ({rate:.1f} img/s steady)", flush=True)
    wall = time.perf_counter() - t0
    images = np.concatenate(images)

    # the weights' provenance in every artifact's name and in a sidecar
    prov = "converted" if args.ckpt else "random"
    os.makedirs(args.outdir, exist_ok=True)
    grid = os.path.join(args.outdir, f"grid_{prov}.png")
    samples = os.path.join(args.outdir, f"samples_{prov}.npy")
    from ..utils.plotting import save_image_grid
    save_image_grid(images[:64], grid)
    np.save(samples, images)
    with open(os.path.join(args.outdir, "meta.json"), "w") as fh:
        json.dump({"weights": prov, "ckpt": args.ckpt, "num": args.num,
                   "steps": matrix.num_step, "seed": args.seed,
                   "wall_s": round(wall, 2)}, fh, indent=1)
    print(f"wrote {grid} and {samples} ({args.num} images, {wall:.1f}s, "
          f"weights={prov})", flush=True)

    if args.fid_stats:
        from ..eval.fid import fid_from_samples
        from ..eval.inception import default_feature_fn
        fid = fid_from_samples(images, args.fid_stats, feature_fn=(
            default_feature_fn(args.inception, device=dev)))
        inception = "converted" if args.inception else "random"
        print(f"FID = {fid:.3f} (inception={inception})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
