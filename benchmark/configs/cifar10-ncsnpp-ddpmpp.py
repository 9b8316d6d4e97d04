"""CIFAR-10 Natural Inference over the NCSN++ DDPM++ net: the system under
test and its check.

The system is the port's sampling entry, ``apps.cifar10_ni.make_sampler``,
over the full-width model (every weight random from the seed, bfloat16,
made on the card) and the DDPM matrix of ``registry.derive("ddpm",
steps)``, graphed (one CUDA graph a micro-batch), with the port's default
route (no route environment variable).  One request is one sweep of
``sweep`` images in micro-batches of ``micro``; its initial noise and
injected noises come from the seed and the request's index and are passed
in.  Each micro-batch is one answer.

The check reruns sampled micro-batches through the plain float32 reference
(``benchmark/reference/ncsnpp.py``, TF32 off) under the DDPM matrix made
anew in NumPy, with the NI sums in float64, on the same inputs and the same
seeded weights, and compares the samples by relative L2.
"""

from __future__ import annotations

import sys
import time

import torch

from benchmark.harness.inputs import rel_l2, request_generator
from benchmark.harness.weights import fill_, model_seed
from benchmark.reference import ncsnpp as ref_ncsnpp
from benchmark.reference import samplers
from benchmark.reference.precision import F32, Precision, no_tf32

WARM = 2 ** 20          # the warm-up request's index: never a window's


def model_kwargs(spec):
    return dict(image_size=spec["image_size"],
                num_channels=spec["num_channels"], nf=spec["nf"],
                ch_mult=tuple(spec["ch_mult"]),
                num_res_blocks=spec["num_res_blocks"],
                attn_resolutions=tuple(spec["attn_resolutions"]))


def request_inputs(spec, traffic, seed, i, device):
    """``(init [sweep, H, W, C], noises [steps, sweep, H, W, C])``."""
    g = request_generator(seed, i, device)
    shape = (traffic["sweep"], spec["image_size"], spec["image_size"],
             spec["num_channels"])
    init = torch.randn(shape, generator=g, device=device)
    noises = torch.randn((spec["steps"],) + shape, generator=g, device=device)
    return init, noises


class Cifar:
    def __init__(self, spec, traffic, seed, device):
        self.spec, self.traffic, self.seed = spec, traffic, seed
        self.device = torch.device(device)
        self.sample = None

    def setup(self, wait_build):
        from naturaldiffusion_tpu_torch.apps.cifar10_ni import make_sampler
        from naturaldiffusion_tpu_torch.coeffs import registry
        from naturaldiffusion_tpu_torch.models.ncsnpp import (NCSNpp,
                                                              NCSNppConfig)
        t0 = time.perf_counter()
        cfg = NCSNppConfig(**model_kwargs(self.spec))
        model = NCSNpp(cfg, device="meta")
        fill_(model, model_seed(self.seed, 0), torch.bfloat16, self.device)
        matrix = registry.derive(self.spec["sampler"], self.spec["steps"])
        t1 = time.perf_counter()
        wait_build()
        t2 = time.perf_counter()
        self.sample = make_sampler(
            model, matrix, micro=self.traffic["micro"], dtype=torch.bfloat16,
            device=self.device, graph=self.device.type == "cuda")
        del model
        # one micro-batch captures the graph and warms it; the whole
        # request's inputs warm the allocator for the window's
        m = self.traffic["micro"]
        init, noises = request_inputs(self.spec, self.traffic, self.seed,
                                      WARM, self.device)
        self.sample(init[:m], noises=noises[:, :m])
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        print(f"[bench] set-up: weights {t1 - t0:.2f} s, build wait "
              f"{t2 - t1:.2f} s, capture and warm micro-batch "
              f"{time.perf_counter() - t2:.2f} s", file=sys.stderr,
              flush=True)

    def run(self, i, spans):
        init, noises = request_inputs(self.spec, self.traffic, self.seed, i,
                                      self.device)
        out = self.sample(init, noises=noises)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return list(out.split(self.traffic["micro"]))

    def images(self, answers):
        return sum(a.shape[0] for a in answers)

    def free(self):
        self.sample = None


class Checker:
    def __init__(self, spec, traffic, seed, device):
        self.spec, self.traffic, self.seed = spec, traffic, seed
        self.device = torch.device(device)
        with torch.device("meta"):
            self.model = ref_ncsnpp.NCSNpp(**model_kwargs(spec))
        fill_(self.model, model_seed(seed, 0), torch.bfloat16, self.device,
              cast=torch.float32)
        self.matrix = samplers.ddpm_matrix(spec["steps"])

    @torch.no_grad()
    def reference_answer(self, key, p: Precision = F32):
        i, j = key
        m = self.traffic["micro"]
        init, noises = request_inputs(self.spec, self.traffic, self.seed, i,
                                      self.device)
        init, noises = init[j * m:(j + 1) * m], noises[:, j * m:(j + 1) * m]

        def eps(z, t):
            tt = torch.full((z.shape[0],), t, device=z.device)
            return self.model(z, tt, p)
        with no_tf32():
            return samplers.natural_inference(eps, *self.matrix, init, noises,
                                              prediction="eps")

    def check(self, answers, keys):
        worst = max(rel_l2(answers[k], self.reference_answer(k))
                    for k in keys)
        return [("sample_rel_l2", worst,
                 self.traffic["limits"]["sample_rel_l2"])]


def make(spec, traffic, seed, device):
    return Cifar(spec, traffic, seed, device)


def make_checker(spec, traffic, seed, device):
    return Checker(spec, traffic, seed, device)
