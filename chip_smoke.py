#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA card and check it.

Run from the root of a checkout, with no arguments: ``python3 chip_smoke.py``
(``--out FILE`` also writes every per-shape number as JSON).  Phases, each
printed as one line with its numbers and seconds as it ends:

  env      the card (``nvidia-smi`` name and power limit), torch and CUDA.
  build    ``nvcc`` builds the kernels of ``naturaldiffusion_tpu_torch/csrc``
           (``ops/_nvcc.py``), started before this script imports torch;
           the phase waits for it and prints each source's own seconds and
           CPU seconds and the registers and spills of every
           conv3x3.cu, qmatmul.cu, attention.cu, attention_bwd.cu,
           group_norm.cu and weighted_sum.cu kernel, and fails if one
           spills.
  kernels  each kernel against its plain PyTorch version on the card, at
           the shapes the main path gives it (recorded from one batch-64
           forward), then timed (CUDA events, median, L2 flushed) beside the
           plain version, one PyTorch library call and the card's bound;
           each timed conv with its tile plan, TFLOP/s and bound share;
           K1 with its achieved GB/s and timed at every row split, also at
           DiT's latent; K6 at the forward's standalone GroupNorms, with its
           form, cluster, bound share and host time a call.  Then the bf16
           conv kernel at ragged shapes of no model.
  int8_kernels  the hand-written int8 conv (``ops.quant.conv3x3_int8``) at
           every 3x3 int8 conv shape of the CIFAR bench's default walk
           (unfused, ``int8_static``) at batch 64, static and dynamic: its
           int8 operands and its output against the plain version bit for
           bit, a seeded fault in one int8 weight, then timed beside its
           bound, the plain version, cuDNN's bf16 conv and
           ``torch._int_mm`` over an im2col of the int8 input, with its
           TOPS, plan (split, blocks) and registers; then bit for bit at
           ragged shapes of its plan (``INT8_RAGGED``).
  quant_ops  ``apps.bench_quant_ops --reps 20 --runs 5``: the W8A8 rows
           (cuDNN bf16, Q1 dynamic, per-tensor, static and on operands
           quantized beforehand) at the CIFAR conv shapes, the 1x1 rows on
           ``torch._int_mm`` and the square GEMM, every row timed or its
           error, Q1's launches; each row at one 3x3 and one NIN shape
           against its plain version on the CPU.
  routes   one batch-64 CIFAR forward in bf16 under each form of the conv
           switch and the int8 modes (``ROUTE_FORMS``) against the f32
           fused forward, with each form's kernel launches.
  forward  one full-width CIFAR-10 NCSN++ forward on 2 images in float32:
           the card (kernels) against the CPU (plain versions).
  slice    the main path: 10-step DDPM Natural Inference over a batch of 64
           in bf16 through ``apps.cifar10_ni.make_sampler``, launch counts
           read around it, img/s, and the first 2 samples against a CPU
           float32 run fed the same noises.
  samplers the sampler families over the CIFAR model as the VP config
           ``vp/cifar10_ddpmpp_continuous``: (a) four direct recursions
           (DDIM, DDPM with the same noises, DPM-Solver++(2S) on its
           deriver's grid, DEIS t-AB order 3) against Natural Inference
           with their derived matrices, f32 through the kernels at batch
           8 and 10 steps, the same time labels on both sides, each beside
           its NI run with the labels 1 % off, and ``apps.validate`` on
           the card (its toy denoisers, 1e-4); (b) two cells of
           ``apps.sweep`` in bf16 (DPM-Solver++ multistep order 2, DEIS
           t-AB order 3), their CSV rows; (c) ``get_pc_sampler`` with the
           config's VPSDE at N = 10 and its euler_maruyama predictor, bf16
           against f32 plain versions on the card beside two controls;
           (d) ``get_ode_sampler`` at rtol = atol = 1e-3, f32, the kernels
           against the plain versions after as many model calls, beside
           its 1 %-off control.  Each drive's launches are checked against
           its forwards' (and NI steps') counts.
  likelihood  (in the oracle process beside ``entry_points``; printed
           after it) ``eval.likelihood.get_likelihood_fn`` (RK45 over the
           probability-flow ODE, the Hutchinson divergence by reverse mode
           through the kernels' autograd Functions) over the same model,
           f32, batch 2, at rtol = atol = 1e-3 (JAX's default 1e-5), eps
           scaled by 0.003, from t = 1e-3: bpd and the latent through the
           kernels against the plain versions with the same probe, the
           same nfe, beside a 1 %-off time control; the model calls replay
           CUDA graphs of its forward and of its backward in x.
  eval     the evaluation modules over the same weights: (a) the FID
           Inception (every leaf random) in f32 on the card against the
           CPU at 32x32, 48x64 and 320x336 (the antialiased resize), pool
           features and logits, then timed at batch 256; (b)
           ``apps.fid_selfcheck.main`` over the full-width CIFAR model at
           512 images and 256 features, its sampling one CUDA-graph
           replay a micro-batch: the app's pass rule, its CSV row, and the
           K1-K3 and K6 launches of the warm-up and capture; (c) PC
           inpainting and colorization (``samplers.controllable``) as the
           VP config at N = 10, batch 8, f32: the kernels against the plain
           versions with the same noises beside a 1 %-off time control,
           the known pixels and the luminance against their inputs, each
           drive's launches; (d) ``apps.quant_accuracy`` at batch 16 in
           ``int8_static`` and ``int8`` under route 0: its report, a
           non-zero int8-against-bf16 gap, Q1's launches.
  train    the score-SDE trainer over the full-width CIFAR model (VPSDE,
           every weight random): (1) the backward of K2, K3 and K6 (their
           autograd Functions) at every distinct signature of the model's
           forward at 2 images, f32 and bf16, against autograd through the
           plain versions with cuDNN off, every input's gradient (K3's
           ``pre`` and skip, with cotangents on its channel sums); (2) one
           f32 loss and gradient of the whole model, the kernels against
           the plain versions with the same draws, beside a control (K3's
           backward with the channel-sum cotangents dropped) that the limit
           must catch, the launches of the forward and of the backward
           (none); (3) 3 optimizer steps (Adam, warm-up, clip, EMA), the
           kernels against the plain versions; (4) ``apps.train`` at batch
           128 for 3 iterations on a ``toy_dataset`` binary in f32 and bf16,
           each with snapshots (in f32 with EMA sample grids), in f32 a
           resumed run against the uninterrupted one and the launches; (5)
           ``apps.bench_train`` at batch 128, f32 and bf16, at conv switch
           2 and 0: step ms, img/s, FLOPs, MFU, peak memory, and one
           profiled step (busy share, top kernels).
  entry_points  the entry points no other phase drives: (a)
           ``apps.fid_stats`` over the train phase's toy eval binary, mu and
           sigma against the CPU's; (b) ``apps.degradation`` at its
           defaults, vp and flow, against the CPU on the same noise; (c)
           ``apps.roundtrip`` over the train phase's f32 snapshots (toy
           features, 64 images a snapshot), its CSV against the plain
           versions' and another seed's, its launches; (d) ``apps.sd3_ni
           --small`` and ``apps.bench_sd3 --toy`` with every MMDiT weight
           random, each run's last NI call in f32 against the plain
           versions (K1, K9) beside K9's output 1 % off, the app's own
           output (bf16 in bench_sd3) against the f32 plain run.
  bench    the port bench, ``apps.bench``, on one ``Bench`` at its
           defaults (1024 images a dispatch in 16 replays of a CUDA graph
           of one 64-image 10-step run): the wrappers' launch counts around
           its build and run (its eager warm-up and its capture); its timed
           dispatches through ``bench.measure``, then one profiled dispatch
           of 2 replays (the card's busy share, and K1, K2, K3 and K6
           counted in the trace); 2 chunks by the eager loop, timed as the
           control; the graph's capture time and pool size; and with random
           weights one chunk graphed against eager with the same init and
           noises, beside two eager runs as the control and a planted
           fault (one resblock conv zeroed in place) that must exceed the
           limit.  The bench's FLOP count, tool_trace's and the profiler's
           first session (its set-up) run during the build phase.
  bench_forms   the port bench in ``bench.py``'s own form (its default:
           unfused convs, ``int8_static``) with one 1024-image dispatch,
           then each of ``BENCH_FORMS`` at 2 micro-batches a dispatch;
           each form's build launches, its JSON line, a traced dispatch of
           2 replays (busy share, device launches) and one chunk graphed
           against eager.
  dit_kernels   kernels K9 (flash attention) and K7 (W8A16 matmul) against
           their plain versions at DiT-XL/2's shapes (and K9 at an
           unaligned t = 250, K7 at ragged M, N = 128 and K = 8192), timed
           as in ``kernels``; K7 per product with its plan (blocks,
           splits), TFLOP/s, bound share, ratio to cuBLAS and the time of a
           per-call repack of the weight.
  dit_forward   one full-width DiT-XL/2 CFG forward (model batch 2) in
           float32: the card (kernels) against the CPU (plain versions),
           then the same under w8.
  dit_slice     the DiT path: ``apps.bench_dit``'s workload, 50-step DDIM
           NI at one image (model batch 2), bf16, modulations hoisted,
           then the same under w8; launch counts, img/min, identical CFG
           halves, and a 10-step bf16 run against an f32 run of the plain
           versions on the card, beside two controls.
  dit_validate  ``apps.validate_dit`` at full width (DDIM, 10 steps, f32) on
           the card: direct recursion against NI within its 1e-3 check.
  parallel      the parallelism slice on the card's 1-rank NCCL mesh: (1)
           K9's and K10's backward kernel (``csrc/attention_bwd.cu``)
           against ``attention_backward_reference`` at the DiT-XL/2 train
           shape, SD3-medium's and the kernel table's lengths and each head
           dim at a ragged T, f32 and bf16, with 1 %- and 5 %-off controls
           that must fail; timed beside the plain version, SDPA's flash
           backward and its bound, forward + backward beside SDPA's, and
           in bf16 the backward run twice on the same inputs with the
           largest difference of dq, dk and dv between the runs; (2)
           three full-width DiT-XL/2 bf16 train steps at batch 32 under
           ``dit_tp_sharding`` and the (data, model, -) token constraint,
           28 K9 and 28 K9-backward calls a step (the phase's main path),
           step ms, busy share, peak memory; one f32 step's whole-model
           gradient at batch 4 against the plain attention's, beside a
           control without dq, with K9 and again with K10 (``splash``);
           (3) ``parallel.dryrun.dryrun_multichip(1)``; (4) ring
           attention's gradient on the 1-rank mesh at DiT-XL/2's attention
           shape against the plain attention's.  The ``train``
           phase also runs the trainer with ``--fsdp`` against the run
           without it.
  ve_kernels    kernels K4 (halo-tiled conv, serving K5 too) and K6
           (GroupNorm) against their plain versions at every shape one
           batch-4 bf16 forward of the full-width CelebA-HQ 256 VE NCSN++
           gives them, f32 and bf16, then timed as in ``kernels``; K6 also
           in the form its plan does not pick at a few shapes, and at
           ragged shapes of no model, each row with its form, cluster,
           bound share and host time a call.
  ve_forward    one full-width VE NCSN++ forward at one image in float32:
           the card against the CPU; then one level-0 resblock in its
           unfused form (the path's) against its fused form, timed, and
           which form is faster.
  ve_slice      the VE path: ``get_pc_sampler`` (reverse diffusion +
           Langevin, snr 0.075) over the full-width model in bf16 at batch
           4, with N = 2 steps instead of the config's 2000; launch
           counts, img/s, MFU, the card's busy share, and the samples
           against an f32 run of the plain versions on the card beside two
           controls, and the kernels in f32 against the same run.
  backbones     the zoo's other families, built from their entries by
           ``models.create_model``: (a) the CIFAR-10 DDPM
           (``vp/ddpm/cifar10``) under 10-step DDPM NI, batch 64, bf16,
           through ``cifar10_ni.make_sampler``, eager and graphed, each
           drive's K1, K2 and K6 launches against the model walk's, graph
           against eager, 2 samples in f32 and bf16 against a CPU f32 run
           beside the slice's two controls, img/s; each of its K2 and K6
           shapes against the plain versions, and its Q1 shapes under
           int8_static bit for bit; (b) one bf16 forward of the CelebA-HQ
           256 DDPM, its K4, K2 and K6 shapes checked, the largest K4 shape
           timed; (c) NCSNv2 and NCSN at 32^2 in f32, card against CPU,
           NCSNv2_128 at 128^2 in bf16 against f32, and annealed Langevin
           over NCSN through ``get_pc_sampler`` (its 10 sigmas, 2 steps
           each instead of 100, batch 8); (d) one forward of the 1024^2
           NCSN++ (``ve/celebahq_ncsnpp_continuous``) in bf16 and f32
           against the f32 plain versions beside a 1 %-off control, its
           launches and ms, every kernel shape checked (the C < 128 convs
           at 256^2-1024^2 on K2), the largest K2 shape and K6 at 1024^2 x
           16 in 4 groups timed.
  sd3      the SD3 path through ``pipeline.SD3Pipeline`` at SD3-medium's
           full width (hidden 1536, depth 24, 24 heads of 64), 1024^2,
           bf16, every model made on the card from seeds: random ids
           through ``encode_prompt`` (CLIP-L, CLIP-G, T5-XXL: 77 + 256
           context tokens, t = 4429); K9 on the model's own q, k, v
           against its plain version, timed beside SDPA; one forward in
           f32 (K9) against the plain versions at 1e-4, and one forward
           and a 3-step NI in bf16 against the f32 plain versions within
           1.5x the bf16 plain control, a 1 %-off time control above it;
           then one image, warm: ``encode_prompt``, ``__call__`` over the
           28-step Euler matrix and the VAE decode at 1024^2, its K1 and
           K9 launches counted, wall, sec/image and one CFG forward
           profiled (busy share, K9's share); 3 steps under w8 (K7 on the
           144 latent-stream products a forward).
  tool_kernels  kernel K10 (splash attention, with its logsumexp) against
           its plain version at SD3's three joint lengths, ``mha_joint``
           against one full softmax per row and profiled in a fresh child
           process, which must list K10; kernel K8 (fused leaky ReLU)
           bit for bit against its plain version; each timed as in
           ``kernels``, K9 and K10 at each length beside SDPA's flash
           backend.  K8's path: its wrapper at the level-0
           activations of the CIFAR and VE models (no app calls K8, as in
           the JAX package).
  attention_bench  ``apps.bench_attention`` at its defaults (t = 4096,
           4250, 4429; batch 2, 24 heads of 64, bf16): the path of K10.
  tool_trace    ``apps.bench_dit --toy --steps 10 --trace --count-flops``
           on the card, its trace read by ``utils.trace_summary``;
           ``apps.bench_conv --shapes 1``.
  conv_model    ``apps.bench_conv --model ve/celebahq_256_ncsnpp_continuous``
           at one forward a run, 2 runs a route.

The CPU oracles of ``slice``, ``dit_forward``, ``ve_forward``,
``backbones`` and ``entry_points`` run in a child process beside the
card's phases.  Any
failure raises and exits non-zero.  The last two lines are the kernels
JSON and ``{"ok": true, "device": {...}}``.  Imports no JAX.
"""

from __future__ import annotations

import argparse
import atexit
import concurrent.futures
import contextlib
import copy
import functools
import importlib
import io
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time

BUDGET_S = 300          # whole run, build included
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"torch.bfloat16": 989e12, "torch.float32": 67e12}
BATCH, STEPS, SEED = 64, 10, 0
SPIN_CYCLES = 2_000_000     # ~1 ms at the H100's ~1.98 GHz SM clock

# tolerances of a kernel against its plain version on the same inputs
# float32: the same f32 products summed in another order (~1e-6 relative)
F32_TOL = 1e-4
# bfloat16 outputs: one bf16 rounding (2^-8 relative) of nearly equal f32
# values may land on either side
BF16_TOL = 1e-2
# channel sums of <= 1024 f32 values, atomics in any order: relative to
# the sum of magnitudes (the sums are of the f32 value in both types)
STATS_TOL = 1e-4
# full-width forward, f32 card vs f32 CPU: 44 resblocks of f32 sums in
# other orders; relative L2
FORWARD_TOL = 1e-4
# 10-step NI, bf16 card vs f32 CPU, relative L2: sound runs of the
# kernels read 3.9e-3 on an H100, and so does the same run through the
# plain versions in bf16 on the card (the "control" numbers of the slice
# phase); 2e-2 is five times that, so a fault of a few percent anywhere in
# the slice shows
SLICE_TOL = 2e-2
# the same run in f32 on the card: f32 forward differences (~1e-6) grow by
# 1/alpha (~160 at t=999) in eps -> x0; relative L2
SLICE_F32_TOL = 1e-3
# the port bench at its defaults: 1024 images a dispatch, 16 replays; its
# eager control over 2 chunks (128 images), and one dispatch of 2 replays
# profiled: tracing all 16 replays made the phase take 96.5 s on an H100,
# most of it the profiler's processing of their kernels
BENCH_TOTAL = 1024
# timed 1024-image dispatches of the bench phase, and timed runs of the
# bench's eager control and of each DiT slice mode (medians; 5, 3 and 3
# until the samplers phase came: the run's time limit)
BENCH_DISPATCHES = 1
BENCH_EAGER_RUNS = 1
DIT_TIMED_RUNS = 1
BENCH_CHUNKS_EAGER = 2
BENCH_CHUNKS_TRACED = 2
# a trace of graph replays can lose device records, never add one (two
# H100 runs read 5 and 22 of K1/K2/K3/K6's 2,080 launches short, with the
# wrappers' counts right): a dispatch whose trace counts fewer launches
# than its graph holds is profiled again, up to this many traces in all,
# and one trace must count them exactly
BENCH_TRACE_TRIES = 3
# one 64-image chunk of the bench with random weights (randomize_), the
# CUDA graph's replay against the eager loop with the same init and noises,
# relative L2: K3's channel sums and K6 add by f32 atomics in any order, so
# two eager runs of the same inputs differ in last f32 bits, which flip bf16
# roundings, and after 10 steps of random weights any such flip has spread
# to the floor of bf16 itself: on an NVIDIA H100 80GB HBM3 two eager runs
# read 2.95e-3, two replays 2.96e-3, the graph against eager 2.98e-3 (on
# the CPU a 1.01 scale of one conv's weights moved 4-step samples 3e-3);
# the limit is 3.4x that control.  A stale input, a wrong noise or a replay
# of the wrong buffers moves the samples by O(1); the phase zeroes the
# first resblock's Conv_1 (BENCH_FAULT_CONV, a K3 at 32 x 32 x 128) in
# place, which moved a replay 0.150 there (5.0e-8 at NCSN++'s own init,
# whose zeroed Conv_1s leave eps ~1e-5 of the sample), and checks that it
# passes the limit.  A fault in one deep 4 x 4 resblock (3e-3 to 4e-3 on
# the CPU) is inside the bf16 floor and this check cannot see it
BENCH_GRAPH_TOL = 1e-2
BENCH_FAULT_CONV = "layers.m3.Conv_1"
# the forms of the route switch and the int8 modes: (NATDIFF_PALLAS_CONV,
# NATDIFF_QUANT) of the routes phase's batch-64 forwards, each held against
# the f32 fused forward at the limits of the JAX package's int8 model test
# (tests/test_quant.py:89-94: relative L2 < 5e-2, cosine > 0.99), beside
# the bf16 fused form's reading (the bf16 control)
ROUTE_FORMS = (("2", ""), ("1", ""), ("0", ""), ("0", "int8"),
               ("0", "int8_static"), ("0", "int8_all_static"))
ROUTES_REL, ROUTES_COS = 5e-2, 0.99
# the bench's own default form, bench.py's (one full 1024-image dispatch),
# and the other forms (NATDIFF_PALLAS_CONV, BENCH_QUANT, BENCH_MODS), each
# at BENCH_FORM_CHUNKS micro-batches a dispatch; the fused bf16 form is the
# bench phase's
BENCH_DEFAULT_FORM = ("0", "int8_static", False)
BENCH_FORMS = (("0", "", False), ("1", "", False), ("0", "int8", False),
               ("0", "int8_all", False), ("0", "int8_all_static", True))
BENCH_FORM_CHUNKS = 2
# timed dispatches of each of BENCH_FORMS (bench.measure's median; 5 until
# the samplers phase came: the run's time limit)
BENCH_FORM_DISPATCHES = 1
# the H100's dense int8 tensor-core rate (data sheet), operations/s
INT8_PEAK = 1979e12
# int8 conv shapes of no model, [B, H, W, Cin] -> Cout: batches that are no
# multiple of the images a unit holds at 4x4 and 8x8 (split-K clusters of
# 2), one image at 16x16 (a partial wave, split 2), Cin = 384 under
# split-K (clusters of 3), ragged 2-D tiles in a launch of 36 blocks and
# in a persistent one
INT8_RAGGED = (((3, 4, 4, 256), 256), ((3, 8, 8, 256), 256),
               ((1, 16, 16, 256), 256), ((64, 8, 8, 384), 256),
               ((3, 20, 28, 128), 256), ((48, 24, 24, 128), 256))
# images per second of the CIFAR slice before this script's phases ran K6
# on it (PERF.md section 6: 69.05 on an NVIDIA H100 80GB HBM3 at 700 W)
CIFAR_IMG_PER_S_BEFORE_K6 = 69.05

# the samplers phase: the CIFAR model above as vp/cifar10_ddpmpp_continuous
SAMPLERS_CONFIG = "vp/cifar10_ddpmpp_continuous"
SAMPLERS_BATCH, SAMPLERS_STEPS = 8, 10
# NI with a sampler's derived matrix against the sampler's own recursion,
# both f32 through the kernels on the same model, time labels and noises:
# K1's weighted sums against the recursion's axpys, f32 sums in another
# order; relative L2; the f32 limit of ve_slice.  Sound runs read
# 3.9e-7 to 5.4e-7 on an H100.  Each pair's control (the NI run with its
# time labels 1 % off, 5.5e-2 to 8.3e-2 there) must read at least
# CONTROL_FACTOR times the limit
NI_PAIR_TOL = 1e-3
CONTROL_FACTOR = 10
# two cells of apps.sweep in bf16: (family, --only); one batch of 64, so
# the app's steady-state img/s (the first batch excluded) is nan, and the
# phase times the cell's call itself
SWEEP_CELLS = (("dpmsolverpp", "multistep:2"), ("deis", "t:t_ab:3"))
SWEEP_NUM, SWEEP_BATCH = 64, 64
# VP PC sampling (euler_maruyama + none, the config's) at N = 10 of 1000,
# bf16 kernels against the f32 plain versions on the card, relative L2 of
# the samples, set as ve_slice's limits before the first reading: sound
# runs read 3.9e-3 on an H100 (the plain versions in bf16 the same), the
# time 1 % off 7.7e-2, the f32 kernels 7.4e-7
VP_PC_STEPS = 10
VP_PC_TOL = 3e-2
VP_PC_F32_TOL = 1e-3
# the probability-flow ODE sampler at rtol = atol = 1e-3 (JAX's default
# 1e-5), batch 2, f32: the kernels against the plain versions on the card,
# relative L2, after the same number of model calls on both sides (the
# adaptive steps of a sound run accept the same step sizes, as the NI pairs
# see the same labels).  Sound runs read 4.0e-7 to 9.2e-7 on an H100 with
# 85 calls on both sides; the time 1 % off reads 1.02e-2, and must read at
# least CONTROL_FACTOR times the limit, so 1e-4 (over 100x the sound
# readings) sees a 1 % fault.  More than ODE_MAX_NFE model evaluations
# fails the phase
ODE_RTOL, ODE_BATCH, ODE_TOL, ODE_MAX_NFE = 1e-3, 2, 1e-4, 500
# the likelihood phase: eval/likelihood.py's probability-flow bits/dim
# (RK45 over the augmented ODE, the Hutchinson divergence by reverse mode
# through K2/K3/K6's autograd Functions) over the same model as the VP
# config, f32, at the ode check's cut (rtol = atol = ODE_RTOL, batch
# ODE_BATCH; JAX's default is 1e-5), data uniform in [-1, 1] and one
# Rademacher probe from seeds: the kernels against the plain versions on
# the card with the same probe, bpd (relative) within ODE_TOL, z (relative
# L2) within LIK_Z_TOL, the same nfe; the plain versions with the time
# labels 1 % off must move z by at least CONTROL_FACTOR times its limit and
# bpd past its own.
# Two more cuts: the model's eps is scaled by LIK_EPS_SCALE and the ODE
# starts at LIK_T0 (JAX's 1e-5).  With every weight random, the ODE's
# encoding direction (data to noise) expands small differences: unscaled,
# the kernels' and the plain versions' z lay 42 % apart after 265 model
# calls each, bpd 1.8e-3 apart beside a control of 1.9e-3, so no check
# could see a fault (an H100, this script before the cuts); in
# likelihood_scan.py's runs the cut run held z of the kernels within 1e-5
# of the plain versions', where eps scaled alone still moved it up to
# 2e-3 from one scale to the next.  Each model call replays a CUDA graph
# of the model's forward or of its backward in x (GraphedVJP; the
# parameters take no gradient); eager, an nfe's two forwards and backward
# cost ~0.17 s of host time
LIK_SEED, LIK_EPS_SCALE, LIK_T0 = SEED + 80, 0.003, 1e-3
# z, the state after ~67 adaptive steps, varies from run to run with the
# order of K3's f32 channel sums (atomics): 9.4e-6 (likelihood_scan.py)
# and 4.5e-5 (this script) against the plain versions on an H100; its
# limit, with the control at CONTROL_FACTOR times it (the control reads
# ~0.2)
LIK_Z_TOL = 1e-3

# the eval phase.  (a) The FID Inception (pytorch-fid's InceptionV3, every
# leaf random, its BatchNorms too) in f32 on the card against the CPU, at
# these [N, H, W] inputs: CIFAR images, a rectangle, and one larger than
# 299 (the antialiased resize); relative L2 of pool features and logits:
# ~95 convs and a dense head of f32 sums in other orders, TF32 off, as
# FORWARD_TOL; sound runs read 1.4e-7 (pool) and 3.5e-7 to 5.3e-7
# (logits) on an H100.  Its features are then timed at EVAL_FEAT_BATCH
EVAL_INCEPTION_SIZES = ((4, 32, 32), (1, 48, 64), (1, 320, 336))
INCEPTION_TOL = 1e-4
EVAL_FEAT_BATCH = 256
# (b) apps.fid_selfcheck on the full-width CIFAR model (random weights, its
# graphed sampling), cut from 50,000 images and 2048 features to 512 and
# 256 (the run's time limit: 4,096 images took 18.7 s of the phase on an
# H100, 2,048 9.6 s; 1,024 since the train phase came, 512 since the
# likelihood and entry-point phases came); the pass rule is the app's
# (self FID < 2, shifted / self > 50): 1,024 images read a ratio of 8,372
# there, 2,048 15,790, 4,096 30,830
EVAL_SELFCHECK_ARGS = ("--num", "512", "--batch", "512", "--micro", "64",
                       "--feat-dim", "256", "--feat-batch", "256")
# the graphed branch of apps.cifar10_ni.make_sampler, which the self-check
# samples through, against its eager branch over the same model (bf16,
# 10-step DDPM NI, BATCH-image micro-batches) on EVAL_GRAPH_CHUNKS
# micro-batches of one init with the same explicit noises, each
# micro-batch's relative L2 at the bench's BENCH_GRAPH_TOL (the same run:
# the bench holds its own graph there); BENCH_FAULT_CONV zeroed in the
# sampler's copy must move every micro-batch past it, and the generator's
# noises, drawn per replay, must move two micro-batches of one init apart
# by as much
EVAL_GRAPH_CHUNKS = 2
# (c) PC inpainting and colorization over the CIFAR model as
# SAMPLERS_CONFIG, with its sampling (euler_maruyama + none) at N = 10 of
# 1000 (the reverse-diffusion and Langevin steps need N >= 20: the VP
# discretisation's largest beta, beta_max / N, must stay under 1), batch 8,
# f32: the kernels against the plain versions on the card with the same
# noises, relative L2, set before the first reading from VP_PC's f32
# reading (7.4e-7); sound runs read 7.7e-7 and 8.2e-7 on an H100, the
# time 1 % off 7.7e-2 and 7.4e-2, which must read CONTROL_FACTOR times
# the limit.  The known pixels (inpainting) and the luminance channel
# (colorization) of the samples against their inputs, absolute: the last
# projection sets them to the marginal mean at t = 1e-5 (5e-7 of the
# data), and the colorizer's couple / decouple round trip adds f32
# roundings of samples of magnitude ~260 (1.7e-5 there)
EVAL_CTRL_STEPS, EVAL_CTRL_BATCH, EVAL_CTRL_TOL = 10, 8, 1e-4
EVAL_KNOWN_TOL = 1e-4
# (d) apps.quant_accuracy at batch 16 in each of these modes, under the
# JAX package's route 0 (the app's), every weight random
EVAL_QUANT_BATCH, EVAL_QUANT_MODES = 16, ("int8_static", "int8")

# N = 2 PC steps of the config's 2000 (10 until the samplers phase came:
# the run's time limit; the limits below were read at N = 10)
VE_CONFIG, VE_BATCH, VE_STEPS = "ve/celebahq_256_ncsnpp_continuous", 4, 2
# XLA's cost analysis of the JAX package's forward of this model at one
# image: 529 GFLOP
VE_FLOP_PER_IMAGE = 529e9
# full-width VE forward, f32 card vs f32 CPU, relative L2: 49 resblocks of
# f32 sums in other orders, as FORWARD_TOL
VE_FORWARD_TOL = 1e-4
# PC sampling, bf16 kernels vs f32 plain versions on the card, relative
# L2 of the samples: at N = 10 a sound run read 1.69e-2 on an H100, and so
# did the plain versions in bf16 (1.68e-2).  The random-weight score moves
# the state by sigma x its output at every step, so the samples carry the
# forward's bf16 error whole; the time 1 % off read only 1.83e-2, so this
# check cannot see a small conditioning fault, and the f32 check below is
# the tight one.  3e-2 is 1.8x the sound reading
VE_SLICE_TOL = 3e-2
# the same sampling with the kernels in f32 against the f32 plain versions:
# the f32 forward agrees to ~3e-6 (ve_forward); relative L2
VE_SLICE_F32_TOL = 1e-3

# the backbones phase: the zoo's other families, each built from its entry
# through models.create_model with every weight random.  (a) Ho et al.'s
# CIFAR-10 DDPM (nf 128, ch_mult (1,2,2,2), 2 blocks a level, attention at
# 16^2) under 10-step DDPM NI at batch 64 in bf16, graphed and eager; a
# forward at the port's default switch runs its 44 resblock convs, 3
# upsampling convs, stem and head on K2 (the JAX package has no fused form
# of this block, so no K3) and its 44 resblock, 4 attention and 1 head
# GroupNorms on K6; under int8_static the 47 convs whose channel counts
# are multiples of 128 run Q1
DDPM_CONFIG = "vp/ddpm/cifar10"
DDPM_PER_FORWARD = {"fused_weighted_sum": 0, "conv3x3": 49, "conv3x3_gn": 0,
                    "conv3x3_tiled": 0, "fused_group_norm": 49}
DDPM_INT8_PER_FORWARD = 47
# (b) the CelebA-HQ 256 DDPM (ch_mult (1,1,2,2,4,4)), one bf16 forward at
# one image: its 128-channel convs at 256^2 and 128^2 take K4
DDPM_256_CONFIG = "vp/ddpm/celebahq"
# (c) NCSNv2 and NCSN at 32^2, f32 on the card against the CPU at one image
# (library convs, plain norms: FORWARD_TOL); NCSNv2_128 at 128^2 in bf16
# against the card's f32, relative L2: ~90 library convs of bf16
# operands, set before the first reading at the routes phase's bf16 limit
NCSNV2_CONFIG, NCSN_CONFIG = "ve/ncsnv2/cifar10", "ve/ncsn/cifar10"
NCSNV2_128_CONFIG, NCSNV2_BF16_TOL = "ve/ncsnv2/bedroom", 5e-2
# annealed Langevin of ve/ncsn/*: its 10 sigmas, n_steps_each cut from 100
# to 2 (the run's time limit), batch 8
ALD_STEPS_EACH, ALD_BATCH = 2, 8
# (d) the 1024^2 NCSN++ (nf 16, ch_mult (1,2,4,8,16,32,32,32)): one forward
# at one image, bf16 kernels against the f32 plain versions on the card,
# relative L2, set before the first reading at the routes phase's bf16
# limit; the f32 kernels against the same at FORWARD_TOL
NCSNPP_1024_CONFIG, NCSNPP_1024_TOL = "ve/celebahq_ncsnpp_continuous", 5e-2

DIT_MODEL, DIT_STEPS, DIT_ACC_STEPS, DIT_CFG_SCALE = "DiT-XL/2", 50, 10, 4.0
# full-width DiT-XL/2 forward, f32 card vs f32 CPU, relative L2: K9's f32
# path (bf16 hi/lo splits, ~1e-5 per call) and f32 sums in other orders
# through 28 blocks; sound runs read 9.3e-6 on an H100
DIT_FORWARD_TOL = 1e-4
# the same under w8: each QDense rounds its activations to bf16, so the
# forward is a bf16 computation, and last-bit f32 differences flip whole
# bf16 steps; sound runs read 6.2e-3 on an H100 (quantization itself moves
# the output 1.2e-2, printed beside it); 2e-2 is 3x that, while a wrong
# tile, scale or bias of K7 moves the output by O(1)
DIT_W8_FORWARD_TOL = 2e-2
# 10-step DiT NI, bf16 kernels vs f32 plain versions on the card, rel L2:
# sound runs read 3.6e-2 on an H100, and so does the same run through the
# plain versions in bf16 on the card; the kernels with the time 1 % off
# read 0.36; 0.1 sits 2.8x above the sound runs and 3.6x below that fault
DIT_SLICE_TOL = 1e-1

# SD3-medium through SD3Pipeline at 1024^2 (latent 128), bf16: the
# 28-step Euler matrix (the pipeline's default), CLIP's 77 tokens and T5's
# 256 (t = 4096 + 333), one image; one CFG forward profiled SD3_PROFILED
# times over; the check's NI and the w8 run take SD3_ACC_STEPS steps
SD3_STEPS, SD3_ACC_STEPS, SD3_PROFILED = 28, 3, 3
SD3_CLIP_LEN, SD3_T5_LEN = 77, 256
# one SD3-medium CFG forward in f32, K9 against the plain versions on the
# card (TF32 off), relative L2: K9's f32 path (bf16 hi/lo splits, ~1e-5 a
# call) through 24 blocks, as DIT_FORWARD_TOL
SD3_FORWARD_TOL = 1e-4
# bf16 through the kernels against the f32 plain versions, relative L2, at
# most this many times the same run through the plain versions in bf16
# (bf16's own floor at these random weights); the kernels with the time
# 1 % off must land above that limit
SD3_CONTROL_FACTOR = 1.5
# one QDense of each of SD3-medium's latent-stream product shapes (M = 2 x
# 4096 rows; K x N 1536 x 1536, 1536 x 6144 and 6144 x 1536), where K7 is
# held against its plain version on the first block's own weights and
# activations under w8
SD3_K7_LAYERS = ("attn_to_q", "ff_net_0_proj", "ff_net_2")

# K7 at shapes of no model: ragged M (16 and 272 rows: a part-filled row
# tile), the narrowest N and the deepest K that qmatmul_ok admits
K7_EDGE_SHAPES = ((16, 1152, 1152), (272, 4608, 1152), (512, 8192, 128),
                  (16, 8192, 128))

# split counts at which each DiT-XL/2 product is also timed, beside the
# plan's own
K7_SPLITS_TIMED = (1, 2, 3, 4, 6)

# SD3-medium's joint attention: 24 heads of 64 over 4096 latent tokens and
# 154 context tokens, batch 2
SD3_B, SD3_H, SD3_LAT, SD3_CTX, SD3_D = 2, 24, 4096, 154, 64
# the joint lengths of bench_attention: latent alone, + CLIP's 154, + T5's
# 333 context tokens
SD3_LENGTHS = (SD3_LAT, SD3_LAT + SD3_CTX, SD3_LAT + 333)
# K10's logsumexp in f32: the hi/lo bf16 split keeps ~16 bits of each
# operand, so scores of magnitude ~1 are off by ~1e-5; absolute
LSE_TOL = 1e-4
# mha_joint against one f32 softmax per row, relative L2: f32 pieces and
# the f32 kernel (~1e-5)
JOINT_F32_TOL = 1e-4
# the same in bf16: the kernel block and the result round to bf16 (2^-9
# each) and P enters the products in bf16; the CPU test measured JAX's own
# bf16 split softmax at 3.8e-3 from its f32 run; relative L2
JOINT_BF16_TOL = 1e-2
# K8 at the level-0 activations of the CIFAR model (batch 64) and the VE
# model (batch 4), 900 rows (not a multiple of the TPU kernel's 512-row
# tile), and rows of 3 and 12 channels (shorter than, or not a multiple of,
# a 16-byte vector: the kernel's scalar form)
K8_PATH_SHAPES = ((64, 32, 32, 128), (4, 256, 256, 128))
K8_CHECK_SHAPES = K8_PATH_SHAPES + ((3, 300, 128), (5, 7, 3), (2, 9, 12))

# K6 at shapes of no model, both forms: C = 12 in 3 groups and C = 16 in 4
# (slices narrower than a 16-byte vector or a 32-byte sector), 7 x 5 maps,
# one sample, extra-bias rows 1 and B
K6_RAGGED = (((1, 7, 5, 12), 3, "silu", 1), ((1, 7, 5, 16), 4, None, None),
             ((2, 7, 5, 16), 4, "silu", 2), ((3, 7, 5, 12), 3, None, 1))
# the forms K6 also runs in (checked and timed) where its plan picks one:
# each form after it, for a unit that fits an on-chip cluster fits the
# grid, and every shape fits the streamed form
K6_OTHER = {"onchip": ("grid", "streamed"), "grid": ("streamed",),
            "streamed": ()}
# VE shapes at which K6 also runs in its other forms: the grid form picked
# at the 256 x 256 maps and the streamed form; the on-chip form cannot be
# forced at those, a unit of them exceeds a cluster
K6_FORCED = (((4, 256, 256, 128), 32, "silu", 4),
             ((4, 128, 128, 384), 32, "silu", None),
             ((4, 128, 128, 128), 32, "silu", 4),
             ((4, 64, 64, 384), 32, "silu", None),
             ((4, 16, 16, 256), 32, None, None))
# DiT-XL/2's NI sum at one image: the latent [1, 32, 32, 4], the last of
# 50 steps (50 x rows, 51 eps rows)
K1_DIT = (4096, 50, 51)

# the train phase: the score-SDE trainer on the full-width CIFAR model
# (CIFAR10_DDPMPP_CONTINUOUS, VPSDE), every weight random (randomize_).
# (1) each training kernel's backward (K2, K3, K6 as autograd Functions,
# their backward autograd through a library twin, cuDNN on) at every
# distinct K2/K3/K6 signature of the model's forward at TRAIN_CHECK_BATCH
# images, f32 and bf16, against autograd through the plain versions with
# cuDNN off, the same random cotangents on every output (K3's channel sums
# too); relative L2 of each input's gradient: f32 sums in other orders
# (~1e-6) at F32 limit GRAD_F32_TOL; in bf16 the twin's backward convs round
# their outputs to bf16 where the plain version's run in f32, so each
# gradient is held at GRAD_BF16_TOL beside a control, the plain version's
# bf16 gradient against its f32 one
TRAIN_CHECK_BATCH = 2
GRAD_F32_TOL, GRAD_BF16_TOL = 1e-4, 2e-2
# (2) one f32 loss and gradient of the whole model at TRAIN_MODEL_BATCH
# images (the check batch: cuDNN makes a plan per new shape), the same
# draws (t, z), through the kernels against the plain versions on the card
# (TF32 off): the loss relative, the gradient's global relative L2.  The
# control, K3's backward with its channel-sum cotangents dropped (the
# statistics feed every following GroupNorm), must land above the gradient
# limit
TRAIN_MODEL_BATCH = TRAIN_CHECK_BATCH
TRAIN_LOSS_TOL, TRAIN_GRAD_TOL = 1e-5, 1e-4
# (3) TRAIN_OPT_STEPS optimizer steps (Adam, warm-up 2, clip 1.0, EMA) at
# TRAIN_MODEL_BATCH from one state, kernels against plain versions, the
# same draws; relative L2 over all leaves of the parameters' and the EMA's
# moves from the initial state and of Adam's moments: the gradients' f32
# differences (~1e-5) pass through Adam's normalisation
TRAIN_OPT_STEPS, TRAIN_OPT_TOL = 3, 1e-3
# (5) apps.train at batch 128 for TRAIN_APP_ITERS iterations on a
# toy_dataset binary, f32 and --bf16, each with snapshots at iterations 1
# and 2 (in f32 each with its EMA sample grid by the PC sampler, cut to
# TRAIN_SAMPLE_STEPS of 1000 steps); in f32 then a second run whose
# checkpoints-meta is the step-2 snapshot, resumed to the end, against the
# uninterrupted run (the resume's code is the same for both types): the
# same step, and the state within the run-to-run floor of the card (K3's
# channel sums and K6's grid forms add by f32 atomics in any order, so two
# runs of the same step differ in last bits: ~1e-7 in f32, ~1e-4 in bf16);
# relative L2 over all leaves
TRAIN_APP_BATCH, TRAIN_APP_ITERS, TRAIN_SAMPLE_STEPS = 128, 3, 2
TRAIN_RESUME_TOL = 1e-5
# (6) apps.bench_train at batch 128, f32 and bf16, under the port's switch 2
# (K3, K2, K6) and 0 (cuDNN forward, K6): one step a timed run, the median
# of 2 runs (3 until the likelihood and entry-point phases came); FLOPs
# per step counted on the CPU before the phase
BENCH_TRAIN_ARGS = ("--batch", "128", "--chain", "1", "--runs", "2")

# the CPU oracles (float32 forwards and samplers on the host that the
# card's runs are held against) run in one child process beside the
# card's phases (a thread would share the main thread's GIL), in this
# order, each with this many intra-op threads of the host's 8 cores: the
# first two are awaited a few seconds after the build, the rest run beside
# host-bound phases (samplers, eval), whose launches need the cores
ORACLE_JOBS = {"forward": 4, "slice": 4, "inception": 2, "fid_stats": 2,
               "dit": 2, "ve": 2, "ddpm": 2, "refinenets": 2}

# the entry-points phase (after train, on its toy data and f32 workdir).
# fid_stats over the toy eval binary (TOY_ARGS: the train phase's), its mu
# and sigma on the card against the CPU oracle's (the Inception's
# FORWARD_TOL: relative L2), a train binary's as the control.  degradation at its defaults, vp and flow, on
# the card: its printed numbers (4 decimals) against the CPU's on the
# card's noise draw within DEG_TOL (P(own > 0.9) is a count of 512: two
# samples across 0.9 move it 3.9e-3), each schedule index 1 % off as the
# control.
# roundtrip over the trainer's snapshots (--features toy), its
# CSV rows against the plain versions' (K1, K2, K3, K6 plain; snapshot 0)
# within RT_TOL relative, beside the control of another sampling seed
# (after 3 steps the model's head is still NCSN++'s zero init, so the
# samples do not depend on the kernels, which run on the path, counted).
# sd3_ni --small and bench_sd3 --toy (the JAX apps' small MMDiTs), each
# run's last NI call captured and repeated in f32 through the kernels and
# the plain versions (K1, K9 plain) within SD3_F32_TOL, K9's output 1 % off
# as the control; the app's own output against the f32 plain run within
# SD3_APP_TOL (bench_sd3 runs its MMDiT in bf16, whose rounding over 28
# steps, 6.4e-3 against the bf16 plain versions on an H100, hides a 1 %
# fault of K9: 7.1e-3)
TOY_EVAL = 128
# fid_stats reads the first FID_STATS_N records: the CPU oracle's
# Inception costs ~0.17 CPU-s an image
FID_STATS_N = 32
TOY_ARGS = ("--n-train", str(TRAIN_APP_BATCH * 10), "--n-eval",
            str(TOY_EVAL))
DEG_TOL = 5e-3
RT_ARGS = ("--features", "toy", "--num", "64", "--batch", "64", "--micro",
           "64", "--eval-n", str(TOY_EVAL))
RT_TOL = 1e-3
SD3_APP_TOL, SD3_F32_TOL = {"sd3_ni": 1e-4, "bench_sd3": 2e-2}, 1e-4
# bench_sd3 --toy's MMDiT (JAX's) holds a 16 x 16 table of positions: with
# patches of 2, latents up to 32
SD3_TOY_LATENT = 32
# the W8A8 micro-bench apps.bench_quant_ops, as the reproduction driver
# runs it; each row at its last 3x3 shape against its plain version on the
# CPU (the int8 rows within one bf16 rounding, bf16 within BF16 limits)
QUANT_OPS_ARGS = ("--reps", "20", "--runs", "5")
# the ring-attention gradient (parallel phase) at DiT-XL/2's attention
# shape, f32, on the card's 1-rank mesh against autograd through the plain
# attention: relative L2 of dq, dk, dv within PAR_GRAD_TOL; sm_scale 1 %
# off as the control
RING_SHAPE = (4, 16, 256, 72)

T0 = time.perf_counter()


def phase(name, t_start, **numbers):
    secs = time.perf_counter() - t_start
    total = time.perf_counter() - T0
    print(f"[{name}] {json.dumps(numbers)} seconds={secs:.3f} "
          f"total={total:.3f}", flush=True)
    if total > BUDGET_S:
        raise TimeoutError(f"over the {BUDGET_S}s budget after {name}")


def randomize_(model, seed):
    """Non-trivial random weights (the JAX init zeroes the residual and head
    convs, which would hide a wrong conv): the port's
    ``models.convert.randomize_``, imported once the checkout is on the
    path."""
    from naturaldiffusion_tpu_torch.models.convert import randomize_ as fill
    return fill(model, seed)


def rel_l2(a, b):
    a, b = a.double().cpu(), b.double().cpu()
    return float((a - b).norm() / b.norm())


class Timer:
    """Median CUDA-event time of one call, the L2 cache flushed before each
    timed run (the main path finds these operands cold).  A ~1 ms device
    spin is queued after the flush, so the wrapper's host time (tens of
    microseconds per launch) is spent while the card is still busy and
    never lands between the two events.  The flush writes, so the timed
    call also pays for writing back up to 50 MB of dirty lines as it
    evicts them; with ``clean`` a read of another 256 MB follows the flush
    and leaves the L2 holding clean lines instead."""

    def __init__(self, torch, reps=7, clean=False):
        self.torch = torch
        self.reps = reps
        self.flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8,
                                 device="cuda")
        self.clean = torch.empty_like(self.flush) if clean else None

    def __call__(self, fn):
        torch = self.torch
        fn()                                   # warm-up
        ts = []
        for _ in range(self.reps):
            self.flush.zero_()
            if self.clean is not None:
                self.clean.sum()
            torch.cuda._sleep(SPIN_CYCLES)
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            fn()
            e.record()
            e.synchronize()
            ts.append(s.elapsed_time(e))
        return statistics.median(ts)


def host_us(torch, fn, n=200):
    """Host microseconds per call of ``fn``: the wall time of ``n`` calls
    issued back to back, the card left to catch up afterwards."""
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(n):
        fn()
    dt = time.perf_counter() - t
    torch.cuda.synchronize()
    return dt / n * 1e6


def device_profile(torch, fn):
    """One synchronised call of ``fn`` under ``torch.profiler``, recording
    the card's activity alone: (wall ms, {device event name: [count,
    ms]}).  The events are summed from the profiler's raw records:
    recording each host op too, and ``key_averages``, which first builds a
    tree of every event, cost ~7 s for a 10-step NI run on an H100."""
    from torch.profiler import ProfilerActivity, profile
    with torch.no_grad(), profile(activities=[ProfilerActivity.CUDA]) as prof:
        tw = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - tw) * 1e3
    kern = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == torch.autograd.DeviceType.CUDA \
                and e.duration_ns() > 0:
            row = kern.setdefault(e.name(), [0, 0.0])
            row[0] += 1
            row[1] += e.duration_ns() / 1e6
    return wall_ms, kern


def top_kernels(kern, top_n=8):
    return [(name[:60], n, ms) for name, (n, ms) in
            sorted(kern.items(), key=lambda kv: -kv[1][1])[:top_n]]


def profiled(torch, fn, top_n=8):
    """Device time, wall time, the card's busy share and the top kernels of
    one synchronised call of ``fn`` (``device_profile``)."""
    wall_ms, kern = device_profile(torch, fn)
    dev_ms = sum(ms for _, ms in kern.values())
    return dict(device_ms=dev_ms, wall_ms=wall_ms,
                busy_share=dev_ms / wall_ms, top=top_kernels(kern, top_n))


def check_close(what, got, want, tol):
    """|got - want| <= tol * (1 + |want|), elementwise; returns the max
    absolute error and the max error relative to max |want|."""
    import torch
    d = (got.float() - want.float()).abs()
    lim = tol * (1.0 + want.float().abs())
    if not torch.isfinite(got.float()).all() or bool((d > lim).any()):
        raise AssertionError(f"{what}: max abs err {float(d.max()):.3e} "
                             f"over tolerance {tol:g} x (1 + |ref|)")
    return float(d.max()), float(d.max() / want.float().abs().max())


def check_stats(what, got, want, mag):
    import torch
    d = (got - want).abs()
    if not torch.isfinite(got).all() or bool((d > STATS_TOL * mag + 1e-6).any()):
        raise AssertionError(f"{what}: stats err {float(d.max()):.3e} over "
                             f"{STATS_TOL:g} x sum|v|")
    return float(d.max())


_ORACLE_CACHE = {}


def _cifar_cpu():
    """The CIFAR model of main() on the CPU (cached in the oracle
    process)."""
    if "cifar" not in _ORACLE_CACHE:
        from naturaldiffusion_tpu_torch.models.ncsnpp import (
            CIFAR10_DDPMPP_CONTINUOUS, NCSNpp)
        _ORACLE_CACHE["cifar"] = randomize_(
            NCSNpp(CIFAR10_DDPMPP_CONTINUOUS, device="cpu"), SEED).eval()
    return _ORACLE_CACHE["cifar"]


def oracle_job(name):
    """One CPU oracle, in the oracle process, from the seeds the phases use
    (the noises the phases draw on the card drawn there the same way):
    numpy outputs and the CPU seconds."""
    import torch
    torch.set_num_threads(ORACLE_JOBS.get(name, 2))
    torch.set_grad_enabled(False)
    t = time.perf_counter()
    if name == "forward":
        out = _cifar_cpu()(*forward_input(torch))
    elif name == "slice":
        from naturaldiffusion_tpu_torch.coeffs import registry
        init, noises = ni_draws(torch, SEED + 3)
        out = cpu_ni(_cifar_cpu(), registry.derive("ddpm", STEPS),
                     init[:2].cpu(), noises[:, :2].cpu())
    elif name == "inception":
        cpu = inception_model()
        # (pool, logits) of each input, flat
        out = tuple(t for x in inception_inputs(torch)[0] for t in cpu(x))
    elif name == "dit":
        from naturaldiffusion_tpu_torch.models.dit import (
            DIT_CONFIGS, DiT, forward_with_cfg)
        cfg = DIT_CONFIGS[DIT_MODEL]
        cpu = randomize_dit_(DiT(cfg, device="cuda"), SEED + 10).to("cpu")
        torch.cuda.empty_cache()
        x, tt, y = dit_forward_input(torch, cfg)
        out = {}
        for quant in (None, "w8"):
            cpu.set_quant(quant)
            tq = time.perf_counter()
            out[quant] = (forward_with_cfg(cpu, x, tt, y, DIT_CFG_SCALE,
                                           cfg.in_channels).numpy(),
                          time.perf_counter() - tq)
        return out, time.perf_counter() - t
    elif name == "fid_stats":
        import tempfile
        import numpy as np
        from naturaldiffusion_tpu_torch.apps import fid_stats, toy_dataset
        with tempfile.TemporaryDirectory() as d, \
                contextlib.redirect_stdout(io.StringIO()):
            toy_dataset.main(["--out", d, *TOY_ARGS])
            fid_stats.main(["--data", os.path.join(d, "test_batch.bin"),
                            "--out", os.path.join(d, "s.npz"), "--batch",
                            "64", "--limit", str(FID_STATS_N), "--device",
                            "cpu"])
            with np.load(os.path.join(d, "s.npz")) as f:
                out = (torch.from_numpy(f["mu"]),
                       torch.from_numpy(f["sigma"]))
    elif name == "likelihood":
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        return likelihood_run(_cifar_cpu()), time.perf_counter() - t
    elif name == "refinenets":
        out = tuple(model(x, lab) for (_, model), x, lab in
                    refinenet_inputs(torch))
    elif name == "ve":
        out = ve_model(SEED + 20)[1](*ve_input(torch))
    elif name == "ddpm":
        from naturaldiffusion_tpu_torch.coeffs import registry
        init, noises = ni_draws(torch, SEED + 71)
        out = cpu_ni(zoo_model(DDPM_CONFIG, SEED + 70)[1],
                     registry.derive("ddpm", STEPS), init[:2].cpu(),
                     noises[:, :2].cpu())
    else:
        raise KeyError(name)
    if isinstance(out, tuple):
        out = tuple(o.numpy() for o in out)
    else:
        out = out.numpy()
    return out, time.perf_counter() - t


class Oracles:
    """The CPU oracles (ORACLE_JOBS) computed one after another in a child
    process made beside the build, at the lowest CPU priority (at the
    default one its start-up slowed the build's nvcc-bound cores by 8 s,
    and its jobs the host-bound phases); ``get(name)`` waits for one and
    returns ``(output as torch tensors, seconds in the child, seconds
    waited)``.  The child uses the card only to draw the noises and DiT's
    weights as the phases do; it is stopped at exit."""

    def __init__(self):
        import multiprocessing
        self.pool = concurrent.futures.ProcessPoolExecutor(
            1, mp_context=multiprocessing.get_context("spawn"),
            initializer=os.nice, initargs=(19,))
        self.jobs = {n: self.pool.submit(oracle_job, n) for n in ORACLE_JOBS}
        atexit.register(self.stop)

    def submit(self, name):
        """Queue ``name`` (a job of ``oracle_job`` outside ORACLE_JOBS)
        after the jobs queued before it."""
        self.jobs[name] = self.pool.submit(oracle_job, name)

    def get(self, name, raw=False):
        import torch
        tw = time.perf_counter()
        out, secs = self.jobs.pop(name).result()
        wait = time.perf_counter() - tw
        if raw:
            return out, secs, wait
        if isinstance(out, dict):
            out = {k: (torch.from_numpy(v), s) for k, (v, s) in out.items()}
        elif isinstance(out, tuple):
            out = tuple(torch.from_numpy(o) for o in out)
        else:
            out = torch.from_numpy(out)
        return out, secs, wait

    def stop(self):
        procs = list((getattr(self.pool, "_processes", None) or {}).values())
        self.pool.shutdown(wait=False, cancel_futures=True)
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(10)


def phase_env():
    t = time.perf_counter()
    import torch
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    phase("env", t, card=smi, device=torch.cuda.get_device_name(0),
          count=torch.cuda.device_count(), torch=torch.__version__,
          cuda=torch.version.cuda, python=sys.version.split()[0])
    return smi


class EarlyBuild:
    """The kernels' build (``ops/_nvcc.py``, which imports no torch),
    started on a thread before this process imports torch, so that nvcc
    runs beside torch's import and the card's set-up."""

    def __init__(self):
        from naturaldiffusion_tpu_torch.ops import _nvcc
        self.cpu, self.t0 = {}, time.perf_counter()
        self.future = concurrent.futures.ThreadPoolExecutor(1).submit(
            _nvcc.build, cpu_seconds=self.cpu)


def phase_build(early):
    """Waits for the early build, then reads its logs.  ``nvcc_seconds``:
    when each library was ready, from the build's start; ``build_wall_s``:
    the whole build's."""
    t = time.perf_counter()
    from naturaldiffusion_tpu_torch.ops import _cuda
    secs = early.future.result()
    wall = time.perf_counter() - early.t0
    cpu = early.cpu
    ptxas = {}
    for name in secs:
        # the distinct register / shared-memory / spill lines of the source
        log = _cuda.build_dir() / f"{name}.log"
        lines = log.read_text().splitlines() if log.exists() else []
        ptxas[name] = sorted({ln.split(":", 1)[-1].strip() for ln in lines
                              if "registers" in ln or "spill" in ln})
    # ptxas's notes that it serialised wgmma instructions (a slow form)
    wgmma_notes = {name: sorted({ln.strip() for ln in (
        (_cuda.build_dir() / f"{name}.log").read_text().splitlines()
        if (_cuda.build_dir() / f"{name}.log").exists() else [])
        if "wgmma" in ln and "serializ" in ln}) for name in secs}
    wgmma_notes = {k: v for k, v in wgmma_notes.items() if v}
    spills = {}
    for src in PTXAS_CHECKED:
        kern = kernel_ptxas(_cuda.build_dir() / f"{src}.log")
        for fn, regs, spill in kern:
            print(f"  ptxas {src} {fn}: {regs} registers, {spill} bytes "
                  f"spilled", flush=True)
        spills[src] = (len(kern), sum(spill for _, _, spill in kern))
    phase("build", t, build_wall_s=wall, nvcc_seconds=secs,
          nvcc_cpu_seconds=cpu, ptxas=ptxas,
          kernels_and_spill_bytes=spills, wgmma_serialized=wgmma_notes)
    if any(n == 0 or spilled for n, spilled in spills.values()):
        raise AssertionError(f"no ptxas lines, or a kernel spills: {spills}")


# sources whose every kernel instance the build phase lists and holds to
# zero spills
PTXAS_CHECKED = ("conv3x3", "qmatmul", "attention", "attention_bwd",
                 "group_norm", "weighted_sum", "conv3x3_int8")


def kernel_name(mangled):
    """``name<args>`` of a mangled kernel template instance: the
    length-prefixed identifier ending in ``_kernel`` and its integer and
    element-type (f32, bf16) arguments; the mangled name if none is."""
    for m in re.finditer(r"\d+", mangled):
        ident = mangled[m.end():m.end() + int(m.group())]
        rest = mangled[m.end() + len(ident):]
        if ident.endswith("_kernel") and rest.startswith("I"):
            args = re.findall(r"L[ib](\d+)E|(13__nv_bfloat16)|(f)(?=[LE1])",
                              rest[1:rest.find("EEv") + 1])
            return ident + "<" + ",".join(
                a[0] or ("bf16" if a[1] else "f32") for a in args) + ">"
    return mangled


def kernel_ptxas(log):
    """(kernel, registers, spill bytes) of every kernel in a ``ptxas -v``
    log; template arguments read from the mangled name (integers, and the
    element types f and bf16)."""
    out, fn, spill = [], None, 0
    for ln in (log.read_text().splitlines() if log.exists() else []):
        m = re.search(r"Compiling entry function '(\w+)'", ln)
        if m:
            fn = kernel_name(m.group(1))
            spill = 0
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if m and fn:
            spill = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", ln)
        if m and fn:
            out.append((fn, int(m.group(1)), spill))
            fn = None
    return out


def kernel_signatures(model, x, t):
    """Record every kernel call of one forward, with how often each occurs:
    3x3 convs as ``(kind, (x shape, w shape, pre, skip, emit_stats))`` with
    kind ``conv3x3`` (K2), ``conv3x3_tiled`` (K4) or ``conv3x3_gn`` (K3),
    standalone GroupNorms (K6) as ``("group_norm", (x shape, groups, act,
    extra-bias rows or None))``."""
    import torch
    from naturaldiffusion_tpu_torch.models.layers import GroupNorm, PConv3x3
    from naturaldiffusion_tpu_torch.ops import conv3x3 as C
    seen = {}

    def conv_hook(mod, args, kwargs, out):
        sig = (tuple(args[0].shape), tuple(mod.kernel.shape),
               kwargs.get("pre") is not None, kwargs.get("skip") is not None,
               bool(kwargs.get("emit_stats", False)))
        kind = ("conv3x3_gn" if any(sig[2:]) else "conv3x3_tiled"
                if C.large_map(args[0], mod.kernel.shape[3]) else "conv3x3")
        seen[kind, sig] = seen.get((kind, sig), 0) + 1

    def gn_hook(mod, args, kwargs, out):
        eb = kwargs.get("extra_bias")
        sig = (tuple(args[0].shape), mod.num_groups, mod.act,
               None if eb is None else eb.shape[0])
        seen["group_norm", sig] = seen.get(("group_norm", sig), 0) + 1

    hooks = [m.register_forward_hook(
        conv_hook if isinstance(m, PConv3x3) else gn_hook, with_kwargs=True)
        for m in model.modules() if isinstance(m, (PConv3x3, GroupNorm))]
    with torch.no_grad():
        model(x, t)
    for h in hooks:
        h.remove()
    return seen


def conv_inputs(torch, sig, dtype, gen):
    (b, h, w, cin), wshape, pre, skip, _ = sig
    cout = wshape[3]
    dev = "cuda"

    def rn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    x = rn(b, h, w, cin).to(dtype)
    wt = (rn(3, 3, cin, cout) / math.sqrt(9 * cin)).to(dtype)
    bias = (0.1 * rn(cout)).to(dtype)
    pw = (1.0 + 0.2 * rn(b, cin)) if pre else None
    pb = (0.3 * rn(b, cin)) if pre else None
    sk = rn(b, h, w, cout).to(dtype) if skip else None
    return x, wt, bias, ((pw, pb) if pre else None), sk


def conv_cost(sig, itemsize, dtype_name):
    (b, h, w, cin), wshape, pre, skip, stats = sig
    cout = wshape[3]
    flops = 2.0 * b * h * w * 9 * cin * cout
    nbytes = itemsize * (b * h * w * cin + 9 * cin * cout + cout
                         + b * h * w * cout * (2 if skip else 1))
    nbytes += 4 * (2 * b * cin if pre else 0) + 4 * (2 * b * cout if stats else 0)
    bound = max(flops / PEAK_FLOPS[dtype_name], nbytes / HBM_BYTES_PER_S)
    return flops, nbytes, bound * 1e3, ("operations" if flops / PEAK_FLOPS[
        dtype_name] >= nbytes / HBM_BYTES_PER_S else "bytes")


def plan_of(sig):
    """The bf16 tensor-core kernel's tile plan of a conv signature."""
    from naturaldiffusion_tpu_torch.ops import conv3x3 as C
    (b, h, w, cin), wshape, pre, _, stats = sig
    p = C._tile_plan(b, h, w, cin, wshape[3], pre, stats)
    return dict(tile=f"{p['bm']}x{p['bn']}",
                spatial=f"{p['imgs']}x{p['th']}x{p['tw']}",
                blocks=p["grid"][0] * p["grid"][1], smem=p["smem"])


def print_conv_row(kind, r):
    """One timed conv signature: its plan, time, rate and bound share."""
    print(f"  {kind} {r['sig']} x{r['per_forward']}: {r['ms']:.4f} ms "
          f"({r['flops'] / r['ms'] / 1e9:.2f} TFLOP/s, "
          f"{r['bound_ms'] / r['ms']:.3f} of the {r['bound_by']} bound "
          f"{r['bound_ms']:.4f}), plain {r['plain_ms']:.4f}, library "
          f"{r['library_ms']:.4f}; plan {r['plan']}", flush=True)


# shapes of no model: a map that no tile divides (with every option), a
# 3-channel input and output, and a ragged large map through K4's entry
RAGGED_CONVS = (
    ("conv3x3_gn", ((3, 20, 28, 128), (3, 3, 128, 128), True, True, True)),
    ("conv3x3", ((2, 32, 32, 3), (3, 3, 3, 128), False, False, False)),
    ("conv3x3", ((2, 32, 32, 128), (3, 3, 128, 3), False, False, False)),
    ("conv3x3_tiled", ((2, 67, 45, 128), (3, 3, 128, 128), False, False,
                       False)))


def check_conv(torch, C, kind, sig, dtype, gen, what=""):
    """One conv kernel (K2, K3 or K4 by ``kind``) at signature ``sig`` on
    fresh inputs against its plain version with cuDNN off, at F32_TOL or
    BF16_TOL by ``dtype`` and STATS_TOL for the channel sums; returns the
    max absolute and relative errors and the sums' error (0 without
    them)."""
    xx, ww, bb, pre, sk = conv_inputs(torch, sig, dtype, gen)
    kw = dict(pre=pre, skip=sk, skip_rescale=sk is not None,
              emit_stats=sig[4])
    got = (C.conv3x3_gn(xx, ww, bb, **kw) if kind == "conv3x3_gn"
           else getattr(C, kind)(xx, ww, bb))
    with torch.backends.cudnn.flags(enabled=False):
        want = C.conv3x3_gn_reference(xx, ww, bb, **kw)
    got, want = (got, want) if sig[4] else ((got,), (want,))
    tol = BF16_TOL if dtype == torch.bfloat16 else F32_TOL
    err, rel = check_close(f"{what}{kind} {sig} {dtype}", got[0], want[0],
                           tol)
    stats = 0.0
    if sig[4]:
        acc = want[0].float()
        stats = max(
            check_stats(f"{what}{sig} s1", got[1], want[1],
                        acc.abs().sum(dim=(1, 2))),
            check_stats(f"{what}{sig} s2", got[2], want[2],
                        (acc * acc).sum(dim=(1, 2))))
    return err, rel, stats


def check_ragged_convs(torch, C, gen):
    """The bf16 tensor-core kernel at RAGGED_CONVS against the plain
    version, at BF16_TOL and STATS_TOL."""
    out = []
    for kind, sig in RAGGED_CONVS:
        row = dict(kind=kind, sig=repr(sig), plan=plan_of(sig))
        row["err"], row["rel_err"], stats = check_conv(
            torch, C, kind, sig, torch.bfloat16, gen, "ragged ")
        if sig[4]:
            row["stats_err"] = stats
        print(f"  ragged {kind} {sig}: max abs err {row['err']:.3e}, "
              f"plan {row['plan']}", flush=True)
        out.append(row)
    return out


def k1_splits(torch, WS, timer, wx, we, bufx, bufe, lx, le):
    """K1 checked and timed at every row split, the plan's among them."""
    want = WS.fused_weighted_sum_reference(wx, we, bufx, bufe, lx, le)
    ms, err = {}, 0.0
    for split in WS.SPLITS:
        got = WS._launch(wx, we, bufx, bufe, lx, le, split)
        err = max(err, check_close(f"K1 weighted_sum split {split}", got,
                                   want, F32_TOL)[0])
        ms[split] = timer(lambda: WS._launch(wx, we, bufx, bufe, lx, le,
                                             split))
    return dict(ms_by_split=ms, max_abs_err_splits=err)


def phase_kernels(model_bf16, details):
    import torch
    import torch.nn.functional as F
    from naturaldiffusion_tpu_torch.coeffs import registry
    from naturaldiffusion_tpu_torch.ops import conv3x3 as C
    from naturaldiffusion_tpu_torch.ops import weighted_sum as WS

    t = time.perf_counter()
    timer = Timer(torch)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    out = []

    # K1 at the slice's shapes: M = 64*32*32*3, the last step's live rows
    m = BATCH * 32 * 32 * 3
    mat = registry.derive("ddpm", STEPS)
    lx, le = STEPS, STEPS + 1
    wx = torch.tensor(mat.x0[STEPS - 1], dtype=torch.float32, device="cuda")
    we = torch.tensor(mat.eps[STEPS - 1], dtype=torch.float32, device="cuda")
    bufx = torch.randn((STEPS, m), generator=gen, device="cuda")
    bufe = torch.randn((STEPS + 1, m), generator=gen, device="cuda")
    got = WS.fused_weighted_sum(wx, we, bufx, bufe, lx, le)
    want = WS.fused_weighted_sum_reference(wx, we, bufx, bufe, lx, le)
    err, rel = check_close("K1 weighted_sum", got, want, F32_TOL)
    w_cat = torch.cat([wx[:lx], we[:le]]).reshape(1, -1)
    b_cat = torch.cat([bufx[:lx], bufe[:le]])
    nbytes = 4 * ((lx + le) * m + m + lx + le)
    flops = 2.0 * (lx + le) * m
    k1 = dict(
        name="weighted_sum", route="cuda",
        source="naturaldiffusion_tpu_torch/csrc/weighted_sum.cu",
        replaces="naturaldiffusion_tpu/ops/weighted_sum.py:57",
        max_abs_err=err, max_rel_err=rel,
        ms=timer(lambda: WS.fused_weighted_sum(wx, we, bufx, bufe, lx, le)),
        plain_ms=timer(lambda: WS.fused_weighted_sum_reference(
            wx, we, bufx, bufe, lx, le)),
        bound_ms=max(nbytes / HBM_BYTES_PER_S,
                     flops / PEAK_FLOPS["torch.float32"]) * 1e3,
        bound_by="bytes",
        library_ms=timer(lambda: torch.matmul(w_cat, b_cat)))
    out.append(k1)
    clean = Timer(torch, clean=True)
    details["weighted_sum"] = dict(
        M=m, live_x=lx, live_e=le, bytes=nbytes,
        ms_clean_l2=clean(lambda: WS.fused_weighted_sum(wx, we, bufx, bufe,
                                                        lx, le)),
        split=WS._ws_plan(m, lx, le)["split"],
        gb_per_s=nbytes / k1["ms"] / 1e6,
        **k1_splits(torch, WS, timer, wx, we, bufx, bufe, lx, le))
    # and at DiT's latent, where the plan splits the rows most
    md, dx, de = K1_DIT
    dw = torch.randn((2, max(dx, de)), generator=gen, device="cuda")
    dbx = torch.randn((dx, md), generator=gen, device="cuda")
    dbe = torch.randn((de, md), generator=gen, device="cuda")
    details["weighted_sum_dit"] = dict(
        M=md, live_x=dx, live_e=de, split=WS._ws_plan(md, dx, de)["split"],
        bound_ms=4 * ((dx + de) * md + md) / HBM_BYTES_PER_S * 1e3,
        library_ms=timer(lambda: torch.matmul(
            torch.cat([dw[0, :dx], dw[1, :de]]).reshape(1, -1),
            torch.cat([dbx, dbe]))),
        ms_clean_l2=clean(lambda: WS.fused_weighted_sum(dw[0], dw[1], dbx,
                                                        dbe, dx, de)),
        **k1_splits(torch, WS, timer, dw[0], dw[1], dbx, dbe, dx, de))

    # K2 / K3 at every conv shape and option set of one batch-64 forward
    x = torch.randn((BATCH, 32, 32, 3), generator=gen,
                    device="cuda").to(torch.bfloat16)
    tc = torch.full((BATCH,), 500.0, device="cuda")
    allsigs = kernel_signatures(model_bf16, x, tc)
    sigs = {sig: n for (kind, sig), n in allsigs.items()
            if kind in ("conv3x3", "conv3x3_gn")}
    n_k6 = sum(n for (kind, _), n in allsigs.items() if kind == "group_norm")
    if any(kind == "conv3x3_tiled" for kind, _ in allsigs):
        raise AssertionError("the CIFAR forward reached the halo-tiled conv")
    n_gn = sum(n for s, n in sigs.items() if any(s[2:]))
    n_plain = sum(n for s, n in sigs.items() if not any(s[2:]))
    # every option combination at the largest and the smallest map, so the
    # cross-sample tiles of the 4x4 maps and each template instance show
    extra = [((BATCH, hw, hw, c), (3, 3, c, c), p, s, e)
             for hw, c in ((32, 128), (4, 256))
             for p in (False, True) for s in (False, True)
             for e in (False, True)]
    rows = {"conv3x3": [], "conv3x3_gn": []}
    for sig in list(sigs) + [e for e in extra if e not in sigs]:
        kind = "conv3x3_gn" if any(sig[2:]) else "conv3x3"
        mult = sigs.get(sig, 0)
        row = dict(sig=repr(sig), per_forward=mult)
        for dtype, tol in ((torch.float32, F32_TOL), (torch.bfloat16, BF16_TOL)):
            xx, ww, bb, pre, sk = conv_inputs(torch, sig, dtype, gen)
            kw = dict(pre=pre, skip=sk, skip_rescale=sk is not None,
                      emit_stats=sig[4])
            if kind == "conv3x3":
                run = lambda: C.conv3x3(xx, ww, bb)             # noqa: E731
            else:
                run = lambda: C.conv3x3_gn(xx, ww, bb, **kw)    # noqa: E731
            def plain(xx=xx, ww=ww, bb=bb, kw=kw):
                return C.conv3x3_gn_reference(xx, ww, bb, **kw)
            # the oracle: cuDNN may pick a Winograd or FFT algorithm, ~1e-5
            # off in f32; its direct-GEMM fallback keeps the check exact.
            # The plain version is timed as PyTorch runs it, cuDNN on
            with torch.backends.cudnn.flags(enabled=False):
                p = plain()
            g = run()
            g, p = (g if sig[4] else (g,)), (p if sig[4] else (p,))
            dn = str(dtype)
            row[f"err_{dn}"], row[f"rel_err_{dn}"] = check_close(
                f"{kind} {sig} {dn}", g[0], p[0], tol)
            # how often the kernel's and the plain version's roundings differ
            row[f"y_differs_{dn}"] = float((g[0] != p[0]).float().mean())
            if sig[4]:
                acc = p[0].float()
                mag1 = acc.abs().sum(dim=(1, 2))
                mag2 = (acc * acc).sum(dim=(1, 2))
                row[f"stats_err_{dn}"] = max(
                    check_stats(f"{kind} {sig} {dn} s1", g[1], p[1], mag1),
                    check_stats(f"{kind} {sig} {dn} s2", g[2], p[2], mag2))

            if mult and dtype == torch.bfloat16:     # the path's type: time it
                xcl = xx.permute(0, 3, 1, 2)         # NCHW view, channels-last
                wcl = ww.permute(3, 2, 0, 1).contiguous(
                    memory_format=torch.channels_last)
                row.update(ms=timer(run), plain_ms=timer(plain),
                           library_ms=timer(lambda: F.conv2d(
                               xcl, wcl, bb, padding=1)))
                (row["flops"], row["bytes"], row["bound_ms"],
                 row["bound_by"]) = conv_cost(sig, 2, dn)
                row["plan"] = plan_of(sig)
        rows[kind].append(row)
    details["convs"] = rows
    details["conv_ragged"] = check_ragged_convs(torch, C, gen)

    # host cost of one launch through each wrapper, beside one PyTorch op's
    host = {"weighted_sum": host_us(torch, lambda: WS.fused_weighted_sum(
        wx, we, bufx, bufe, lx, le))}
    for kind, sig in (
            ("conv3x3", ((BATCH, 32, 32, 3), (3, 3, 3, 128), False, False,
                         False)),
            ("conv3x3_gn", ((BATCH, 4, 4, 256), (3, 3, 256, 256), True, True,
                            True))):
        xx, ww, bb, pre, sk = conv_inputs(torch, sig, torch.bfloat16, gen)
        if kind == "conv3x3":
            host[kind] = host_us(torch, lambda: C.conv3x3(xx, ww, bb))
        else:
            host[kind] = host_us(torch, lambda: C.conv3x3_gn(
                xx, ww, bb, pre=pre, skip=sk, skip_rescale=True,
                emit_stats=True))
    host["torch.add"] = host_us(torch, lambda: torch.add(bufx, 1.0))
    details["host_us_per_launch"] = host

    # K6 at the forward's standalone GroupNorms (the fused resblocks fold
    # theirs into K3's prologue)
    k6_rows = [k6_row(torch, sg, n, timer, gen, clean=clean)
               for (kind, sg), n in allsigs.items() if kind == "group_norm"]
    details["cifar_group_norm"] = k6_rows
    details["cifar_group_norm_per_forward"] = {
        k: sum(r[k] * r["per_forward"] for r in k6_rows)
        for k in ("ms", "ms_clean_l2", "plain_ms", "library_ms", "bound_ms")}
    for r in k6_rows:
        print_k6_row(r)

    meta = {"conv3x3": ("naturaldiffusion_tpu/ops/conv3x3.py:200", n_plain),
            "conv3x3_gn": ("naturaldiffusion_tpu/ops/conv3x3.py:600", n_gn)}
    for kind, (replaces, _) in meta.items():
        timed = [r for r in rows[kind] if r["per_forward"]]
        tot = {k: sum(r[k] * r["per_forward"] for r in timed)
               for k in ("ms", "plain_ms", "library_ms", "bound_ms", "flops",
                         "bytes")}
        out.append(dict(
            name=kind, route="cuda",
            source="naturaldiffusion_tpu_torch/csrc/conv3x3.cu",
            replaces=replaces,
            max_abs_err=max(v for r in rows[kind] for k, v in r.items()
                            if k.startswith(("err_", "stats_err_"))),
            max_rel_err=max(v for r in rows[kind] for k, v in r.items()
                            if k.startswith("rel_err_")),
            ms=tot["ms"], plain_ms=tot["plain_ms"], bound_ms=tot["bound_ms"],
            bound_by=("operations" if tot["flops"] / PEAK_FLOPS[
                "torch.bfloat16"] >= tot["bytes"] / HBM_BYTES_PER_S
                else "bytes"),
            library_ms=tot["library_ms"]))
        details[f"{kind}_per_forward"] = dict(launches=meta[kind][1], **tot)
    for kind in rows:
        for r in rows[kind]:
            if r["per_forward"]:
                print_conv_row(kind, r)
    rate = {"weighted_sum": f"{nbytes / k1['ms'] / 1e6:.1f} GB/s at split "
                            f"{details['weighted_sum']['split']}"}
    for kind in rows:
        d = details[f"{kind}_per_forward"]
        rate[kind] = f"{d['flops'] / d['ms'] / 1e9:.2f} TFLOP/s"
    phase("kernels", t,
          checks={k: len(v) for k, v in rows.items()},
          tolerances=dict(f32=F32_TOL, bf16=BF16_TOL, stats=STATS_TOL),
          per_forward_launches={"conv3x3": n_plain, "conv3x3_gn": n_gn,
                                "group_norm": n_k6},
          host_us_per_launch={k: round(v, 2) for k, v in host.items()},
          k1_ms_by_split={"cifar": details["weighted_sum"]["ms_by_split"],
                          "dit": details["weighted_sum_dit"]["ms_by_split"]},
          k1_ms_clean_l2={"cifar": details["weighted_sum"]["ms_clean_l2"],
                          "dit": details["weighted_sum_dit"]["ms_clean_l2"]},
          k1_dit_bound_ms=details["weighted_sum_dit"]["bound_ms"],
          k6_per_forward={k: round(v, 4) for k, v in details[
              "cifar_group_norm_per_forward"].items()},
          kernels={k["name"]: dict(
              {f: round(k[f], 4) for f in ("ms", "plain_ms", "library_ms",
                                          "bound_ms")},
              max_abs_err=k["max_abs_err"], max_rel_err=k["max_rel_err"],
              achieved=rate[k["name"]])
              for k in out},
          note="conv times: sum over one batch-64 forward's launches, bf16")
    return out, n_plain, n_gn, n_k6


def forward_input(torch):
    gen = torch.Generator().manual_seed(SEED + 2)
    return torch.randn((2, 32, 32, 3), generator=gen), torch.tensor(
        [999.0, 500.0])


def phase_forward(model_f32, oracles):
    """One full-width CIFAR forward in f32, the card against the CPU
    forward (the oracle process's, at ``forward_input``)."""
    import torch
    t = time.perf_counter()
    x, tc = forward_input(torch)
    card = copy.deepcopy(model_f32).to("cuda")
    with torch.no_grad():
        got = card(x.cuda(), tc.cuda())
    torch.cuda.synchronize()
    want = oracles.get("forward")[0]
    err = rel_l2(got, want)
    if not (torch.isfinite(got).all() and err <= FORWARD_TOL
            and got.shape == (2, 32, 32, 3)):
        raise AssertionError(f"forward: rel L2 {err:.3e} > {FORWARD_TOL:g} "
                             f"or non-finite")
    phase("forward", t, rel_l2=err, tol=FORWARD_TOL,
          params=sum(p.numel() for p in model_f32.parameters()),
          out_abs_max=float(want.abs().max()))


@contextlib.contextmanager
def plain_convs_and_norms():
    """Within the block, the conv kernels K2, K3 and K4 and the GroupNorm
    kernel K6 are replaced by their plain PyTorch versions (also for CUDA
    tensors)."""
    from naturaldiffusion_tpu_torch.ops import conv3x3 as C
    from naturaldiffusion_tpu_torch.ops import group_norm as G
    saved = (C.conv3x3, C.conv3x3_tiled, C.conv3x3_gn, G.fused_group_norm)
    C.conv3x3 = C.conv3x3_tiled = (
        lambda x, w, b=None: C.conv3x3_gn_reference(x, w, b))
    C.conv3x3_gn = C.conv3x3_gn_reference
    G.fused_group_norm = G.fused_group_norm_reference
    try:
        yield
    finally:
        (C.conv3x3, C.conv3x3_tiled, C.conv3x3_gn,
         G.fused_group_norm) = saved


class GraphedForward:
    """``net(x, t)`` at one input shape as a CUDA graph replay, for the
    uncounted runs beside a check (its plain-version and control runs),
    whose eager forwards cost ~55 ms of host time each: the first call
    warms ``net`` up on a side stream and captures it (under whatever
    routes are in force then: ``plain_convs_and_norms`` captures the plain
    versions), every call copies ``x`` and ``t`` into the static inputs,
    replays and returns a copy of the output."""

    def __init__(self, net):
        self.net, self.graph = net, None

    def __call__(self, x, t):
        import torch
        if self.graph is None:
            self.x, self.t = x.clone(), t.clone()
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side), torch.no_grad():
                self.net(self.x, self.t)
            torch.cuda.current_stream().wait_stream(side)
            self.graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(self.graph), torch.no_grad():
                self.out = self.net(self.x, self.t)
        self.x.copy_(x)
        self.t.copy_(t)
        self.graph.replay()
        return self.out.clone()


class _Replayed:
    """The autograd Function of :class:`GraphedVJP` (made at first use:
    torch is imported inside the script's functions)."""
    fn = None

    @classmethod
    def get(cls):
        import torch
        if cls.fn is None:
            class Fn(torch.autograd.Function):
                @staticmethod
                def forward(ctx, x, t, owner):
                    # the likelihood evaluates each state twice (the drift,
                    # then the divergence): the second call replays nothing
                    if not (owner.calls and torch.equal(x, owner.x)
                            and torch.equal(t, owner.t)):
                        owner.x.copy_(x)
                        owner.t.copy_(t)
                        owner.fwd.replay()
                        owner.replays += 1
                    owner.calls += 1
                    ctx.owner, ctx.replay = owner, owner.replays
                    return owner.out.detach().clone()

                @staticmethod
                def backward(ctx, g):
                    o = ctx.owner
                    if o.replays != ctx.replay:
                        raise RuntimeError("GraphedVJP: another input "
                                           "replaced this call's")
                    o.g.copy_(g)
                    o.bwd.replay()
                    return o.gx.clone(), None, None
            cls.fn = Fn
        return cls.fn


class GraphedVJP:
    """``net(x, t)`` at one input shape as CUDA-graph replays that autograd
    differentiates in x: a captured forward with grad mode on (its saved
    activations live in the graph's pool) and a captured backward of it for
    a cotangent, under whatever routes are in force at the first call,
    which warms ``net`` up on a side stream and captures.  A call with the
    inputs of the one before replays nothing; a backward must follow its
    call before another input comes (the likelihood's divergence does)."""

    def __init__(self, net):
        self.net, self.fwd, self.calls, self.replays = net, None, 0, 0

    def _capture(self, x, t):
        import torch
        self.x, self.t = x.detach().clone(), t.detach().clone()
        self.xg = self.x.detach().requires_grad_()       # the same storage
        self.g = torch.zeros_like(self.x)
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side), torch.enable_grad():
            torch.autograd.grad(self.net(self.xg, self.t), self.xg, self.g)
        torch.cuda.current_stream().wait_stream(side)
        self.fwd, self.bwd = torch.cuda.CUDAGraph(), torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.fwd), torch.enable_grad():
            self.out = self.net(self.xg, self.t)
        with torch.cuda.graph(self.bwd, pool=self.fwd.pool()):
            self.gx = torch.autograd.grad(self.out, self.xg, self.g,
                                          retain_graph=True)[0]

    def __call__(self, x, t):
        if self.fwd is None:
            self._capture(x, t)
        return _Replayed.get().apply(x, t, self)


def slice_controls(model_f32, matrix, init, noises):
    """Two runs beside the slice check, on its first 2 samples: the same
    bf16 run through the plain versions on the card (what bf16 alone
    costs), and through the kernels with the time conditioning 1 % off (a
    small fault).  The caller holds both against the CPU float32 run."""
    import torch
    from naturaldiffusion_tpu_torch.apps.cifar10_ni import make_sampler

    with plain_ni_convs_and_norms():
        plain = make_sampler(model_f32, matrix, micro=BATCH,
                             dtype=torch.bfloat16, device="cuda")(
            init, noises=noises)

    class TimeOff(torch.nn.Module):
        def __init__(self, inner):
            super().__init__()
            self.inner = inner

        def forward(self, x, t):
            return self.inner(x, t * 1.01)

    fault = make_sampler(TimeOff(model_f32), matrix, micro=BATCH,
                         dtype=torch.bfloat16, device="cuda")(
        init, noises=noises)
    return plain, fault


def ni_draws(torch, seed):
    """The init and the per-step noises of a BATCH-image NI run, drawn on
    the card from ``seed`` (the phases' and the oracle process's)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    init = torch.randn((BATCH, 32, 32, 3), generator=gen, device="cuda")
    noises = torch.randn((STEPS, BATCH, 32, 32, 3), generator=gen,
                         device="cuda")
    return init, noises


def cpu_ni(model, matrix, init, noises):
    """The float32 NI run of ``model`` on the CPU (an oracle), from host
    copies of ``init`` and ``noises``."""
    import torch
    from naturaldiffusion_tpu_torch.apps.cifar10_ni import make_sampler
    return make_sampler(model, matrix, micro=BATCH, dtype=torch.float32,
                        device="cpu")(init, noises=noises)


def phase_slice(model_f32, n_plain, n_gn, n_k6, smi, oracles):
    import torch
    from naturaldiffusion_tpu_torch.apps.cifar10_ni import make_sampler
    from naturaldiffusion_tpu_torch.coeffs import registry
    from naturaldiffusion_tpu_torch.ops import conv3x3 as C
    from naturaldiffusion_tpu_torch.ops import group_norm as G
    from naturaldiffusion_tpu_torch.ops import weighted_sum as WS

    t = time.perf_counter()
    parts = {}
    matrix = registry.derive("ddpm", STEPS)
    run = make_sampler(model_f32, matrix, micro=BATCH, dtype=torch.bfloat16,
                       device="cuda")
    init, noises = ni_draws(torch, SEED + 3)
    run(init, noises=noises)                     # warm-up
    torch.cuda.synchronize()
    parts["setup_and_warm_up"] = time.perf_counter() - t
    counters = (WS.fused_weighted_sum, C.conv3x3, C.conv3x3_gn,
                C.conv3x3_tiled, G.fused_group_norm)
    for f in counters:
        f.launches = 0
    t_run = time.perf_counter()
    out = run(init, noises=noises)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t_run
    launches = {f.__name__: f.launches for f in counters}
    expect = {"fused_weighted_sum": STEPS, "conv3x3": STEPS * n_plain,
              "conv3x3_gn": STEPS * n_gn, "conv3x3_tiled": 0,
              "fused_group_norm": STEPS * n_k6}
    if launches != expect or (n_gn, n_plain, n_k6) != (88, 2, 13):
        raise AssertionError(f"launches {launches} != {expect} (per "
                             f"forward: {n_gn} K3, {n_plain} K2, {n_k6} K6)")
    if not (torch.isfinite(out).all() and out.shape == init.shape):
        raise AssertionError("slice: non-finite or misshapen samples")
    tp = time.perf_counter()
    prof = profiled(torch, lambda: run(init, noises=noises))  # where it goes
    parts["profiled_run"] = time.perf_counter() - tp

    # the same 2 through the kernels in float32 pin the loop more tightly
    tp = time.perf_counter()
    card32 = make_sampler(model_f32, matrix, micro=BATCH,
                          dtype=torch.float32, device="cuda")
    got32 = card32(init[:2], noises=noises[:, :2])
    parts["card_f32"] = time.perf_counter() - tp
    tp = time.perf_counter()
    plain, fault = slice_controls(model_f32, matrix, init[:2], noises[:, :2])
    parts["controls"] = time.perf_counter() - tp
    # the first 2 samples in float32 on the CPU, fed the same noises (the
    # oracle process's)
    want, parts["cpu_oracle_s"], parts["cpu_oracle_wait"] = oracles.get(
        "slice")
    err, err32 = rel_l2(out[:2], want), rel_l2(got32, want)
    ctl_plain, ctl_fault = rel_l2(plain, want), rel_l2(fault, want)
    if err > SLICE_TOL or err32 > SLICE_F32_TOL:
        raise AssertionError(f"slice: rel L2 {err:.3e} (bf16, tol "
                             f"{SLICE_TOL:g}), {err32:.3e} (f32, tol "
                             f"{SLICE_F32_TOL:g})")
    phase("slice", t, img_per_s=BATCH / wall, wall_s=wall, card=smi,
          img_per_s_before_k6=CIFAR_IMG_PER_S_BEFORE_K6,
          launches=launches, profiled_run=prof,
          rel_l2_bf16_vs_cpu_f32=err, tol=SLICE_TOL,
          rel_l2_f32_vs_cpu_f32=err32, tol_f32=SLICE_F32_TOL,
          control_plain_bf16_rel_l2=ctl_plain,
          control_time_1pct_off_rel_l2=ctl_fault,
          sample_abs_max=float(out.abs().max()), seconds_by_part=parts)
    return launches, BATCH / wall


def per_forward_counts(net, dtype, batch, form=None, hw=32, label=500.0):
    """The kernel launches of one forward of ``net`` at ``batch`` images of
    ``hw`` x ``hw`` (CIFAR's by default) in ``dtype`` (the routes depend on
    all three), at time label ``label``; with ``form``
    (``NATDIFF_PALLAS_CONV``, ``NATDIFF_QUANT``) under that form, the int8
    conv counted too."""
    import torch
    from naturaldiffusion_tpu_torch.apps.bench import form_env
    counters = bench_counters() if form is None else form_counters()
    zero_counts(counters)
    with torch.no_grad(), (contextlib.nullcontext() if form is None
                           else form_env(*form)):
        net(torch.zeros((batch, hw, hw, 3), dtype=dtype, device="cuda"),
            torch.full((batch,), label, device="cuda"))
    torch.cuda.synchronize()
    return read_counts(counters)


def expect_counts(per_fwd, nfe, k1=0):
    """``nfe`` forwards' launches, and ``k1`` NI steps' K1 launches."""
    return {k: (k1 if k == "fused_weighted_sum" else nfe * v)
            for k, v in per_fwd.items()}


class Drive:
    """Counts the kernel launches of the phase's own drives: each drive
    sets every count to 0 before and reads the counts after, checks them
    against what its forwards and NI steps must launch, and adds them to
    the phase's total; the runs beside the drives (controls, plain
    versions) are not counted.  ``counters``: ``bench_counters`` (K1-K4,
    K6) or ``form_counters`` (also the int8 conv)."""

    def __init__(self, phase="samplers", counters=None):
        self.phase, self.total = phase, {}
        self.counters = counters or bench_counters

    @contextlib.contextmanager
    def __call__(self, what, expect_fn):
        import torch
        counters = self.counters()
        zero_counts(counters)
        yield
        torch.cuda.synchronize()
        got, want = read_counts(counters), expect_fn()
        if got != want:
            raise AssertionError(f"{self.phase} {what}: launches {got} != "
                                 f"{want}")
        for k, v in got.items():
            self.total[k] = self.total.get(k, 0) + v


def ni_pairs(net, drive, per_fwd):
    """Four samplers' direct recursions against NI with their derived
    matrices, f32 through the kernels, the same model, init, noises and
    time labels; each with its NI control (labels 1 % off)."""
    import numpy as np
    import torch
    from naturaldiffusion_tpu_torch.coeffs import registry
    from naturaldiffusion_tpu_torch.engine import NISchedule, natural_inference
    from naturaldiffusion_tpu_torch.engine.predictions import to_x0
    from naturaldiffusion_tpu_torch.samplers import deis, direct
    from naturaldiffusion_tpu_torch.samplers import dpm_solver as D
    from naturaldiffusion_tpu_torch.schedules import LinearVPSDE

    B, n = SAMPLERS_BATCH, SAMPLERS_STEPS
    gen = torch.Generator(device="cuda").manual_seed(SEED + 50)
    init = torch.randn((B, 32, 32, 3), generator=gen, device="cuda")
    noises = torch.randn((n, B, 32, 32, 3), generator=gen, device="cuda")

    # the controls replay one captured forward a call
    graphed = GraphedForward(net)

    def model(labels, scale=1.0):
        fwd = net if scale == 1.0 else graphed

        def eps(x, lab):
            labels.append(lab)
            return fwd(x, lab * scale)
        return eps

    def discrete(alg):
        """ddim / ddpm: the model's label is the timestep itself; the
        direct side converts eps to x0 with the matrix's alpha and sigma
        of the step, as the engine does."""
        sched = NISchedule.from_matrix(registry.derive(alg, n), device="cuda")
        stoch = alg == "ddpm"

        def direct_run(labels):
            eps, k = model(labels), [0]

            def x0_fn(x, t):
                _, a, s = sched.node[k[0]]
                k[0] += 1
                return to_x0(eps(x, t.expand(B)), x, a, s, "eps")
            if stoch:
                return direct.ddpm_ancestral(x0_fn, n, init, noises)
            return direct.ddim(x0_fn, n, init)

        def ni_run(labels, scale=1.0):
            eps = model(labels, scale)
            return natural_inference(lambda z, t: eps(z, t.expand(B)),
                                     sched, init,
                                     noises=noises if stoch else None,
                                     prediction_type="eps")
        return direct_run, ni_run, n

    def continuous(name):
        """DPM-Solver++(2S) and DEIS t-AB order 3 (label t * 999)."""
        sched = NISchedule.from_matrix(registry.derive(
            name, n // 2 if name == "dpmsolverpp2s" else n), device="cuda")

        def direct_run(labels):
            eps = model(labels)
            if name == "deis_tab":
                return deis.get_sampler_t_ab(
                    LinearVPSDE(), lambda x, t: eps(x, (t * 999.0).expand(B)),
                    "t", 2.0, n, ab_order=3)(init)
            ns = D.NoiseScheduleVP()
            solver = D.DPMSolver(D.model_wrapper(
                lambda x, t: eps(x, t * 999.0), ns), ns,
                algorithm_type="dpmsolver++")
            ts, x = np.linspace(1.0, 0.001, n // 2 + 1), init
            for i in range(n // 2):       # the deriver's grid, r1 = 1/2
                x, _ = solver.second_update(x, ts[i], ts[i + 1], r1=0.5)
            return x

        def ni_run(labels, scale=1.0):
            eps = model(labels, scale)
            return natural_inference(
                lambda z, t: eps(z, (t * 999.0).expand(B)), sched, init,
                prediction_type="eps")
        return direct_run, ni_run, sched.num_step

    rows = {}
    for name, build in (("ddim", lambda: discrete("ddim")),
                        ("ddpm", lambda: discrete("ddpm")),
                        ("dpmsolverpp2s", lambda: continuous("dpmsolverpp2s")),
                        ("deis_tab", lambda: continuous("deis_tab"))):
        direct_run, ni_run, k1 = build()
        ld, ln = [], []
        with torch.no_grad(), drive(name, lambda: expect_counts(
                per_fwd, len(ld) + len(ln), k1)):
            dr = direct_run(ld)
            ni = ni_run(ln)
        with torch.no_grad():
            ctl = ni_run([], 1.01)
        same = len(ld) == len(ln) == n and all(
            torch.equal(a, b) for a, b in zip(ld, ln))
        err, err_ctl = rel_l2(ni, dr), rel_l2(ctl, dr)
        rows[name] = dict(rel_l2_ni_vs_direct=err,
                          control_time_1pct_off_rel_l2=err_ctl,
                          model_calls=len(ln), same_labels=same,
                          finite=bool(torch.isfinite(ni).all()))
        print(f"  {name}: NI vs direct {err:.3e} (limit {NI_PAIR_TOL:g}), "
              f"labels 1 % off {err_ctl:.3e}, {len(ln)} calls each, "
              f"same labels {same}", flush=True)
        if not (same and rows[name]["finite"] and err <= NI_PAIR_TOL
                and err_ctl >= CONTROL_FACTOR * NI_PAIR_TOL):
            raise AssertionError(f"samplers {name}: {rows[name]}")
    return rows


def sweep_cells(model_f32, drive, per_fwd):
    """Two cells of ``apps.sweep`` on the card in bf16 over the same
    randomized model, SWEEP_NUM images in batches of SWEEP_BATCH."""
    import tempfile
    from naturaldiffusion_tpu_torch.apps import sweep

    rows = []
    with tempfile.TemporaryDirectory() as d:
        for family, only in SWEEP_CELLS:
            calls = []
            hook = model_f32.register_forward_hook(
                lambda m, i, o: calls.append(i[0].shape[0]))
            out = os.path.join(d, f"{family}.csv")
            args = sweep.parse_args([
                "--family", family, "--only", only, "--steps",
                str(SAMPLERS_STEPS), "--num", str(SWEEP_NUM), "--batch",
                str(SWEEP_BATCH), "--micro", str(SWEEP_BATCH), "--seed",
                str(SEED + 52), "--out", out, "--device", "cuda"])
            tr = time.perf_counter()
            try:
                with drive(f"sweep {family} {only}",
                           lambda: expect_counts(per_fwd, len(calls))):
                    row, = sweep.run(args, model=model_f32)
            finally:
                hook.remove()
            wall = time.perf_counter() - tr
            with open(out) as fh:
                for line in fh.read().splitlines():
                    print(f"  csv {family}: {line}", flush=True)
            want_calls = SWEEP_NUM // SWEEP_BATCH * SAMPLERS_STEPS
            if (len(calls) != want_calls or set(calls) != {SWEEP_BATCH}
                    or row["finite"] is not True):
                raise AssertionError(f"sweep {family} {only}: {row}, "
                                     f"{len(calls)} forwards")
            rows.append(dict(row, family=family, forwards=len(calls),
                             call_s=wall, img_per_s_call=SWEEP_NUM / wall))
    return rows


def vp_pc(net16, net32, drive, per_fwd):
    """``get_pc_sampler`` with the config's VPSDE at N = VP_PC_STEPS and its
    sampling (euler_maruyama + none), bf16 kernels against f32 plain
    versions on the card, with the bf16 plain-version and time-off
    controls and the f32 kernels, as ve_slice."""
    import torch
    from naturaldiffusion_tpu_torch import configs
    from naturaldiffusion_tpu_torch.samplers.pc import get_pc_sampler
    from naturaldiffusion_tpu_torch.scaler import get_inverse_scaler
    from naturaldiffusion_tpu_torch.sde import VPSDE, get_score_fn

    cfg = configs.get_config(SAMPLERS_CONFIG)
    full = configs.get_sde(cfg)
    sde = VPSDE(beta_min=full.beta_min, beta_max=full.beta_max,
                N=VP_PC_STEPS)
    shape = (SAMPLERS_BATCH, 32, 32, 3)

    def run(net, dtype, scale=1.0, calls=None):
        def apply(x, lab):
            if calls is not None:
                calls.append(1)
            return net(x.to(dtype), lab * scale)
        score = get_score_fn(sde, apply, continuous=cfg.sde.continuous)
        gen = torch.Generator(device="cuda").manual_seed(SEED + 53)
        with torch.no_grad():
            return get_pc_sampler(
                sde, score, shape, predictor=cfg.sampling.predictor,
                corrector=cfg.sampling.corrector, snr=cfg.sampling.snr,
                n_steps=cfg.sampling.n_steps_each, device="cuda")(gen)

    calls = []
    tr = time.perf_counter()
    with drive("vp_pc", lambda: expect_counts(per_fwd, len(calls))):
        out, nfe = run(net16, torch.bfloat16, calls=calls)
    wall = time.perf_counter() - tr
    with plain_convs_and_norms():
        want, _ = run(net32, torch.float32)
        ctl_plain = rel_l2(run(net16, torch.bfloat16)[0], want)
    err, err32 = rel_l2(out, want), rel_l2(run(net32, torch.float32)[0], want)
    ctl_fault = rel_l2(run(net16, torch.bfloat16, 1.01)[0], want)
    img = get_inverse_scaler(cfg.model.centered)(out)
    res = dict(config=SAMPLERS_CONFIG, sde="vpsde",
               predictor=cfg.sampling.predictor,
               corrector=cfg.sampling.corrector, batch=SAMPLERS_BATCH,
               steps=VP_PC_STEPS, steps_in_config=full.N,
               reduction=f"N = {VP_PC_STEPS} PC steps instead of {full.N}",
               nfe=nfe, model_calls=len(calls), wall_s=wall,
               img_per_s=SAMPLERS_BATCH / wall,
               rel_l2_bf16_vs_plain_f32=err, tol=VP_PC_TOL,
               rel_l2_f32_vs_plain_f32=err32, tol_f32=VP_PC_F32_TOL,
               control_plain_bf16_rel_l2=ctl_plain,
               control_time_1pct_off_rel_l2=ctl_fault,
               sample_abs_max=float(out.abs().max()))
    print(f"  vp_pc: {json.dumps(res)}", flush=True)
    if not (torch.isfinite(img).all() and len(calls) == VP_PC_STEPS
            and err <= VP_PC_TOL and err32 <= VP_PC_F32_TOL):
        raise AssertionError(f"samplers vp_pc: {res}")
    return res


def ode(net32, drive, per_fwd):
    """``get_ode_sampler`` (RK45 over the probability-flow ODE) at
    rtol = atol = ODE_RTOL, batch ODE_BATCH, f32: the kernels against the
    plain versions on the card, beside the time-off control."""
    import torch
    from naturaldiffusion_tpu_torch.samplers.pc import get_ode_sampler
    from naturaldiffusion_tpu_torch.sde import VPSDE, get_score_fn

    sde = VPSDE()

    def run(net, scale=1.0, calls=None):
        def apply(x, lab):
            if calls is not None:
                calls.append(1)
            return net(x, lab * scale)
        gen = torch.Generator(device="cuda").manual_seed(SEED + 54)
        with torch.no_grad():
            return get_ode_sampler(
                sde, get_score_fn(sde, apply), (ODE_BATCH, 32, 32, 3),
                rtol=ODE_RTOL, atol=ODE_RTOL, device="cuda")(gen)

    calls = []
    tr = time.perf_counter()
    with drive("ode", lambda: expect_counts(per_fwd, len(calls))):
        out, nfe = run(net32, calls=calls)
    wall = time.perf_counter() - tr
    if nfe > ODE_MAX_NFE:
        raise AssertionError(f"samplers ode: nfe {nfe} > {ODE_MAX_NFE}")
    # the plain-version run and the control replay one captured forward a
    # call (the same kernels or plain versions as eager)
    with plain_convs_and_norms():
        plain = GraphedForward(net32)
        want, nfe_plain = run(plain)
    ctl, nfe_ctl = run(GraphedForward(net32), 1.01)
    del plain
    err, err_ctl = rel_l2(out, want), rel_l2(ctl, want)
    res = dict(rtol=ODE_RTOL, atol=ODE_RTOL, rtol_jax_default=1e-5,
               reduction=f"rtol = atol = {ODE_RTOL:g} instead of 1e-5",
               batch=ODE_BATCH, nfe=nfe, model_calls=len(calls),
               nfe_plain=nfe_plain, nfe_control=nfe_ctl, wall_s=wall,
               rel_l2_kernels_vs_plain=err, tol=ODE_TOL,
               control_time_1pct_off_rel_l2=err_ctl,
               sample_abs_max=float(out.abs().max()))
    print(f"  ode: {json.dumps(res)}", flush=True)
    if not (torch.isfinite(out).all() and nfe == nfe_plain
            and err <= ODE_TOL and err_ctl >= CONTROL_FACTOR * ODE_TOL):
        raise AssertionError(f"samplers ode: {res}")
    return res


def phase_samplers(model_f32, n_plain, n_gn, n_k6, smi):
    """The sampler families over the CIFAR model as
    ``vp/cifar10_ddpmpp_continuous``: (a) NI against four direct
    recursions, f32; (b) two ``apps.sweep`` cells in bf16; (c) VP PC
    sampling; (d) the ODE sampler.  Its launches are the drives' (``Drive``)."""
    import torch
    t0 = time.perf_counter()
    drive = Drive()
    net32 = copy.deepcopy(model_f32).to("cuda").eval()
    f32_b8 = per_forward_counts(net32, torch.float32, SAMPLERS_BATCH)
    bf16_b64 = {"fused_weighted_sum": 0, "conv3x3": n_plain,
                "conv3x3_gn": n_gn, "conv3x3_tiled": 0,
                "fused_group_norm": n_k6}
    net16 = copy.deepcopy(model_f32).to(device="cuda", dtype=torch.bfloat16)
    bf16_b8 = per_forward_counts(net16, torch.bfloat16, SAMPLERS_BATCH)
    f32_b2 = per_forward_counts(net32, torch.float32, ODE_BATCH)

    ta = time.perf_counter()
    pairs = ni_pairs(net32, drive, f32_b8)
    # apps.validate on the card: the six direct samplers against NI on its
    # toy denoisers, float32 through K1, its own 1e-4 check
    from naturaldiffusion_tpu_torch.apps import validate
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = validate.main(["--steps", str(SAMPLERS_STEPS), "--device",
                            "cuda"])
    lines = buf.getvalue().splitlines()
    for line in lines:
        print(f"  validate: {line}", flush=True)
    if rc != 0 or len(lines) != len(validate._DIRECT):
        raise AssertionError(f"samplers: apps.validate rc {rc}")
    tb = time.perf_counter()
    cells = sweep_cells(model_f32, drive, bf16_b64)
    tc = time.perf_counter()
    pc_row = vp_pc(net16, net32, drive, bf16_b8)
    td = time.perf_counter()
    ode_row = ode(net32, drive, f32_b2)
    del net16, net32
    torch.cuda.empty_cache()
    phase("samplers", t0, config=SAMPLERS_CONFIG, card=smi,
          params=sum(p.numel() for p in model_f32.parameters()),
          ni_pairs=pairs, ni_pair_tol=NI_PAIR_TOL, validate_app=lines,
          sweep=cells, vp_pc=pc_row,
          ode=ode_row, per_forward=dict(f32_b8=f32_b8, bf16_b64=bf16_b64,
                                        bf16_b8=bf16_b8, f32_b2=f32_b2),
          seconds_by_part=dict(ni_pairs=tb - ta, sweep=tc - tb,
                               vp_pc=td - tc,
                               ode=time.perf_counter() - td),
          launches=drive.total)
    return drive.total


def likelihood_run(model_f32):
    """``eval.likelihood.get_likelihood_fn`` over the CIFAR model (see
    LIK_SEED): the kernels against the plain versions on the card with the
    same data and probe, and the plain versions' time-off control; the
    numbers and the launches of the kernels' run (its warm-up and capture)
    beside the launches it must have."""
    import torch
    from naturaldiffusion_tpu_torch import configs
    from naturaldiffusion_tpu_torch.eval.likelihood import get_likelihood_fn
    from naturaldiffusion_tpu_torch.scaler import get_inverse_scaler
    from naturaldiffusion_tpu_torch.sde import VPSDE, get_score_fn

    cfg = configs.get_config(SAMPLERS_CONFIG)
    sde = VPSDE()
    net32 = copy.deepcopy(model_f32).to("cuda").eval().requires_grad_(False)
    per_fwd = per_forward_counts(net32, torch.float32, ODE_BATCH)
    gen = torch.Generator(device="cuda").manual_seed(LIK_SEED)
    data = torch.rand((ODE_BATCH, 32, 32, 3), generator=gen,
                      device="cuda") * 2 - 1
    probe = torch.randint(0, 2, data.shape, generator=gen,
                          device="cuda") * 2.0 - 1.0

    def run(g, scale=1.0):
        lik = get_likelihood_fn(
            sde, get_score_fn(sde, lambda x, lab: LIK_EPS_SCALE
                              * g(x, lab * scale)),
            rtol=ODE_RTOL, atol=ODE_RTOL, eps=LIK_T0,
            inverse_scaler=get_inverse_scaler(cfg.model.centered))
        tr = time.perf_counter()
        bpd, z, nfe = lik(None, data, probe=probe)
        torch.cuda.synchronize()
        return bpd, z, nfe, time.perf_counter() - tr

    counters = bench_counters()
    zero_counts(counters)
    kern = GraphedVJP(net32)
    bpd, z, nfe, wall = run(kern)
    launches = read_counts(counters)
    with plain_convs_and_norms():
        plain = GraphedVJP(net32)
        bpd_p, z_p, nfe_p, wall_p = run(plain)
    bpd_c, z_c, nfe_c, _ = run(plain, 1.01)
    del kern, plain, net32
    torch.cuda.empty_cache()

    def rel(a, b):
        return float(((a - b).abs() / b.abs()).max())
    return dict(config=SAMPLERS_CONFIG, batch=ODE_BATCH, rtol=ODE_RTOL,
                atol=ODE_RTOL, rtol_jax_default=1e-5,
                reduction=f"rtol = atol = {ODE_RTOL:g} instead of 1e-5; eps "
                          f"scaled by {LIK_EPS_SCALE:g}; the ODE from "
                          f"t = {LIK_T0:g} instead of 1e-5",
                finite=bool(torch.isfinite(bpd).all()
                            and torch.isfinite(z).all()),
                bpd=bpd.tolist(), bpd_plain=bpd_p.tolist(), nfe=nfe,
                nfe_plain=nfe_p, nfe_control=nfe_c,
                bpd_rel_err=rel(bpd, bpd_p), z_rel_l2=rel_l2(z, z_p),
                tol=ODE_TOL, z_tol=LIK_Z_TOL, control_time_1pct_off=dict(
                    bpd_rel_err=rel(bpd_c, bpd_p),
                    z_rel_l2=rel_l2(z_c, z_p)),
                kernels_run_s=wall, plain_run_s=wall_p, launches=launches,
                # the warm-up and the capture of the forward (its backward
                # launches no kernel: cuDNN's)
                launches_wanted=expect_counts(per_fwd, 2))


def phase_likelihood(oracles, smi):
    """The likelihood check (``likelihood_run``), run in the oracle process
    beside ``entry_points`` (a check whose graph replays keep the card
    busy while that phase's apps keep the host busy): its numbers held to
    their limits.  Returns the launches of the kernels' run."""
    t0 = time.perf_counter()
    res, secs, wait = oracles.get("likelihood", raw=True)
    res = dict(res, seconds_in_oracle_process=secs, waited_s=wait)
    print(f"  likelihood: {json.dumps(res)}", flush=True)
    ctl = res["control_time_1pct_off"]
    if not (res["finite"] and res["launches"] == res["launches_wanted"]
            and res["nfe"] == res["nfe_plain"]
            and res["bpd_rel_err"] <= ODE_TOL
            and res["z_rel_l2"] <= LIK_Z_TOL
            and ctl["z_rel_l2"] >= CONTROL_FACTOR * LIK_Z_TOL
            and ctl["bpd_rel_err"] > ODE_TOL):
        raise AssertionError(f"likelihood: {res}")
    phase("likelihood", t0, card=smi, **res)
    return res["launches"]


def inception_model():
    """The FID Inception with every leaf random (its BatchNorms too), on the
    CPU."""
    import torch
    from naturaldiffusion_tpu_torch.eval.inception import (
        FIDInceptionV3, randomize_inception_)
    cpu = randomize_inception_(FIDInceptionV3(with_logits=True), SEED + 60)
    # the BatchNorms random too, so that every leaf takes part
    g = torch.Generator().manual_seed(SEED + 64)
    with torch.no_grad():
        for name, p in cpu.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if name.startswith("fc.") or leaf == "kernel":
                continue
            p.copy_(1.0 + 0.1 * torch.randn(p.shape, generator=g)
                    if leaf == "scale" else
                    0.5 + torch.rand(p.shape, generator=g) if leaf == "var"
                    else 0.1 * torch.randn(p.shape, generator=g))
    return cpu.eval()


def inception_inputs(torch):
    """The inputs at EVAL_INCEPTION_SIZES and the timing batch."""
    gen = torch.Generator().manual_seed(SEED + 61)
    xs = [torch.rand((n, h, w, 3), generator=gen)
          for n, h, w in EVAL_INCEPTION_SIZES]
    return xs, torch.rand((EVAL_FEAT_BATCH, 32, 32, 3), generator=gen)


def eval_inception(smi, oracles):
    """(a) The FID Inception in f32 on the card against the CPU (the oracle
    process's forwards) at EVAL_INCEPTION_SIZES, then its features timed
    at EVAL_FEAT_BATCH CIFAR images (resize included)."""
    import torch
    card = inception_model().to("cuda")
    xs, xb = inception_inputs(torch)
    outs = oracles.get("inception")[0]
    wants = [outs[2 * i:2 * i + 2] for i in range(len(xs))]
    rows = []
    for (n, h, w), x, want in zip(EVAL_INCEPTION_SIZES, xs, wants):
        with torch.no_grad():
            got = card(x.cuda())
        errs = [rel_l2(g, w_) for g, w_ in zip(got, want)]
        rows.append(dict(shape=[n, h, w], rel_l2_pool=errs[0],
                         rel_l2_logits=errs[1],
                         pool_abs_max=float(want[0].abs().max())))
        print(f"  inception {n}x{h}x{w}: pool {errs[0]:.3e}, logits "
              f"{errs[1]:.3e} (limit {INCEPTION_TOL:g})", flush=True)
        if not (all(torch.isfinite(g).all() for g in got)
                and max(errs) <= INCEPTION_TOL):
            raise AssertionError(f"eval inception: {rows[-1]}")
    xb = xb.cuda()
    ms = Timer(torch, reps=3)(lambda: card(xb))
    return dict(sizes=rows, tol=INCEPTION_TOL, feature_batch=EVAL_FEAT_BATCH,
                feature_ms=ms, feature_img_per_s=EVAL_FEAT_BATCH / ms * 1e3,
                card=smi)


def eval_selfcheck(model_f32, n_plain, n_gn, n_k6):
    """(b) ``apps.fid_selfcheck.main`` over ``model_f32`` on the card at
    EVAL_SELFCHECK_ARGS: its pass rule, its CSV row, and the launches of
    its sampler's warm-up and capture (the replays launch through the
    graph and count none)."""
    import csv
    import tempfile
    import torch
    from naturaldiffusion_tpu_torch.apps import fid_selfcheck

    counters = form_counters()
    zero_counts(counters)
    with tempfile.TemporaryDirectory() as d:
        out = os.path.join(d, "selfcheck.csv")
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = fid_selfcheck.main(list(EVAL_SELFCHECK_ARGS) + [
                "--out", out, "--device", "cuda"], model=model_f32)
        torch.cuda.synchronize()
        got = read_counts(counters)
        for line in buf.getvalue().splitlines():
            print(f"  fid_selfcheck: {line}", flush=True)
        with open(out, newline="") as fh:
            row = next(csv.DictReader(fh))
    runs = 2                    # the eager warm-up and the capture
    want = {"fused_weighted_sum": runs * STEPS,
            "conv3x3": runs * STEPS * n_plain,
            "conv3x3_gn": runs * STEPS * n_gn, "conv3x3_tiled": 0,
            "fused_group_norm": runs * STEPS * n_k6, "conv3x3_int8": 0}
    if rc != 0 or got != want:
        raise AssertionError(f"eval fid_selfcheck: rc {rc}, launches {got} "
                             f"!= {want}, row {row}")
    return dict(row=row, args=list(EVAL_SELFCHECK_ARGS),
                reduction="512 images of 50,000, 256 of 2048 features"), got


def eval_graphed_sampler(model_f32):
    """(b) ``cifar10_ni.make_sampler(graph=True)`` against ``graph=False``
    over ``model_f32`` micro-batch by micro-batch (a stale init, a stale
    noise or an aliased output moves one by O(1)), a planted fault, and
    fresh generator noises per replay (see EVAL_GRAPH_CHUNKS)."""
    import torch
    from naturaldiffusion_tpu_torch.apps.cifar10_ni import make_sampler
    from naturaldiffusion_tpu_torch.coeffs import registry

    matrix = registry.derive("ddpm", STEPS)
    graphed = make_sampler(model_f32, matrix, micro=BATCH, device="cuda",
                           graph=True)
    eager = make_sampler(model_f32, matrix, micro=BATCH, device="cuda")
    B = EVAL_GRAPH_CHUNKS * BATCH
    gen = torch.Generator(device="cuda").manual_seed(SEED + 65)
    init = torch.randn((B, 32, 32, 3), generator=gen, device="cuda")
    noises = torch.randn((matrix.num_step, B, 32, 32, 3), generator=gen,
                         device="cuda")

    def per_chunk(got, want):
        return [rel_l2(got[c:c + BATCH], want[c:c + BATCH])
                for c in range(0, B, BATCH)]

    want = eager(init, noises=noises)
    errs = per_chunk(graphed(init, noises=noises), want)
    state = model_f32.state_dict()
    fault_key = BENCH_FAULT_CONV + ".kernel"
    faulted = graphed.with_params(dict(
        state, **{fault_key: torch.zeros_like(state[fault_key])}))(
        init, noises=noises)
    faults = per_chunk(faulted, want)
    restored = per_chunk(graphed.with_params(state)(init, noises=noises),
                         want)
    same = init[:BATCH].repeat(EVAL_GRAPH_CHUNKS, 1, 1, 1)
    drawn = graphed(same, generator=gen)
    noise_apart = rel_l2(drawn[BATCH:2 * BATCH], drawn[:BATCH])
    torch.cuda.synchronize()
    row = dict(rel_l2_graph_vs_eager=errs, fault_rel_l2=faults,
               restored_rel_l2=restored, noise_draws_apart=noise_apart,
               tol=BENCH_GRAPH_TOL, fault_conv=BENCH_FAULT_CONV,
               images=B, micro=BATCH)
    print(f"  graphed sampler: {json.dumps(row)}", flush=True)
    del graphed, eager
    torch.cuda.empty_cache()
    if not (torch.isfinite(want).all() and max(errs) <= BENCH_GRAPH_TOL
            and max(restored) <= BENCH_GRAPH_TOL
            and min(faults) > BENCH_GRAPH_TOL
            and noise_apart > BENCH_GRAPH_TOL):
        raise AssertionError(f"eval graphed sampler: {row}")
    return row


def eval_controllable(net32, drive, per_fwd):
    """(c) PC inpainting and colorization over ``net32`` as SAMPLERS_CONFIG
    at N = EVAL_CTRL_STEPS, f32: the kernels against the plain versions
    with the same noises, the time 1 % off, the known pixels and the
    luminance against their inputs, the launches of each drive."""
    import torch
    from naturaldiffusion_tpu_torch import configs
    from naturaldiffusion_tpu_torch.samplers import controllable as CG
    from naturaldiffusion_tpu_torch.sde import VPSDE, get_score_fn

    cfg = configs.get_config(SAMPLERS_CONFIG)
    full = configs.get_sde(cfg)
    sde = VPSDE(beta_min=full.beta_min, beta_max=full.beta_max,
                N=EVAL_CTRL_STEPS)
    B = EVAL_CTRL_BATCH
    gen = torch.Generator().manual_seed(SEED + 62)
    data = (torch.rand((B, 32, 32, 3), generator=gen) * 2 - 1).cuda()
    mask = torch.zeros_like(data)
    mask[:, :, :16] = 1.0                   # the left half is known
    gray = data.mean(-1, keepdim=True).expand(-1, -1, -1, 3).contiguous()
    kw = dict(predictor=cfg.sampling.predictor,
              corrector=cfg.sampling.corrector, snr=cfg.sampling.snr,
              n_steps=cfg.sampling.n_steps_each, device="cuda")

    # the plain-version runs and the controls replay one captured forward
    # a call (the plain versions captured under plain_convs_and_norms)
    plain, graphed = GraphedForward(net32), GraphedForward(net32)

    def run(kind, scale=1.0, calls=None, fwd=net32):
        def apply(x, lab):
            if calls is not None:
                calls.append(1)
            return fwd(x, lab * scale)
        score = get_score_fn(sde, apply, continuous=cfg.sde.continuous)
        g = torch.Generator(device="cuda").manual_seed(SEED + 63)
        if kind == "inpaint":
            return CG.get_pc_inpainter(sde, score, **kw)(g, data, mask)
        return CG.get_pc_colorizer(sde, score, **kw)(g, gray)

    n_corr = cfg.sampling.n_steps_each if cfg.sampling.corrector != "none" \
        else 0
    rows = {}
    for kind in ("inpaint", "colorize"):
        calls = []
        tr = time.perf_counter()
        with drive(kind, lambda: expect_counts(per_fwd, len(calls))):
            out = run(kind, calls=calls)
        wall = time.perf_counter() - tr
        with plain_convs_and_norms():
            want = run(kind, fwd=plain)
        err, err_ctl = rel_l2(out, want), rel_l2(run(kind, 1.01,
                                                     fwd=graphed), want)
        if kind == "inpaint":
            known = float((out - data)[mask == 1].abs().max())
        else:
            known = float((CG.decouple(out)[..., 0]
                           - CG.decouple(gray)[..., 0]).abs().max())
        rows[kind] = dict(rel_l2_kernels_vs_plain=err, tol=EVAL_CTRL_TOL,
                          control_time_1pct_off_rel_l2=err_ctl,
                          known_max_abs_err=known, model_calls=len(calls),
                          wall_s=wall, img_per_s=B / wall,
                          sample_abs_max=float(out.abs().max()))
        print(f"  {kind}: {json.dumps(rows[kind])}", flush=True)
        if not (torch.isfinite(out).all()
                and len(calls) == EVAL_CTRL_STEPS * (1 + n_corr)
                and err <= EVAL_CTRL_TOL
                and err_ctl >= CONTROL_FACTOR * EVAL_CTRL_TOL
                and known <= EVAL_KNOWN_TOL):
            raise AssertionError(f"eval {kind}: {rows[kind]}")
    return dict(rows, config=SAMPLERS_CONFIG, predictor=kw["predictor"],
                corrector=kw["corrector"], batch=B, steps=EVAL_CTRL_STEPS,
                reduction=f"N = {EVAL_CTRL_STEPS} steps instead of {full.N}")


def eval_quant(model_f32, drive):
    """(d) ``apps.quant_accuracy.run`` over ``model_f32`` at batch
    EVAL_QUANT_BATCH in each of EVAL_QUANT_MODES: its report, a non-zero
    int8-against-bf16 gap, and the launches of its three runs (bf16 and
    int8 engines, the f32 forwards of the oracle) under route 0."""
    import torch
    from naturaldiffusion_tpu_torch.apps import quant_accuracy as QA

    B = EVAL_QUANT_BATCH
    net16 = copy.deepcopy(model_f32).to(device="cuda", dtype=torch.bfloat16)
    net32 = copy.deepcopy(model_f32).to("cuda")
    per_bf16 = per_forward_counts(net16, torch.bfloat16, B, form=("0", ""))
    per_f32 = per_forward_counts(net32, torch.float32, B, form=("0", ""))
    reports = {}
    for mode in EVAL_QUANT_MODES:
        args = QA.parse_args(["--batch", str(B), "--mode", mode, "--device",
                              "cuda"])
        per_int8 = per_forward_counts(net16, torch.bfloat16, B,
                                      form=("0", mode))
        n = args.steps

        def want():
            return {k: n * (per_bf16[k] + per_int8[k] + per_f32[k])
                    + (2 * n if k == "fused_weighted_sum" else 0)
                    for k in per_bf16}
        with drive(f"quant_accuracy {mode}", want):
            rep = QA.run(args, model=model_f32)
        reports[mode] = dict(rep, q1_launches=n * per_int8["conv3x3_int8"])
        print(f"  quant_accuracy: {json.dumps(reports[mode])}", flush=True)
        if not (rep["finite"] and rep["mae_int8_vs_bf16"] > 0
                and per_int8["conv3x3_int8"] > 0):
            raise AssertionError(f"eval quant_accuracy {mode}: {rep}")
    return reports


def phase_eval(model_f32, n_plain, n_gn, n_k6, smi, oracles):
    """The evaluation modules at full width with random weights: (a) the
    FID Inception, card against CPU; (b) ``apps.fid_selfcheck``; (c) PC
    inpainting and colorization; (d) ``apps.quant_accuracy``.  Its
    launches are (b)'s and the drives' of (c) and (d)."""
    import torch
    t0 = time.perf_counter()
    drive = Drive("eval", form_counters)
    inception = eval_inception(smi, oracles)
    ta = time.perf_counter()
    selfcheck, sc_launches = eval_selfcheck(model_f32, n_plain, n_gn, n_k6)
    selfcheck["graphed_sampler"] = eval_graphed_sampler(model_f32)
    tb = time.perf_counter()
    net32 = copy.deepcopy(model_f32).to("cuda").eval()
    ctrl = eval_controllable(net32, drive, per_forward_counts(
        net32, torch.float32, EVAL_CTRL_BATCH, form=("2", "")))
    del net32
    tc = time.perf_counter()
    quant = eval_quant(model_f32, drive)
    torch.cuda.empty_cache()
    launches = {k: v + drive.total.get(k, 0) for k, v in sc_launches.items()}
    phase("eval", t0, card=smi, inception=inception,
          fid_selfcheck=selfcheck, controllable=ctrl, quant_accuracy=quant,
          seconds_by_part=dict(inception=ta - t0, fid_selfcheck=tb - ta,
                               controllable=tc - tb,
                               quant_accuracy=time.perf_counter() - tc),
          launches=launches)
    return launches


def train_grads(torch, fn, ins, cots, cudnn=True):
    """Gradients of ``sum(out_i * cot_i)`` for the tensors of ``ins`` (None
    kept out) through ``fn``, on fresh leaves, cuDNN on or off."""
    leaves = [None if t is None else t.detach().clone().requires_grad_()
              for t in ins]
    # cudnn.flags() sets allow_tf32 too (True by default): keep it off
    off = (contextlib.nullcontext() if cudnn else
           torch.backends.cudnn.flags(enabled=False, allow_tf32=False))
    with torch.enable_grad(), off:
        out = fn(*leaves)
        outs = out if isinstance(out, tuple) else (out,)
        loss = sum((o.float() * c).sum() for o, c in zip(outs, cots))
        return torch.autograd.grad(loss, [t for t in leaves
                                          if t is not None])


def grad_rows(torch, C, G, sigs, dtype, gen):
    """Each kernel's Function against the plain version's autograd at each
    signature (see TRAIN_CHECK_BATCH): (kind, signature, [rel L2 per input
    gradient], [bf16 control per input gradient])."""
    rows = []
    for (kind, sig), _ in sorted(sigs.items(), key=repr):
        if kind == "group_norm":
            x, scale, bias, eb = gn_inputs(torch, sig, dtype, gen)
            _, groups, act, _ = sig
            ins = [x, scale, bias, eb]

            def fn(x_, s_, b_, e_):
                return G.fused_group_norm(x_, s_, b_, groups, act=act,
                                          extra_bias=e_)

            def plain(x_, s_, b_, e_):
                return G.fused_group_norm_reference(x_, s_, b_, groups,
                                                    act=act, extra_bias=e_)
            cots = [torch.randn(x.shape, generator=gen, device="cuda")]
        else:
            x, w, b, pre, sk = conv_inputs(torch, sig, dtype, gen)
            stats = sig[4]
            ins = [x, w, b] + (list(pre) if pre else [None, None]) + [sk]
            kw = dict(skip_rescale=sk is not None, emit_stats=stats)

            def fn(x_, w_, b_, pw, pb, sk_, _kind=kind, _kw=kw):
                pre_ = None if pw is None else (pw, pb)
                if _kind == "conv3x3_gn":
                    return C.conv3x3_gn(x_, w_, b_, pre=pre_, skip=sk_, **_kw)
                return getattr(C, _kind)(x_, w_, b_)

            def plain(x_, w_, b_, pw, pb, sk_, _kw=kw):
                pre_ = None if pw is None else (pw, pb)
                return C.conv3x3_gn_reference(x_, w_, b_, pre=pre_, skip=sk_,
                                              **_kw)
            (bb, hh, ww, _), wshape = sig[0], sig[1]
            cots = [torch.randn((bb, hh, ww, wshape[3]), generator=gen,
                                device="cuda")]
            if stats:
                cots += [torch.randn((bb, wshape[3]), generator=gen,
                                     device="cuda") / (hh * ww),
                         torch.randn((bb, wshape[3]), generator=gen,
                                     device="cuda") / (4 * hh * ww)]
        got = train_grads(torch, fn, ins, cots)
        want = train_grads(torch, plain, ins, cots, cudnn=False)
        errs = [rel_l2(g, w_) for g, w_ in zip(got, want)]
        ctl = []
        if dtype == torch.bfloat16:
            ins32 = [None if t is None else t.float() for t in ins]
            want32 = train_grads(torch, plain, ins32, cots, cudnn=False)
            ctl = [rel_l2(w_, r) for w_, r in zip(want, want32)]
        tol = GRAD_BF16_TOL if dtype == torch.bfloat16 else GRAD_F32_TOL
        if not all(math.isfinite(e) and e <= tol for e in errs):
            raise AssertionError(f"train: {kind} {sig} {dtype} backward: "
                                 f"gradient rel L2 {errs} > {tol:g}")
        rows.append((kind, repr(sig), errs, ctl))
    return rows


def train_loss_grads(torch, sde, apply, params, batch, t, z):
    from naturaldiffusion_tpu_torch.train.losses import sde_loss_given
    with torch.enable_grad():
        loss = sde_loss_given(sde, apply, params, batch, t, z)
        return loss.detach(), torch.autograd.grad(loss,
                                                  list(params.values()))


def rel_l2_all(a, b):
    """Relative L2 of two lists of tensors taken as one vector."""
    num = sum(float((x.double() - y.double()).norm()) ** 2
              for x, y in zip(a, b))
    den = sum(float(y.double().norm()) ** 2 for y in b)
    return math.sqrt(num / den)


def train_model_check(model_f32, net, per_fwd):
    """(2) the whole-model loss and gradient through ``net`` (``model_f32``
    on the card), kernels against plain versions, its control and the
    launches of the forward and of the backward; (3) the optimizer steps.
    Returns the numbers."""
    import torch
    from naturaldiffusion_tpu_torch.ops import conv3x3 as C
    from naturaldiffusion_tpu_torch.sde import VPSDE
    from naturaldiffusion_tpu_torch.train import make_train_step
    from naturaldiffusion_tpu_torch.train.losses import sde_draws
    from naturaldiffusion_tpu_torch.train.state import functional_apply

    sde = VPSDE()
    apply, params = functional_apply(net), dict(net.named_parameters())
    gen = torch.Generator(device="cuda").manual_seed(SEED + 60)
    batch = torch.rand((TRAIN_MODEL_BATCH, 32, 32, 3), generator=gen,
                       device="cuda") * 2 - 1
    t, z = sde_draws(sde, batch, gen)
    counters = bench_counters()
    zero_counts(counters)
    from naturaldiffusion_tpu_torch.train.losses import sde_loss_given
    with torch.enable_grad():
        loss = sde_loss_given(sde, apply, params, batch, t, z)
        torch.cuda.synchronize()
        fwd_counts = read_counts(counters)
        grads = torch.autograd.grad(loss, list(params.values()))
    torch.cuda.synchronize()
    all_counts = read_counts(counters)
    if fwd_counts != per_fwd or all_counts != per_fwd:
        raise AssertionError(f"train: launches forward {fwd_counts}, with "
                             f"the backward {all_counts} != {per_fwd}")
    with plain_convs_and_norms():
        loss_p, grads_p = train_loss_grads(torch, sde, apply, params, batch,
                                           t, z)
    loss_err = abs(float(loss) - float(loss_p)) / abs(float(loss_p))
    grad_err = rel_l2_all(grads, grads_p)
    grad_norm = math.sqrt(sum(float(g.double().norm()) ** 2
                              for g in grads_p))
    orig = C._ConvFn.backward

    def stats_dropped(ctx, *g):
        return orig(ctx, g[0], *([None] * (len(g) - 1)))
    C._ConvFn.backward = staticmethod(stats_dropped)
    try:
        _, grads_c = train_loss_grads(torch, sde, apply, params, batch, t, z)
    finally:
        C._ConvFn.backward = orig
    control = rel_l2_all(grads_c, grads_p)
    if not (loss_err <= TRAIN_LOSS_TOL and grad_err <= TRAIN_GRAD_TOL
            and control > TRAIN_GRAD_TOL):
        raise AssertionError(
            f"train: loss rel {loss_err:.3e} (tol {TRAIN_LOSS_TOL:g}), grad "
            f"rel L2 {grad_err:.3e} (tol {TRAIN_GRAD_TOL:g}), stats-dropped "
            f"control {control:.3e} (must exceed the tol)")
    model = dict(loss=float(loss), loss_rel_err=loss_err,
                 grad_rel_l2=grad_err, grad_norm=grad_norm,
                 control_stats_cotangent_dropped_rel_l2=control,
                 launches_forward=fwd_counts,
                 launches_forward_and_backward=all_counts)

    # (3) optimizer steps from one state, kernels against plain versions
    draws = [sde_draws(sde, batch, gen) for _ in range(TRAIN_OPT_STEPS)]
    states = []
    for plain in (False, True):
        net_s = copy.deepcopy(model_f32).to("cuda")
        init, step = make_train_step(sde, functional_apply(net_s), warmup=2,
                                     grad_clip=1.0)
        st = init(dict(net_s.named_parameters()))
        p0 = [p.detach().clone() for p in st.params.values()]
        with (plain_convs_and_norms() if plain else
              contextlib.nullcontext()):
            zero_counts(counters)
            for d in draws:
                st, loss_s = step(st, None, batch, draws=d)
            torch.cuda.synchronize()
        if not plain and read_counts(counters) != expect_counts(
                per_fwd, TRAIN_OPT_STEPS):
            raise AssertionError(f"train: optimizer steps launched "
                                 f"{read_counts(counters)}")
        states.append((st, p0, float(loss_s)))
    (sk, p0, lk), (sp, _, lp) = states

    def moves(st):
        return ([p - q for p, q in zip(st.params.values(), p0)],
                [e - q for e, q in zip(st.ema.shadow, p0)])
    (dk, ek), (dp, ep) = moves(sk), moves(sp)
    opt = dict(params_move_rel_l2=rel_l2_all(dk, dp),
               ema_move_rel_l2=rel_l2_all(ek, ep),
               mu_rel_l2=rel_l2_all(sk.opt_state.mu, sp.opt_state.mu),
               nu_rel_l2=rel_l2_all(sk.opt_state.nu, sp.opt_state.nu),
               last_loss=lk, last_loss_plain=lp,
               clip_active_at_step_1=grad_norm > 1.0,
               step=sk.step, tol=TRAIN_OPT_TOL)
    if sk.step != TRAIN_OPT_STEPS or not all(
            opt[k] <= TRAIN_OPT_TOL for k in ("params_move_rel_l2",
                                              "ema_move_rel_l2", "mu_rel_l2",
                                              "nu_rel_l2")):
        raise AssertionError(f"train: optimizer steps {opt}")
    return model, opt


def train_state_leaves(st):
    return (list(st.params.values()), st.opt_state.mu, st.opt_state.nu,
            st.ema.shadow)


def train_app_runs(per_fwd, tmp):
    """(5) ``apps.train`` on a toy binary: per type the uninterrupted run
    with its snapshots at iterations 1 and 2 (in f32 with their sample
    grids, and its launches counted); in f32 then a run whose
    ``checkpoints-meta`` is the step-2 snapshot (hard links), resumed to
    the end, against it.  ``tmp`` keeps the toy data (``toy``) and the f32
    run's workdir (``f32_whole``) for the entry-points phase."""
    import shutil
    import torch
    from naturaldiffusion_tpu_torch.apps import toy_dataset
    from naturaldiffusion_tpu_torch.apps import train as TA
    res, launches = {}, None
    with contextlib.redirect_stdout(io.StringIO()) as log:
        data = os.path.join(tmp, "toy")
        toy_dataset.main(["--out", data, *TOY_ARGS])
        for kind in ("f32", "bf16"):
            common = ["--data-dir", data, "--batch", str(TRAIN_APP_BATCH),
                      "--snapshot-freq", "1", "--preemption-freq", "1000000",
                      "--sample-steps", str(TRAIN_SAMPLE_STEPS),
                      "--log-freq", "1", "--n-iters", str(TRAIN_APP_ITERS)
                      ] + (["--bf16", "--no-snapshot-samples"]
                           if kind == "bf16" else [])
            whole_dir = os.path.join(tmp, f"{kind}_whole")
            counters = bench_counters()
            zero_counts(counters)
            tw = time.perf_counter()
            whole = TA.train(TA.parse(["--workdir", whole_dir] + common)[0])
            torch.cuda.synchronize()
            wall = time.perf_counter() - tw
            snaps = [os.path.join(whole_dir, "checkpoints", f"checkpoint_{i}")
                     for i in range(1, TRAIN_APP_ITERS)]
            grids = [os.path.join(whole_dir, "samples", f"iter_{i}.png")
                     for i in range(1, TRAIN_APP_ITERS) if kind == "f32"]
            losses = [json.loads(line)["value"] for line in open(
                os.path.join(whole_dir, "metrics.jsonl"))
                if '"training_loss"' in line]
            res[kind] = dict(wall_s=wall, losses=losses, step=whole.step)
            if not (whole.step == TRAIN_APP_ITERS
                    and len(losses) == TRAIN_APP_ITERS
                    and all(math.isfinite(v) for v in losses)
                    and all(os.path.isfile(os.path.join(p, "state.pt"))
                            for p in snaps)
                    and all(map(os.path.isfile, grids))):
                raise AssertionError(f"train app {kind}: {res[kind]}, or no "
                                     f"snapshot or sample grid")
            if kind == "bf16":
                break
            launches = read_counts(counters)
            want = expect_counts(per_fwd, TRAIN_APP_ITERS
                                 + len(grids) * TRAIN_SAMPLE_STEPS)
            if launches != want:
                raise AssertionError(f"train app launches {launches} != "
                                     f"{want}")
            cut_dir = os.path.join(tmp, f"{kind}_resumed")
            meta = os.path.join(cut_dir, "checkpoints-meta")
            os.makedirs(meta)
            for f in os.listdir(snaps[0]):      # the step-2 state
                os.link(os.path.join(snaps[0], f), os.path.join(meta, f))
            tc = time.perf_counter()
            resumed = TA.train(TA.parse(["--workdir", cut_dir] + common + [
                "--snapshot-freq", "1000000", "--no-snapshot-samples"])[0])
            torch.cuda.synchronize()
            errs = {name: rel_l2_all(a, b) for name, a, b in zip(
                ("params", "mu", "nu", "ema"), train_state_leaves(resumed),
                train_state_leaves(whole))}
            res[kind].update(resumed_run_s=time.perf_counter() - tc,
                             resumed_step=resumed.step,
                             resumed_vs_whole_rel_l2=errs,
                             tol=TRAIN_RESUME_TOL)
            if not (resumed.step == TRAIN_APP_ITERS
                    and max(errs.values()) <= TRAIN_RESUME_TOL):
                raise AssertionError(f"train app resume: {res[kind]}")
            # --fsdp: the state sharded over the 1-rank mesh's data axis
            from naturaldiffusion_tpu_torch.parallel.shardings import full
            tf = time.perf_counter()
            sharded = TA.train(TA.parse(
                ["--workdir", os.path.join(tmp, f"{kind}_fsdp")] + common
                + ["--fsdp", "--snapshot-freq", "1000000",
                   "--no-snapshot-samples"])[0])
            torch.cuda.synchronize()
            errs = {name: rel_l2_all([full(t) for t in a], b)
                    for name, a, b in zip(
                        ("params", "mu", "nu", "ema"),
                        train_state_leaves(sharded),
                        train_state_leaves(whole))}
            res[kind].update(fsdp_run_s=time.perf_counter() - tf,
                             fsdp_vs_whole_rel_l2=errs)
            if not (sharded.step == TRAIN_APP_ITERS
                    and max(errs.values()) <= TRAIN_RESUME_TOL):
                raise AssertionError(f"train app --fsdp: {res[kind]}")
            del whole, resumed, sharded
            torch.cuda.empty_cache()
            for d in (cut_dir, os.path.join(tmp, f"{kind}_fsdp")):
                shutil.rmtree(d, ignore_errors=True)
    if "start step 2" not in log.getvalue():
        raise AssertionError("train app: the resumed run did not start at "
                             "step 2")
    return res, launches


def train_bench(flops):
    """(6) ``apps.bench_train`` at each conv switch and type, with the
    busy share and top kernels of one profiled step."""
    import torch
    from naturaldiffusion_tpu_torch.apps import bench_train
    from naturaldiffusion_tpu_torch.apps.bench import form_env
    from naturaldiffusion_tpu_torch.models.ncsnpp import NCSNpp
    rows = {}
    net = NCSNpp(device="cuda")      # one model for the four runs
    for flag in ("2", "0"):
        for kind in ("f32", "bf16"):
            argv = list(BENCH_TRAIN_ARGS) + ["--flops", str(flops)] + (
                ["--bf16"] if kind == "bf16" else [])
            with form_env(flag, ""):
                rec, one = bench_train.run(bench_train.parse(argv), net)
                prof = profiled(torch, one)
            print(json.dumps(rec), flush=True)
            rows[f"switch{flag}_{kind}"] = dict(
                step_ms=rec["step_ms"], img_per_s=rec["img_per_sec"],
                flops_per_step=rec["flops_per_step"],
                mfu_vs_f32_peak=rec["mfu_vs_f32_peak"],
                mfu_vs_bf16_peak=rec["mfu_vs_bf16_peak"],
                peak_mem_bytes=rec["peak_mem_bytes"],
                busy_share=prof["busy_share"],
                profiled_step=prof)
            del one
            torch.cuda.empty_cache()
    return rows


def phase_train(model_f32, smi, train_flops):
    """The training slice: (1) each kernel's backward, (2) the whole-model
    gradient, (3) optimizer steps, (4) launches, (5) the trainer, (6) the
    bench (see the constants).  Returns the trainer's launches, the bench's
    rows and the directory of the toy data and the f32 run's snapshots
    (the caller removes it)."""
    import shutil
    import tempfile
    import torch
    from naturaldiffusion_tpu_torch.ops import conv3x3 as C
    from naturaldiffusion_tpu_torch.ops import group_norm as G
    t0 = time.perf_counter()
    parts = {}
    gen = torch.Generator(device="cuda").manual_seed(SEED + 61)
    net = copy.deepcopy(model_f32).to("cuda")
    xs = torch.zeros((TRAIN_CHECK_BATCH, 32, 32, 3), device="cuda")
    ts = torch.full((TRAIN_CHECK_BATCH,), 500.0, device="cuda")
    rows = {}
    sigs = kernel_signatures(net, xs, ts)
    rows["torch.float32"] = grad_rows(torch, C, G, sigs, torch.float32, gen)
    parts["kernel_backward_f32"] = time.perf_counter() - t0
    tp = time.perf_counter()
    per_fwd = per_forward_counts(net, torch.float32, TRAIN_MODEL_BATCH)
    model_chk, opt = train_model_check(model_f32, net, per_fwd)
    parts["model_and_optimizer"] = time.perf_counter() - tp
    tp = time.perf_counter()
    net = net.to(torch.bfloat16)
    sigs = kernel_signatures(net, xs.to(torch.bfloat16), ts)
    rows["torch.bfloat16"] = grad_rows(torch, C, G, sigs, torch.bfloat16,
                                       gen)
    parts["kernel_backward_bf16"] = time.perf_counter() - tp
    del net
    worst = {d: max(max(r[2]) for r in rr) for d, rr in rows.items()}
    controls = max(max(r[3]) for r in rows["torch.bfloat16"])
    tp = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="natdiff_train_")
    try:
        app, launches = train_app_runs(per_fwd, tmp)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    shutil.rmtree(os.path.join(tmp, "bf16_whole"), ignore_errors=True)
    parts["train_app"] = time.perf_counter() - tp
    tp = time.perf_counter()
    bench = train_bench(int(train_flops.result()))
    parts["bench_train"] = time.perf_counter() - tp
    phase("train", t0, card=smi, per_forward=per_fwd,
          kernel_backward=dict(
              signatures={d: len(r) for d, r in rows.items()},
              worst_rel_l2=worst, tol_f32=GRAD_F32_TOL,
              tol_bf16=GRAD_BF16_TOL,
              control_bf16_plain_vs_f32_max_rel_l2=controls,
              rows=rows),
          model_check=model_chk, optimizer_steps=opt, train_app=app,
          bench_train=bench, launches=launches, seconds_by_part=parts)
    return launches, bench, tmp


@contextlib.contextmanager
def last_call(module, name):
    """Within the block, each call of ``module.<name>`` is recorded: the
    yielded dict holds the last one's ``args``, ``kwargs`` and ``out``."""
    saved, rec = getattr(module, name), {}

    def recorded(*args, **kwargs):
        out = saved(*args, **kwargs)
        rec.update(args=args, kwargs=kwargs, out=out)
        return out
    setattr(module, name, recorded)
    try:
        yield rec
    finally:
        setattr(module, name, saved)


@contextlib.contextmanager
def patched(module, name, value):
    saved = getattr(module, name)
    setattr(module, name, value)
    try:
        yield
    finally:
        setattr(module, name, saved)


@contextlib.contextmanager
def k9_off(factor=1.01):
    """Within the block, K9's output is ``factor`` times too large (a 1 %
    fault, the control of a check that runs K9)."""
    from naturaldiffusion_tpu_torch.ops import attention as A
    saved = A.flash_attention

    def off(*a, **k):
        return saved(*a, **k) * factor
    off.launches = 0                # the wrapper counts under its own name
    with patched(A, "flash_attention", off):
        yield


@contextlib.contextmanager
def plain_ni_convs_and_norms():
    """``plain_convs_and_norms`` and K1's plain version."""
    import importlib
    from naturaldiffusion_tpu_torch.ops import weighted_sum as WS
    ni = importlib.import_module("naturaldiffusion_tpu_torch.engine.ni")
    with patched(ni, "fused_weighted_sum", WS.fused_weighted_sum_reference), \
            plain_convs_and_norms():
        yield


def quiet(fn, *args):
    """``fn(*args)`` with its standard output captured: (result, lines)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(*args)
    return out, buf.getvalue().splitlines()


def entry_fid_stats(tmp, oracles):
    """``apps.fid_stats`` over the toy eval binary on the card against the
    CPU oracle's statistics, the control a train binary's."""
    import numpy as np
    import torch
    from naturaldiffusion_tpu_torch.apps import fid_stats

    def stats(data):
        out = os.path.join(tmp, "stats.npz")
        rc, lines = quiet(fid_stats.main, ["--data", data, "--out", out,
                                           "--batch", "64", "--limit",
                                           str(FID_STATS_N)])
        with np.load(out) as f:
            return (rc, lines, torch.from_numpy(f["mu"]),
                    torch.from_numpy(f["sigma"]))
    toy = os.path.join(tmp, "toy")
    rc, lines, mu, sigma = stats(os.path.join(toy, "test_batch.bin"))
    _, _, mu_c, _ = stats(os.path.join(toy, "data_batch_1.bin"))
    (mu_w, sigma_w), cpu_s, wait = oracles.get("fid_stats")
    res = dict(lines=lines, mu_rel_l2=rel_l2(mu, mu_w),
               sigma_rel_l2=rel_l2(sigma, sigma_w), tol=FORWARD_TOL,
               control_train_records_mu_rel_l2=rel_l2(mu_c, mu_w),
               cpu_oracle_s=cpu_s, cpu_oracle_wait=wait)
    print(f"  fid_stats: {json.dumps(res)}", flush=True)
    if not (rc == 0 and res["mu_rel_l2"] <= FORWARD_TOL
            and res["sigma_rel_l2"] <= FORWARD_TOL
            and res["control_train_records_mu_rel_l2"]
            >= CONTROL_FACTOR * FORWARD_TOL):
        raise AssertionError(f"fid_stats: {res}")
    return res


DEG_LINE = re.compile(r"(\w+) t=(\d+)\s+own-x0 mass mean=([\d.]+) "
                      r"P\(own>0.9\)=([\d.]+) max-prob mean=([\d.]+)")


def entry_degradation():
    """``apps.degradation`` at its defaults on the card, vp and flow: its
    printed numbers against the CPU's on the card's noise draw, beside the
    control of each schedule index 1 % off."""
    import numpy as np
    import torch
    from naturaldiffusion_tpu_torch.apps import degradation as D
    # the app's synthetic feature set and its default noise draw (seed 200)
    # on the card, for the CPU's run
    feats = np.random.default_rng(0).standard_normal((512, 256)).astype(
        np.float32)

    def draw(seed):
        g = torch.Generator(device="cuda").manual_seed(seed)
        return torch.randn(feats.shape, generator=g, device="cuda").cpu()

    def numbers(kind, t, noise):
        diag, mx = D.posterior_stats(feats, t, kind=kind, noise=noise.numpy(),
                                     device="cpu")
        return [float(diag.mean()), float((diag > 0.9).double().mean()),
                float(mx.mean())]
    res = {}
    for kind in ("vp", "flow"):
        rc, lines = quiet(D.main, ["--kind", kind])
        got = [DEG_LINE.match(ln).groups() for ln in lines]
        err = ctl = 0.0
        noise = draw(200)
        for _, t, *vals in got:
            card = [float(v) for v in vals]
            want = numbers(kind, int(t), noise)
            other = numbers(kind, round(int(t) * 1.01), noise)
            err = max(err, max(abs(a - b) for a, b in zip(card, want)))
            ctl = max(ctl, max(abs(a - b) for a, b in zip(card, other)))
        res[kind] = dict(lines=lines, max_abs_err=err,
                         control_t_1pct_off_max_abs=ctl)
        if not (rc == 0 and len(got) == 8 and err <= DEG_TOL < ctl):
            raise AssertionError(f"degradation {kind}: {res[kind]}, limit "
                                 f"{DEG_TOL:g}")
    print(f"  degradation: {json.dumps(res)}", flush=True)
    return dict(res, tol=DEG_TOL)


def entry_roundtrip(tmp, n_plain, n_gn, n_k6):
    """``apps.roundtrip`` over the train phase's f32 snapshots: its CSV
    rows, snapshot 0's against the plain versions' run and another
    sampling seed's (the control); the launches of its NI runs."""
    import csv
    from naturaldiffusion_tpu_torch.apps import roundtrip as RT
    common = ["--workdir", os.path.join(tmp, "f32_whole"), "--data-dir",
              os.path.join(tmp, "toy"), *RT_ARGS,
              "--grid-dir", os.path.join(tmp, "grids")]

    def run(name, *extra):
        out = os.path.join(tmp, f"rt_{name}.csv")
        rc, lines = quiet(RT.main, common + ["--out", out, *extra])
        with open(out) as fh:
            return rc, lines, {int(r["step"]): r for r in csv.DictReader(fh)}
    counters = bench_counters()
    zero_counts(counters)
    tr = time.perf_counter()
    rc, lines, rows = run("kernels")
    wall = time.perf_counter() - tr
    launches = read_counts(counters)
    snaps = sorted(rows)
    want = expect_counts({"fused_weighted_sum": 0, "conv3x3": n_plain,
                          "conv3x3_gn": n_gn, "conv3x3_tiled": 0,
                          "fused_group_norm": n_k6},
                         STEPS * len(snaps), k1=STEPS * len(snaps))
    # snapshot 0 (the init, restored from no checkpoint) through the plain
    # versions, and with another sampling seed as the control
    with plain_ni_convs_and_norms():
        _, _, plain = run("plain", "--snapshots", "0")
    _, _, ctl = run("control", "--snapshots", "0", "--seed", "889")
    keys = [k for k in rows[0] if k == "fid" or (k.startswith("w1_")
                                                 and not k.endswith("floor"))]

    def worst(a, b):
        return max(abs(float(a[k]) - float(b[k]))
                   / max(abs(float(b[k])), 1e-3) for k in keys)
    res = dict(snapshots=snaps, rows=[rows[s] for s in snaps],
               rel_err_vs_plain=worst(rows[0], plain[0]), tol=RT_TOL,
               control_other_seed_rel=worst(ctl[0], plain[0]),
               wall_s=wall, launches=launches)
    print(f"  roundtrip: {json.dumps(res)}", flush=True)
    if not (rc == 0 and snaps == [0, 1, 2] and launches == want
            and all(rows[s]["finite"] == "True" for s in snaps)
            and res["rel_err_vs_plain"] <= RT_TOL
            and res["control_other_seed_rel"] >= CONTROL_FACTOR * RT_TOL):
        raise AssertionError(f"roundtrip: {res}, launches want {want}")
    return res, launches


def entry_sd3_app(name, argv, tol):
    """``apps.<name>`` (sd3_ni or bench_sd3) with its MMDiT's every weight
    random (the JAX init zeroes the output layers, which would hide the
    attention), its last NI call repeated in f32 (a bf16 model cast, as
    bench_sd3's) through the kernels, the plain versions and with K9's
    output 1 % off; the app's own output against the f32 plain run within
    ``tol``.  Returns the numbers and the launches."""
    import importlib
    import torch
    from naturaldiffusion_tpu_torch.models.mmdit import MMDiT
    app = importlib.import_module(f"naturaldiffusion_tpu_torch.apps.{name}")

    def seeded(*a, **k):
        return randomize_dit_(MMDiT(*a, **k), SEED + 90)
    counters = dit_counters()
    zero_counts(counters)
    tr = time.perf_counter()
    with patched(app, "MMDiT", seeded), \
            last_call(app, "sd3_natural_inference") as rec:
        rc, lines = quiet(app.main, argv)
    wall = time.perf_counter() - tr
    launches = read_counts(counters)

    def f32(a):
        if isinstance(a, torch.nn.Module):
            return copy.deepcopy(a).float()
        if torch.is_tensor(a) and a.is_floating_point():
            return a.float()
        return a
    again = functools.partial(app.sd3_natural_inference,
                              *map(f32, rec["args"]),
                              **{k: f32(v) for k, v in rec["kwargs"].items()})
    with plain_versions():
        want = again()
    got = again()
    with k9_off():
        ctl = again()
    out = rec["out"]
    model = rec["args"][0]
    res = dict(lines=lines, model_dtype=str(next(model.parameters()).dtype),
               rel_l2_app_vs_f32_plain=rel_l2(out, want), tol=tol,
               rel_l2_f32_vs_plain=rel_l2(got, want), tol_f32=SD3_F32_TOL,
               control_k9_1pct_off_rel_l2=rel_l2(ctl, want),
               wall_s=wall, launches=launches)
    print(f"  {name}: {json.dumps(res)}", flush=True)
    if not (rc == 0 and bool(torch.isfinite(out.float()).all())
            and launches["fused_weighted_sum"] > 0
            and launches["flash_attention"] > 0
            and res["rel_l2_app_vs_f32_plain"] <= tol
            and res["rel_l2_f32_vs_plain"] <= SD3_F32_TOL
            < res["control_k9_1pct_off_rel_l2"]):
        raise AssertionError(f"{name}: {res}")
    return res, launches


def phase_entry_points(tmp, oracles, n_plain, n_gn, n_k6, smi):
    """The entry points no other phase drives (see TOY_ARGS):
    ``fid_stats``, ``degradation``, ``roundtrip``, ``sd3_ni --small`` and
    ``bench_sd3 --toy``.  ``tmp``: the train phase's directory (its toy
    data and f32 workdir), removed here.  Returns the launches by app."""
    import shutil
    import tempfile
    import torch
    t0 = time.perf_counter()
    parts, res, launches = {}, {}, {}
    try:
        res["fid_stats"] = entry_fid_stats(tmp, oracles)
        parts["fid_stats"] = time.perf_counter() - t0
        tp = time.perf_counter()
        res["degradation"] = entry_degradation()
        parts["degradation"] = time.perf_counter() - tp
        tp = time.perf_counter()
        res["roundtrip"], launches["roundtrip"] = entry_roundtrip(
            tmp, n_plain, n_gn, n_k6)
        parts["roundtrip"] = time.perf_counter() - tp
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="natdiff_") as d:
        tp = time.perf_counter()
        res["sd3_ni"], launches["sd3_ni"] = entry_sd3_app(
            "sd3_ni", ["--small", "--outdir", d], SD3_APP_TOL["sd3_ni"])
        parts["sd3_ni"] = time.perf_counter() - tp
    tp = time.perf_counter()
    res["bench_sd3"], launches["bench_sd3"] = entry_sd3_app(
        "bench_sd3", ["--toy", "--latent", str(SD3_TOY_LATENT)],
        SD3_APP_TOL["bench_sd3"])
    parts["bench_sd3"] = time.perf_counter() - tp
    torch.cuda.empty_cache()
    phase("entry_points", t0, card=smi, **res, seconds_by_part=parts)
    return launches


def bench_counters():
    from naturaldiffusion_tpu_torch.ops import conv3x3 as C
    from naturaldiffusion_tpu_torch.ops import group_norm as G
    from naturaldiffusion_tpu_torch.ops import weighted_sum as WS
    return {"fused_weighted_sum": WS.fused_weighted_sum,
            "conv3x3": C.conv3x3, "conv3x3_gn": C.conv3x3_gn,
            "conv3x3_tiled": C.conv3x3_tiled,
            "fused_group_norm": G.fused_group_norm}


def trace_launches(logdir):
    """Device launches of K1, K2, K3, K6 and the int8 conv in the newest
    ``torch.profiler`` trace under ``logdir``, by kernel name.  K2 is the tensor-core conv's
    instance without prologue, skip or sums (K4 runs the same instance in
    bf16; the CIFAR path has no K4), K3 every other instance; K6 is one
    ``gn_*`` kernel a call in its on-chip form, the CIFAR form."""
    from naturaldiffusion_tpu_torch.utils import trace_summary
    n = {"fused_weighted_sum": 0, "conv3x3": 0, "conv3x3_gn": 0,
         "fused_group_norm": 0, "conv3x3_int8": 0}
    for e in trace_summary.load_events(logdir):
        name = e.get("name", "")
        if "weighted_sum_kernel" in name:
            n["fused_weighted_sum"] += 1
        elif "conv3x3_int8_kernel<" in name:
            n["conv3x3_int8"] += 1
        elif "conv3x3_tc_kernel<" in name:
            args = name.split("conv3x3_tc_kernel<", 1)[1].split(">", 1)[0]
            flags = [f.strip() for f in args.split(",")[2:5]]
            n["conv3x3" if flags == ["false"] * 3 else "conv3x3_gn"] += 1
        elif "gn_onchip_kernel" in name or "gn_grid_kernel" in name:
            n["fused_group_norm"] += 1
    return n


def whole_trace_launches(B, b, logdir, rec, want):
    """``trace_launches`` of the dispatch that ``B.measure`` profiled into
    ``logdir`` for ``rec``, compared on ``want``'s kernels: a trace that
    counts fewer of some and more of none lost records, and the dispatch is
    profiled again (``rec`` takes the new one's numbers) until a trace
    counts ``want`` or BENCH_TRACE_TRIES traces were made.  ``tries`` in
    ``rec["traced_dispatch"]`` counts the traces; the caller holds the
    counts returned to ``want``."""
    import contextlib as cl
    import io
    for tries in range(1, BENCH_TRACE_TRIES + 1):
        traced = trace_launches(logdir)
        got = {k: traced[k] for k in want}
        if (got == want or tries == BENCH_TRACE_TRIES
                or any(got[k] > want[k] for k in want)):
            break
        print(f"  bench {rec['form']}: trace {tries} counts {got}, fewer "
              f"than the graph's {want}: the profiler lost records; "
              f"profiling again", flush=True)
        with cl.redirect_stdout(io.StringIO()):
            prof = B.profile_dispatch(b, logdir, 99 + tries,
                                      BENCH_CHUNKS_TRACED)
        rec["traced_dispatch"], rec["busy"] = prof, round(prof["busy"], 4)
    rec["traced_dispatch"]["tries"] = tries
    return traced


def bench_eager_s(b, chunks, seed):
    """Wall seconds of ``chunks`` micro-batches of the bench by its eager
    loop, ending in one host read of their sum."""
    import torch
    gen = torch.Generator(device="cuda").manual_seed(seed)
    t = time.perf_counter()
    total = torch.zeros((), device="cuda")
    for c in range(chunks):
        total += b.eager_chunk(c, gen).sum()
    if not math.isfinite(float(total)):
        raise AssertionError("bench: non-finite eager checksum")
    return time.perf_counter() - t


def phase_bench(n_plain, n_gn, n_k6, flops):
    """The port bench on one ``Bench`` at its defaults: the launch counts
    of its warm-up and capture, its replays (one a micro-batch), its
    BENCH_DISPATCHES timed graphed
    dispatches, one profiled
    dispatch of ``BENCH_CHUNKS_TRACED`` replays (its busy share and the
    device launches of each kernel in the trace), eager chunks timed as the
    control, and one chunk graphed against eager with random weights.
    ``flops``: the bench's ``--flops-only`` count, taken while the kernels
    built.  Returns the bench's launches, the trace's and its records."""
    import contextlib as cl
    import io
    import shutil
    import tempfile
    import torch
    from naturaldiffusion_tpu_torch.apps import bench as B

    t0 = time.perf_counter()
    counters = bench_counters()
    per_chunk = {"fused_weighted_sum": STEPS, "conv3x3": STEPS * n_plain,
                 "conv3x3_gn": STEPS * n_gn, "conv3x3_tiled": 0,
                 "fused_group_norm": STEPS * n_k6}
    steps_s = {}

    def lap(name):
        steps_s[name] = time.perf_counter() - t0 - sum(steps_s.values())

    # the main path: zeroed before the bench is built, read after its run;
    # the wrappers count its eager warm-up and its capture, once each (a
    # replay calls no wrapper)
    want_traced = {k: BENCH_CHUNKS_TRACED * v for k, v in per_chunk.items()
                   if k != "conv3x3_tiled"}
    want_traced["conv3x3_int8"] = 0
    zero_counts(counters)
    b = B.Bench(micro=BATCH, total=BENCH_TOTAL, steps=STEPS, device="cuda",
                graph=True, conv="2", quant="")
    replays0 = b.graphed.replays
    b.dispatch(2)                                   # warm dispatch
    logdir = tempfile.mkdtemp(prefix="natdiff_bench_")
    buf = io.StringIO()
    try:
        with cl.redirect_stdout(buf):
            graphed = B.measure(b, flops, trace_dir=logdir,
                                trace_chunks=BENCH_CHUNKS_TRACED,
                                dispatches=BENCH_DISPATCHES)
        traced = whole_trace_launches(B, b, logdir, graphed, want_traced)
    finally:
        shutil.rmtree(logdir, ignore_errors=True)
    launches = read_counts(counters)
    lap("graphed_and_traced")
    if launches != {k: 2 * v for k, v in per_chunk.items()}:
        raise AssertionError(f"bench launches {launches}, want twice "
                             f"{per_chunk}")
    # one replay a micro-batch: the warm and timed dispatches' 16 each, and
    # BENCH_CHUNKS_TRACED a trace
    replays = b.graphed.replays - replays0
    want_replays = ((1 + BENCH_DISPATCHES) * (BENCH_TOTAL // BATCH)
                    + graphed["traced_dispatch"]["tries"] * BENCH_CHUNKS_TRACED)
    if replays != want_replays:
        raise AssertionError(f"bench: {replays} replays, want {want_replays}")
    if traced != want_traced:
        raise AssertionError(f"bench: the traced dispatch's device launches "
                             f"{traced} != {want_traced}")
    if not (graphed["graph"] and graphed["busy"] is not None
            and graphed["form"] == "fused_bf16"
            and graphed["total_batch"] == BENCH_TOTAL
            and graphed["micro_batch"] == BATCH and graphed["steps"] == STEPS
            and graphed["value"] > 0):
        raise AssertionError(f"bench line: {graphed}")

    # the eager control on the same bench, timed as a dispatch is
    bench_eager_s(b, 1, 5)                          # warm-up
    eager_s = [bench_eager_s(b, BENCH_CHUNKS_EAGER, 6 + i)
               for i in range(BENCH_EAGER_RUNS)]
    eager_ips = BENCH_CHUNKS_EAGER * BATCH / statistics.median(eager_s)
    lap("eager")

    def chunk(graph):
        gen = torch.Generator(device="cuda").manual_seed(SEED + 41)
        out = (b.chunk if graph else b.eager_chunk)(1, gen).clone()
        torch.cuda.synchronize()
        return out

    def planted_fault():
        """``BENCH_FAULT_CONV`` zeroed in place: the rel L2 it moves a
        replay by, from the eager run before it; the weights restored."""
        w = dict(b.net.named_modules())[BENCH_FAULT_CONV].kernel
        saved = w.detach().clone()
        before = chunk(False)
        with torch.no_grad():
            w.zero_()
        moved = rel_l2(chunk(True), before)
        with torch.no_grad():
            w.copy_(saved)
        return moved, before

    # NCSN++'s own init (the bench's weights) zeroes every Conv_1 and the
    # head conv, so a fault in a residual branch barely reaches the samples
    fault_at_init, _ = planted_fault()
    randomize_(b.net, SEED + 5)       # in place: the graph reads the same
    eager1, eager2 = chunk(False), chunk(False)
    replay1, replay2 = chunk(True), chunk(True)
    control = rel_l2(eager2, eager1)
    err = rel_l2(replay1, eager1)
    fault, before = planted_fault()
    restored = rel_l2(chunk(True), before)
    lap("graph_vs_eager")
    print(f"  bench graph vs eager, random weights: rel L2 {err:.3e}, two "
          f"eager runs {control:.3e}, replay vs replay "
          f"{rel_l2(replay2, replay1):.3e}; {BENCH_FAULT_CONV} zeroed moves "
          f"a replay {fault:.3e} (at the seed init {fault_at_init:.3e}), "
          f"restored {restored:.3e}; limit {BENCH_GRAPH_TOL:g}", flush=True)
    if not (torch.isfinite(replay1).all() and err <= BENCH_GRAPH_TOL
            and restored <= BENCH_GRAPH_TOL and fault > BENCH_GRAPH_TOL):
        raise AssertionError(f"bench: graph vs eager rel L2 {err:.3e}, "
                             f"restored {restored:.3e} (limit "
                             f"{BENCH_GRAPH_TOL:g}), planted fault "
                             f"{fault:.3e} must exceed it")
    eager = dict(value=eager_ips, images=BENCH_CHUNKS_EAGER * BATCH,
                 dispatch_s=eager_s)
    print(f"  bench graphed: {graphed['value']} img/s, eager "
          f"({BENCH_CHUNKS_EAGER * BATCH} images): {eager_ips:.2f} img/s; "
          f"{graphed['card']}", flush=True)
    print(f"  bench graph: capture {graphed['capture_s']:.3f} s, pool "
          f"{graphed['graph_pool_bytes'] / 2 ** 20:.1f} MiB; busy share of "
          f"a profiled dispatch of {BENCH_CHUNKS_TRACED} replays "
          f"{graphed['busy']}", flush=True)
    for ln in buf.getvalue().splitlines():
        print("  " + ln, flush=True)
    phase("bench", t0, graphed=graphed, eager=eager, launches=launches,
          traced_launches=traced, rel_l2_graph_vs_eager=err,
          control_eager_vs_eager=control, tol=BENCH_GRAPH_TOL,
          replays_equal=bool(torch.equal(replay1, replay2)),
          rel_l2_replay_vs_replay=rel_l2(replay2, replay1),
          planted_fault=dict(conv=BENCH_FAULT_CONV, rel_l2=fault,
                             rel_l2_at_seed_init=fault_at_init,
                             restored_rel_l2=restored),
          steps_s=steps_s)
    del b
    torch.cuda.empty_cache()
    return launches, traced, dict(graphed=graphed, eager=eager)


# ----------------------------------------------- int8 convs, routes, forms

def int8_signatures(model, x, t):
    """{(x shape, w shape): calls} of the int8 3x3 convs of one forward in
    the bench's default form (``NATDIFF_PALLAS_CONV=0``, ``int8_static``)."""
    import torch
    from naturaldiffusion_tpu_torch.apps.bench import form_env
    from naturaldiffusion_tpu_torch.models.layers import PConv3x3
    seen = {}

    def hook(mod, args, kwargs, out):
        fused = (kwargs.get("pre") is not None
                 or kwargs.get("skip") is not None or kwargs.get("emit_stats"))
        if not fused and mod.route(args[0]) == "int8":
            k = (tuple(args[0].shape), tuple(mod.kernel.shape))
            seen[k] = seen.get(k, 0) + 1

    hooks = [m.register_forward_hook(hook, with_kwargs=True)
             for m in model.modules() if isinstance(m, PConv3x3)]
    with torch.no_grad(), form_env(*BENCH_DEFAULT_FORM[:2]):
        model(x, t)
    for h in hooks:
        h.remove()
    return seen


def int8_cost(xs, ws, dyn):
    """Operations, bytes (bf16 x in, int8 weights, f32 s_w, bf16 bias and
    y out, per-sample f32 scales) and the bound in ms of one int8 conv."""
    b, h, w, cin = xs
    cout = ws[3]
    ops = 2.0 * b * h * w * 9 * cin * cout
    nbytes = (2 * b * h * w * cin + 9 * cin * cout + 6 * cout
              + 2 * b * h * w * cout + (4 * b if dyn else 0))
    t_ops, t_bytes = ops / INT8_PEAK, nbytes / HBM_BYTES_PER_S
    return ops, nbytes, max(t_ops, t_bytes) * 1e3, (
        "operations" if t_ops >= t_bytes else "bytes")


def bf16_ulps(a, b):
    """Largest distance in bf16 units in the last place between two bf16
    tensors of the same signs (their bit patterns as integers)."""
    import torch
    d = (a.view(torch.int16).int() - b.view(torch.int16).int()).abs()
    return int(d.max()) if d.numel() else 0


def phase_int8_kernels(model_bf16, details):
    """The int8 conv at every 3x3 int8 conv shape of the CIFAR bench's
    default (unfused int8) walk at batch 64, static and dynamic: its int8
    operands (the weights made on the card against the CPU's bytes; the
    activations read back through an identity tap, whose bf16 outputs are
    one to one with the int8 values) and its output against the plain
    version bit for bit, a seeded fault in one int8 weight, then timed
    beside its bound, the plain version and two library yardsticks the
    port never calls on the path: ``F.conv2d`` in bf16 (cuDNN) and
    ``torch._int_mm`` over an im2col of the int8 input (made beforehand)."""
    import torch
    import torch.nn.functional as F
    from naturaldiffusion_tpu_torch.ops import quant as Q

    t0 = time.perf_counter()
    timer, slow = Timer(torch), Timer(torch, reps=3)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 30)

    def rn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    x = rn(BATCH, 32, 32, 3).to(torch.bfloat16)
    sigs = int8_signatures(model_bf16, x, torch.full((BATCH,), 500.0,
                                                     device="cuda"))
    n_int8 = sum(sigs.values())
    amax = Q.static_amax()
    rows = []
    for (xs, ws), mult in sigs.items():
        b, h, w, cin = xs
        cout = ws[3]
        # |x| up to ~9, so the static clip at 6 is reached
        xx = (2.0 * rn(*xs)).to(torch.bfloat16)
        wt = (rn(*ws) / math.sqrt(9 * cin)).to(torch.bfloat16)
        bias = (0.1 * rn(cout)).to(torch.bfloat16)
        w_i8, s_w, wk = Q.quantize_conv_weight(wt)
        on_cpu = Q.quantize_conv_weight(wt.cpu())
        if not all(torch.equal(a.cpu(), c) for a, c in zip((w_i8, s_w, wk),
                                                           on_cpu)):
            raise AssertionError(f"int8 {xs}: weights quantized on the card "
                                 f"differ from the CPU's")
        eye = torch.zeros((3, 3, cin, cin), dtype=torch.int8, device="cuda")
        eye[1, 1] = torch.eye(cin, dtype=torch.int8, device="cuda")
        ones = torch.ones(cin, device="cuda")
        row = dict(sig=repr((xs, ws)), per_forward=mult,
                   plan=Q._int8_plan(b, h, w, cin, cout))
        for mode, am in (("static", amax), ("dynamic", None)):
            got = Q.conv3x3_int8(xx, None, None, w_i8=eye, s_w=ones,
                                 act_amax=am)
            want = Q.conv3x3_int8_reference(xx, eye, ones, act_amax=am)
            if not torch.equal(got, want):
                raise AssertionError(
                    f"int8 {xs} {mode}: activation operands differ in "
                    f"{int((got != want).sum())} elements")
            run = functools.partial(Q.conv3x3_int8, xx, None, bias, w_i8=w_i8,
                                    s_w=s_w, w_kern=wk, act_amax=am)
            got = run()
            want = Q.conv3x3_int8_reference(xx, w_i8, s_w, bias, act_amax=am)
            ndiff = int((got != want).sum())
            row[f"differ_{mode}"] = ndiff
            row[f"ulps_{mode}"] = bf16_ulps(got, want)
            if ndiff:
                raise AssertionError(
                    f"int8 {xs} {mode}: {ndiff} elements differ from the "
                    f"plain version, by up to {row[f'ulps_{mode}']} ulps")
            # a seeded fault: one int8 weight (centre tap, output 0, input
            # 0) moved by one step must move the output
            wf = wk.clone()
            v = int(wf[4, 0, 0])
            wf[4, 0, 0] = v + 1 if v < 127 else v - 1
            bad = Q.conv3x3_int8(xx, None, bias, w_i8=w_i8, s_w=s_w,
                                 w_kern=wf, act_amax=am)
            row[f"fault_differs_{mode}"] = int((bad != want).sum())
            if not row[f"fault_differs_{mode}"]:
                raise AssertionError(f"int8 {xs} {mode}: a changed weight "
                                     f"left the output equal")
            row[f"ms_{mode}"] = timer(run)
            (row[f"ops_{mode}"], row[f"bytes_{mode}"], row[f"bound_ms_{mode}"],
             row[f"bound_by_{mode}"]) = int8_cost(xs, ws, mode == "dynamic")
        row["plain_ms"] = slow(lambda: Q.conv3x3_int8_reference(
            xx, w_i8, s_w, bias, act_amax=amax))
        xcl = xx.permute(0, 3, 1, 2)
        wcl = wt.permute(3, 2, 0, 1).contiguous(
            memory_format=torch.channels_last)
        row["library_ms"] = timer(lambda: F.conv2d(xcl, wcl, bias, padding=1))
        # torch._int_mm over an im2col of the int8 input; its int32 sums
        # also hold the plain version's
        xq = Q.quantize_act_static(xx, amax)[0]
        xp = F.pad(xq, (0, 0, 1, 1, 1, 1))
        cols = torch.cat([xp[:, dy:dy + h, dx:dx + w] for dy in range(3)
                          for dx in range(3)], dim=-1).reshape(b * h * w,
                                                               9 * cin)
        wmat = w_i8.reshape(9 * cin, cout).t().contiguous()
        acc = torch._int_mm(cols, wmat.t())
        with torch.backends.cudnn.flags(enabled=False):
            want_acc = F.conv2d(xq.permute(0, 3, 1, 2).double(),
                                w_i8.permute(3, 2, 0, 1).double(), padding=1)
        if not torch.equal(acc, want_acc.permute(0, 2, 3, 1).reshape(
                b * h * w, cout).to(torch.int32)):
            raise AssertionError(f"int8 {xs}: torch._int_mm's sums differ "
                                 f"from the plain version's")
        row["int_mm_ms"] = timer(lambda: torch._int_mm(cols, wmat.t()))
        rows.append(row)
        row["tops_static"] = row["ops_static"] / row["ms_static"] / 1e9
        row["tops_dynamic"] = row["ops_dynamic"] / row["ms_dynamic"] / 1e9
        print(f"  conv3x3_int8 {xs} -> {cout} x{mult}: static "
              f"{row['ms_static']:.4f} ms ({row['tops_static']:.1f} "
              f"TOPS, {row['bound_ms_static'] / row['ms_static']:.3f} of the "
              f"{row['bound_by_static']} bound {row['bound_ms_static']:.4f}), "
              f"dynamic {row['ms_dynamic']:.4f} ({row['tops_dynamic']:.1f} "
              f"TOPS), plain {row['plain_ms']:.3f}, "
              f"cuDNN bf16 {row['library_ms']:.4f}, _int_mm "
              f"{row['int_mm_ms']:.4f}; plan {row['plan']['units']} units, "
              f"split {row['plan']['splits']}, blocks "
              f"{row['plan']['blocks']}; "
              f"fault moved {row['fault_differs_static']}", flush=True)
        del xx, cols, xq, xp
    # ragged shapes of the plan: bit for bit, static and dynamic
    ragged = {}
    for xs, cout in INT8_RAGGED:
        xx = (2.0 * rn(*xs)).to(torch.bfloat16)
        w_i8, s_w, wk = Q.quantize_conv_weight(
            (rn(3, 3, xs[3], cout) / math.sqrt(9 * xs[3])).to(torch.bfloat16))
        bias = (0.1 * rn(cout)).to(torch.bfloat16)
        plan = Q._int8_plan(*xs, cout)
        for mode, am in (("static", amax), ("dynamic", None)):
            got = Q.conv3x3_int8(xx, None, bias, w_i8=w_i8, s_w=s_w,
                                 w_kern=wk, act_amax=am)
            want = Q.conv3x3_int8_reference(xx, w_i8, s_w, bias, act_amax=am)
            ndiff = int((got != want).sum())
            if ndiff:
                raise AssertionError(
                    f"int8 ragged {xs} -> {cout} {mode}: {ndiff} elements "
                    f"differ from the plain version")
        ragged[repr((xs, cout))] = dict(splits=plan["splits"],
                                        blocks=plan["blocks"], differ=0)
        print(f"  conv3x3_int8 ragged {xs} -> {cout}: split "
              f"{plan['splits']}, blocks {plan['blocks']}: bit for bit, "
              f"static and dynamic", flush=True)
    from naturaldiffusion_tpu_torch.ops import _cuda
    ptxas = kernel_ptxas(_cuda.build_dir() / "conv3x3_int8.log")
    for fn, regs, spill in ptxas:
        print(f"  conv3x3_int8 ptxas {fn}: {regs} registers, {spill} bytes "
              f"spilled", flush=True)
    details["conv3x3_int8"] = rows
    details["conv3x3_int8_ragged"] = ragged
    tot = {k: sum(r[k] * r["per_forward"] for r in rows)
           for k in ("ms_static", "ms_dynamic", "plain_ms", "library_ms",
                     "int_mm_ms", "bound_ms_static", "ops_static",
                     "bytes_static")}
    bound_by = ("operations" if tot["ops_static"] / INT8_PEAK
                >= tot["bytes_static"] / HBM_BYTES_PER_S else "bytes")
    entry = dict(
        name="conv3x3_int8", route="cuda",
        source="naturaldiffusion_tpu_torch/csrc/conv3x3_int8.cu",
        replaces="naturaldiffusion_tpu/ops/quant.py:153",
        max_abs_err=0.0, ms=tot["ms_static"], plain_ms=tot["plain_ms"],
        bound_ms=tot["bound_ms_static"], bound_by=bound_by,
        library_ms=tot["library_ms"],
        library_int_mm_ms=tot["int_mm_ms"], ms_dynamic=tot["ms_dynamic"],
        note="not Pallas: JAX's conv3x3_int8 is an XLA s8 conv "
             "(ops/quant.py:153-156); static mode, summed over one "
             "batch-64 forward's int8 launches; library_ms is cuDNN's bf16 "
             "conv, library_int_mm_ms torch._int_mm over an im2col")
    phase("int8_kernels", t0, shapes=len(rows), per_forward_launches=n_int8,
          bitwise_equal=True, ragged=len(ragged),
          ptxas={fn: [regs, spill] for fn, regs, spill in ptxas},
          per_forward={k: round(v, 4) for k, v in tot.items()
                       if "ms" in k},
          achieved_tops=tot["ops_static"] / tot["ms_static"] / 1e9,
          bound_by=bound_by)
    return entry, n_int8


def phase_quant_ops(smi):
    """``apps.bench_quant_ops`` (QUANT_OPS_ARGS) on the card: a JSON line a
    shape, every row timed or its error, Q1's launches counted; then each
    row at a 3x3 and a NIN shape against its plain version on the CPU.
    Returns (Q1's launches, the lines)."""
    import torch
    from naturaldiffusion_tpu_torch.apps import bench_quant_ops as BQ
    from naturaldiffusion_tpu_torch.ops import quant as Q

    t0 = time.perf_counter()
    counters = {"conv3x3_int8": Q.conv3x3_int8}
    zero_counts(counters)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = BQ.main(list(QUANT_OPS_ARGS))
    torch.cuda.synchronize()
    launches = read_counts(counters)
    lines = [json.loads(ln) for ln in buf.getvalue().splitlines()]
    rows = {"conv": ("bf16", "int8_dyn", "int8_pt", "int8_st", "int8_raw"),
            "nin": ("bf16", "int8_dyn", "int8_st"),
            "gemm": ("bf16", "int8_raw")}
    want_shapes = ([["gemm", BQ.GEMM_N, BQ.GEMM_N, BQ.GEMM_N]]
                   + [list(sh) for sh in BQ.SHAPES]
                   + [["nin", *sh] for sh in BQ.NIN_SHAPES])
    # Q1's rows (the port's kernel) may not raise; a library row's error is
    # reported, as the JAX app reports it
    missing, errors, q1_errors = [], {}, []
    for ln in lines:
        kind = ln["shape"][0] if isinstance(ln["shape"][0], str) else "conv"
        for r in rows[kind]:
            if f"{r}_error" in ln:
                errors[f"{ln['shape']} {r}"] = ln[f"{r}_error"]
                if kind == "conv" and r != "bf16":
                    q1_errors.append(f"{ln['shape']} {r}")
            elif not ln.get(f"{r}_ms", 0) > 0:
                missing.append(f"{ln['shape']} {r}")
        print("  " + json.dumps(ln), flush=True)
    reps, runs = int(QUANT_OPS_ARGS[1]), int(QUANT_OPS_ARGS[3])
    want_q1 = len(BQ.SHAPES) * 4 * (1 + reps * runs)
    if (rc != 0 or [ln["shape"] for ln in lines] != want_shapes or missing
            or q1_errors or launches["conv3x3_int8"] != want_q1):
        raise AssertionError(f"bench_quant_ops: rc {rc}, shapes "
                             f"{[ln['shape'] for ln in lines]}, missing "
                             f"{missing}, errors {errors}, Q1 launches "
                             f"{launches} (want {want_q1})")
    # the rows' outputs against their plain versions on the CPU, at the
    # last 3x3 shape and the middle NIN shape with 8 images
    cpu = torch.device("cpu")
    errs = {}
    for kind, shape in (("conv", (8,) + BQ.SHAPES[-1][1:]),
                        ("nin", (8,) + BQ.NIN_SHAPES[1][1:])):
        make = BQ.conv_rows if kind == "conv" else BQ.nin_rows
        ins = BQ.inputs(shape, torch.device("cuda"), nin=kind == "nin")
        card = {k: f().float().cpu() for k, f in make(*ins).items()}
        plain = {k: f().float() for k, f in
                 make(*(t.to(cpu) for t in ins)).items()}
        for k, want in plain.items():
            d = (card[k] - want).abs()
            # one bf16 rounding of the output (the int8 rows: the same
            # int32 sums, the dequant's roundings); bf16 sums in another
            # order for the bf16 row
            lim = (2.0 ** -8 * want.abs() if k != "bf16" else
                   2.0 ** -7 * float(want.abs().max()))
            errs[f"{kind} {k}"] = float(d.max())
            if not bool(torch.isfinite(card[k]).all()) or bool(
                    (d > lim + 1e-30).any()):
                raise AssertionError(f"bench_quant_ops {kind} {shape} row "
                                     f"{k}: max abs err {float(d.max())}")
    phase("quant_ops", t0, card=smi, args=list(QUANT_OPS_ARGS),
          shapes=len(lines), library_errors=errors, launches=launches,
          rows_vs_plain_max_abs_err=errs)
    return launches, lines


def form_counters():
    from naturaldiffusion_tpu_torch.ops import quant as Q
    return dict(bench_counters(), conv3x3_int8=Q.conv3x3_int8)


def cosine(a, b):
    a, b = a.double().flatten(), b.double().flatten()
    return float(a @ b / (a.norm() * b.norm()))


def phase_routes(model_bf16, model_f32, n_plain, n_gn, n_int8):
    """One batch-64 CIFAR forward in bf16 under each of ROUTE_FORMS,
    against the f32 fused forward of the same weights, with the launches
    of each: no K2, K3 or K4 under ``0``; one int8 launch per unfused 3x3
    conv with channel counts multiples of 128 under an int8 mode."""
    import torch
    from naturaldiffusion_tpu_torch.apps.bench import form_env, form_name

    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(SEED + 31)
    x = torch.randn((BATCH, 32, 32, 3), generator=gen, device="cuda")
    tc = torch.linspace(10.0, 990.0, BATCH, device="cuda")
    card32 = copy.deepcopy(model_f32).to("cuda")
    with torch.no_grad(), form_env("2", ""):
        ref = card32(x, tc)
    del card32
    counters = form_counters()
    res = {}
    for flag, quant in ROUTE_FORMS:
        with torch.no_grad(), form_env(flag, quant):
            model_bf16(x.to(torch.bfloat16), tc)      # int8 weights, plans
            torch.cuda.synchronize()
            zero_counts(counters)
            out = model_bf16(x.to(torch.bfloat16), tc)
            torch.cuda.synchronize()
        n = read_counts(counters)
        name = f"{form_name(flag, quant)}_conv{flag}"
        res[name] = dict(rel_l2=rel_l2(out, ref), cos=cosine(out, ref),
                         launches=n)
        want = {"conv3x3_int8": n_int8 if quant and flag == "0" else 0,
                "conv3x3_tiled": 0}
        if flag == "0":
            want.update(conv3x3=0, conv3x3_gn=0)
        elif flag == "1":
            want.update(conv3x3=n_plain + n_gn, conv3x3_gn=0)
        else:
            want.update(conv3x3=n_plain, conv3x3_gn=n_gn)
        got = {k: n[k] for k in want}
        print(f"  routes {name}: rel L2 {res[name]['rel_l2']:.3e} against "
              f"the f32 fused forward, cos {res[name]['cos']:.6f}, launches "
              f"{n}", flush=True)
        if got != want or not torch.isfinite(out).all():
            raise AssertionError(f"routes {name}: launches {got} != {want}")
        if res[name]["rel_l2"] > ROUTES_REL or res[name]["cos"] < ROUTES_COS:
            raise AssertionError(f"routes {name}: {res[name]} past "
                                 f"{ROUTES_REL:g} / {ROUTES_COS}")
    phase("routes", t0, forms=res,
          control_bf16=res["fused_bf16_conv2"]["rel_l2"],
          limits=dict(rel_l2=ROUTES_REL, cos=ROUTES_COS))
    return res


def bench_form(B, net, flops, conv, quant, mods, total, want_traced):
    """One bench form on ``net``: its build (eager warm-up and capture)
    and its run counted, its replays held to one a micro-batch, the JSON
    line of its timed dispatch (one of ``total`` images if that is the
    full bench, else the median of BENCH_FORM_DISPATCHES) with, unless
    ``want_traced`` is None, a profiled dispatch of BENCH_CHUNKS_TRACED
    replays (the card's busy share) and its device launches
    (``whole_trace_launches`` against ``want_traced``), and one chunk
    graphed against eager."""
    import contextlib as cl
    import io
    import shutil
    import tempfile
    import torch

    laps, tl = {}, time.perf_counter()

    def lap(name):
        nonlocal tl
        laps[name] = time.perf_counter() - tl
        tl = time.perf_counter()
    counters = form_counters()
    zero_counts(counters)
    b = B.Bench(micro=BATCH, total=total, steps=STEPS, device="cuda",
                graph=True, conv=conv, quant=quant, mods=mods, net=net)
    lap("build")
    replays0 = b.graphed.replays
    b.dispatch(2, chunks=2)                         # warm
    lap("warm")
    trace = want_traced is not None
    logdir = tempfile.mkdtemp(prefix="natdiff_form_") if trace else None
    buf = io.StringIO()
    try:
        with cl.redirect_stdout(buf):
            rec = B.measure(b, flops, trace_dir=logdir,
                            trace_chunks=BENCH_CHUNKS_TRACED,
                            dispatches=1 if total == BENCH_TOTAL
                            else BENCH_FORM_DISPATCHES)
        lap("measure")
        traced = (whole_trace_launches(B, b, logdir, rec, want_traced)
                  if trace else None)
        lap("trace_launches")
    finally:
        if logdir:
            shutil.rmtree(logdir, ignore_errors=True)
    launches = read_counts(counters)
    # one replay a micro-batch: 2 warm, the timed dispatches', the traces'
    replays = b.graphed.replays - replays0
    want_replays = 2 + (1 if total == BENCH_TOTAL else BENCH_FORM_DISPATCHES
                        ) * (total // BATCH) + (
        rec["traced_dispatch"]["tries"] * BENCH_CHUNKS_TRACED if trace else 0)
    if replays != want_replays:
        raise AssertionError(f"bench {rec['form']}: {replays} replays, want "
                             f"{want_replays}")

    def chunk(graph):
        g = torch.Generator(device="cuda").manual_seed(SEED + 42)
        out = (b.chunk if graph else b.eager_chunk)(1, g).clone()
        torch.cuda.synchronize()
        return out

    eager = chunk(False)
    replay = chunk(True)
    err = rel_l2(replay, eager)
    lap("graph_vs_eager")
    del b
    torch.cuda.empty_cache()
    return (rec, launches, traced, err, bool(torch.isfinite(replay).all()),
            laps)


def phase_bench_forms(flops, n_plain, n_gn, n_int8):
    """The port bench in bench.py's own form (the default: unfused convs,
    int8_static) with one full 1024-image dispatch and a traced one of
    BENCH_CHUNKS_TRACED replays, then each of BENCH_FORMS at
    BENCH_FORM_CHUNKS micro-batches; all on one randomized bf16 NCSN++.
    Each form: its JSON line (form, conv, quant, mods, img/s, busy), the
    launches of its build (an eager warm-up and a capture of one 64-image
    run) and of its traced replays, and one chunk graphed against eager
    (BENCH_GRAPH_TOL)."""
    import torch
    from naturaldiffusion_tpu_torch.apps import bench as B
    from naturaldiffusion_tpu_torch.models.ncsnpp import (
        CIFAR10_DDPMPP_CONTINUOUS, NCSNpp)

    t0 = time.perf_counter()
    net = randomize_(NCSNpp(CIFAR10_DDPMPP_CONTINUOUS, device="cpu"),
                     SEED + 6).to(device="cuda", dtype=torch.bfloat16).eval()
    out, default_launches, default_traced = {}, None, None
    forms = [BENCH_DEFAULT_FORM + (BENCH_TOTAL,)] + [
        f + (BENCH_FORM_CHUNKS * BATCH,) for f in BENCH_FORMS]
    for conv, quant, mods, total in forms:
        default = (conv, quant, mods) == BENCH_DEFAULT_FORM
        per_run = {"fused_weighted_sum": STEPS,
                   "conv3x3_int8": STEPS * n_int8 if quant else 0,
                   "conv3x3": STEPS * (n_plain + n_gn) if conv == "1" else 0,
                   "conv3x3_gn": 0, "conv3x3_tiled": 0}
        # the replays' device launches, as the wrappers counted the build
        want_traced = {k: BENCH_CHUNKS_TRACED * per_run[k] for k in (
            "fused_weighted_sum", "conv3x3", "conv3x3_gn", "conv3x3_int8")}
        rec, launches, traced, err, finite, laps = bench_form(
            B, net, flops, conv, quant, mods, total, want_traced)
        got = {k: launches[k] for k in per_run}
        want = {k: 2 * v for k, v in per_run.items()}     # warm-up, capture
        name = f"{rec['form']}_conv{conv}" + ("_mods" if mods else "")
        out[name] = dict(record=rec, launches=launches,
                         rel_l2_graph_vs_eager=err, seconds_by_part=laps)
        print(f"  bench {name}: {rec['value']} img/s ({total} images a "
              f"dispatch), graph vs eager {err:.3e}, launches {launches}"
              + (f", traced {traced}" if traced else ""), flush=True)
        if (got != want or not finite or err > BENCH_GRAPH_TOL
                or rec["conv"] != conv or rec["quant"] != quant
                or rec["mods"] != mods or rec["value"] <= 0):
            raise AssertionError(f"bench {name}: launches {got} != {want}, "
                                 f"graph vs eager {err:.3e}, line {rec}")
        if ({k: traced[k] for k in want_traced} != want_traced
                or (rec["mfu_vs_int8_peak"] is None) == bool(quant)):
            raise AssertionError(f"bench {name}: traced {traced} != "
                                 f"{want_traced}, {rec}")
        if default:
            default_launches, default_traced = launches, traced
            if rec["form"] != "unfused_int8_static":
                raise AssertionError(f"bench default form: {rec}")
    del net
    torch.cuda.empty_cache()
    phase("bench_forms", t0, forms={k: dict(
        img_per_s=v["record"]["value"], busy=v["record"]["busy"],
        rel_l2_graph_vs_eager=v["rel_l2_graph_vs_eager"],
        seconds_by_part=v["seconds_by_part"])
        for k, v in out.items()}, tol=BENCH_GRAPH_TOL)
    return default_launches, default_traced, out


def phase_conv_model():
    """``apps.bench_conv --model`` at the VE config, reduced: one forward a
    run, 2 runs a route."""
    from naturaldiffusion_tpu_torch.apps import bench_conv

    t0 = time.perf_counter()
    row = bench_conv.bench_model(VE_CONFIG, batch=2, reps=1, runs=2)
    print("  " + json.dumps(row), flush=True)
    bad = [k for k in row if k.endswith("_error")] + [
        label for label, _, _ in bench_conv.MODEL_MODES
        if not row.get(f"{label}_ms", 0) > 0]
    if bad:
        raise AssertionError(f"bench_conv --model: {bad}: {row}")
    phase("conv_model", t0, **row)
    return row


# ------------------------------------------------------------------ DiT path

def randomize_dit_(model, seed):
    """Every DiT weight random from ``seed``, made on the model's device:
    the JAX init zeroes every adaLN modulation and the final linear, so a
    forward at init outputs 0 and hides every fault.  Kernels
    N(0, 1/fan_in), biases 0.1 N(0, 1), the label table N(0, 0.02)."""
    import torch
    dev = next(model.parameters()).device
    g = torch.Generator(device=dev).manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("embedding"):
                p.normal_(0.0, 0.02, generator=g)
            elif name.endswith("bias"):
                p.normal_(0.0, 0.1, generator=g)
            else:
                p.normal_(0.0, 1.0 / math.sqrt(math.prod(p.shape[:-1])),
                          generator=g)
    return model


@contextlib.contextmanager
def plain_versions():
    """Within the block, the DiT path's kernels K1, K7 and K9 are replaced
    by their plain PyTorch versions (also for CUDA tensors)."""
    import importlib
    from naturaldiffusion_tpu_torch.ops import attention as A
    from naturaldiffusion_tpu_torch.ops import qmatmul as Q
    from naturaldiffusion_tpu_torch.ops import weighted_sum as WS
    ni = importlib.import_module("naturaldiffusion_tpu_torch.engine.ni")
    saved = (A.flash_attention, Q.matmul_wdq, ni.fused_weighted_sum)
    A.flash_attention = A.mha_reference
    Q.matmul_wdq = (lambda x, w_i8, s_w, bias=None, w_packed=None:
                    Q.matmul_wdq_reference(x, w_i8, s_w, bias))
    ni.fused_weighted_sum = WS.fused_weighted_sum_reference
    try:
        yield
    finally:
        A.flash_attention, Q.matmul_wdq, ni.fused_weighted_sum = saved


def dit_counters():
    from naturaldiffusion_tpu_torch.ops import attention as A
    from naturaldiffusion_tpu_torch.ops import qmatmul as Q
    from naturaldiffusion_tpu_torch.ops import weighted_sum as WS
    return {"fused_weighted_sum": WS.fused_weighted_sum,
            "flash_attention": A.flash_attention,
            "matmul_wdq": Q.matmul_wdq}


def read_counts(counters):
    return {k: f.launches for k, f in counters.items()}


def zero_counts(counters):
    for f in counters.values():
        f.launches = 0


def phase_dit_kernels(details):
    """K9 and K7 at the shapes of one DiT-XL/2 CFG forward (model batch 2:
    512 tokens), against their plain versions, then timed.  Per-forward
    numbers are sums over its launches: 28 of K9, 4 x 28 of K7."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel
    from naturaldiffusion_tpu_torch.models.dit import DIT_CONFIGS
    from naturaldiffusion_tpu_torch.ops import attention as A
    from naturaldiffusion_tpu_torch.ops import qmatmul as Q
    from naturaldiffusion_tpu_torch.ops.quant import quantize_weight

    t0 = time.perf_counter()
    cfg = DIT_CONFIGS[DIT_MODEL]
    d, h, depth = cfg.hidden_size, cfg.num_heads, cfg.depth
    dh = d // h
    tokens = (cfg.input_size // cfg.patch_size) ** 2
    timer = Timer(torch)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 11)

    def rn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    # K9: the model's strided views of one qkv tensor at t = 256, and
    # contiguous [B, H, T, D] at the unaligned t = 250, there also at the
    # head dim of 64 that MMDiT will use and at 32 and 16 (the small DiTs
    # of the apps)
    k9 = {}
    for t, hd, dtype, tol in ((tokens, dh, torch.float32, F32_TOL),
                              (tokens, dh, torch.bfloat16, BF16_TOL),
                              (250, dh, torch.float32, F32_TOL),
                              (250, dh, torch.bfloat16, BF16_TOL),
                              (250, 64, torch.float32, F32_TOL),
                              (250, 64, torch.bfloat16, BF16_TOL),
                              (250, 32, torch.float32, F32_TOL),
                              (250, 32, torch.bfloat16, BF16_TOL),
                              (250, 16, torch.float32, F32_TOL),
                              (250, 16, torch.bfloat16, BF16_TOL)):
        qkv = rn(2, t, 3, h, hd).to(dtype)
        q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
        if t != tokens:
            q, k, v = (a.contiguous() for a in (q, k, v))
        scale = 1.0 / math.sqrt(hd)
        got = A.flash_attention(q, k, v, scale)
        want = A.mha_reference(q, k, v, scale)
        key = f"t{t}_d{hd}_{str(dtype).split('.')[-1]}"
        k9[key] = check_close(f"K9 flash_attention {key}", got, want, tol)
        if t == tokens and dtype == torch.bfloat16:     # the path's call
            qc, kc, vc = (a.contiguous() for a in (q, k, v))

            def sdpa(qc=qc, kc=kc, vc=vc):
                with sdpa_kernel(SDPBackend.FLASH_ATTENTION):
                    return F.scaled_dot_product_attention(qc, kc, vc,
                                                          scale=scale)
            k9_time = dict(
                ms=timer(lambda: A.flash_attention(q, k, v, scale)),
                plain_ms=timer(lambda: A.mha_reference(q, k, v, scale)),
                library_ms=timer(sdpa))
            k9_host = host_us(torch, lambda: A.flash_attention(q, k, v,
                                                               scale))
    b2 = 2
    nbytes9 = 4 * b2 * h * tokens * dh * 2
    flops9 = 4.0 * b2 * h * tokens * tokens * dh
    k9_time["bound_ms"] = max(nbytes9 / HBM_BYTES_PER_S,
                              flops9 / PEAK_FLOPS["torch.bfloat16"]) * 1e3
    k9_bound_by = ("operations" if flops9 / PEAK_FLOPS["torch.bfloat16"]
                   >= nbytes9 / HBM_BYTES_PER_S else "bytes")

    # K7: the four QDense products of a block at M = 512, bf16 with bias;
    # one f32 activation call too (the w8 forward check runs in f32)
    m = b2 * tokens
    hidden = int(d * cfg.mlp_ratio)
    shapes = {"qkv": (d, 3 * d), "proj": (d, d), "fc1": (d, hidden),
              "fc2": (hidden, d)}
    k7 = {}
    k7_host = None
    for name, (kk, n) in shapes.items():
        w_i8, s_w = quantize_weight(rn(kk, n) / math.sqrt(kk))
        s_w = s_w.reshape(-1)
        b32 = (0.1 * rn(n)).to(torch.bfloat16).float()
        packed = Q.pack_weight(w_i8).contiguous()      # as QDense keeps it
        for dtype, tol in ((torch.bfloat16, BF16_TOL), (torch.float32,
                                                        F32_TOL)):
            if dtype == torch.float32 and name != "fc1":
                continue
            x = rn(m, kk).to(dtype)
            got = Q.matmul_wdq(x, w_i8, s_w, b32, packed)
            want = Q.matmul_wdq_reference(x, w_i8, s_w, b32)
            key = f"{name}_{str(dtype).split('.')[-1]}"
            k7[key] = dict(zip(("max_abs_err", "max_rel_err"), check_close(
                f"K7 matmul_wdq {key}", got, want, tol)))
            # the call that packs the weight itself gives the same bits
            if not torch.equal(Q.matmul_wdq(x, w_i8, s_w, b32), got):
                raise AssertionError(f"K7 {key}: packed per call differs")
        x = rn(m, kk).to(torch.bfloat16)
        w_dq = (w_i8.float() * s_w).to(torch.bfloat16)
        flops = 2.0 * m * kk * n
        nbytes = 2 * m * kk + kk * n + 4 * n + 4 * n + 2 * m * n
        plan = Q._qm_plan(m, kk, n)
        row = k7[f"{name}_bfloat16"]
        row.update(
            M=m, K=kk, N=n, blocks=math.prod(plan["grid"]),
            tile=[plan["bm"], plan["bn"]], splits=plan["splits"],
            ms=timer(lambda: Q.matmul_wdq(x, w_i8, s_w, b32, packed)),
            repack_ms=timer(lambda: Q.pack_weight(w_i8).contiguous()),
            plain_ms=timer(lambda: Q.matmul_wdq_reference(x, w_i8, s_w,
                                                          b32)),
            library_ms=timer(lambda: torch.matmul(x, w_dq)),
            bound_ms=max(flops / PEAK_FLOPS["torch.bfloat16"],
                         nbytes / HBM_BYTES_PER_S) * 1e3,
            bound_by=("operations" if flops / PEAK_FLOPS["torch.bfloat16"]
                      >= nbytes / HBM_BYTES_PER_S else "bytes"),
            flops=flops)
        row.update(tflops=flops / row["ms"] / 1e9,
                   bound_share=row["bound_ms"] / row["ms"],
                   vs_library=row["ms"] / row["library_ms"])
        # the plan's split count beside the others it could have taken
        plan_ints = Q._plan_ints(m, kk, n)
        row["ms_by_splits"] = {
            s: timer(lambda s=s: Q._launch(x, packed, s_w, b32, x.dtype,
                                           plan_ints[:4] + (s,)
                                           + plan_ints[5:]))
            for s in K7_SPLITS_TIMED}
        if name == "fc1":
            k7_host = host_us(torch, lambda: Q.matmul_wdq(x, w_i8, s_w, b32,
                                                          packed))
    # shapes of no model: ragged M, the narrowest N and the deepest K
    for mm, kk, n in K7_EDGE_SHAPES:
        w_i8, s_w = quantize_weight(rn(kk, n) / math.sqrt(kk))
        s_w = s_w.reshape(-1)
        b32 = 0.1 * rn(n)
        for dtype, tol in ((torch.bfloat16, BF16_TOL), (torch.float32,
                                                        F32_TOL)):
            x = rn(mm, kk).to(dtype)
            key = f"M{mm}_K{kk}_N{n}_{str(dtype).split('.')[-1]}"
            k7[key] = dict(zip(("max_abs_err", "max_rel_err"), check_close(
                f"K7 matmul_wdq {key}", Q.matmul_wdq(x, w_i8, s_w, b32),
                Q.matmul_wdq_reference(x, w_i8, s_w, b32), tol)),
                splits=Q._qm_plan(mm, kk, n)["splits"])
        check_close(f"K7 matmul_wdq {key} without bias",
                    Q.matmul_wdq(x, w_i8, s_w),
                    Q.matmul_wdq_reference(x, w_i8, s_w), F32_TOL)
    timed7 = [r for r in k7.values() if "ms" in r]
    k7_tot = {f: depth * sum(r[f] for r in timed7)
              for f in ("ms", "repack_ms", "plain_ms", "library_ms",
                        "bound_ms", "flops")}
    details["dit_flash_attention"] = dict(
        checks=k9, per_launch=k9_time, bytes=nbytes9, flops=flops9,
        host_us=k9_host)
    details["dit_qmatmul"] = dict(shapes=k7, per_forward=k7_tot,
                                  host_us=k7_host)
    out = [
        dict(name="flash_attention", route="cuda",
             source="naturaldiffusion_tpu_torch/csrc/attention.cu",
             replaces="naturaldiffusion_tpu/ops/attention.py:32",
             max_abs_err=max(e[0] for e in k9.values()),
             max_rel_err=max(e[1] for e in k9.values()),
             **{f: depth * k9_time[f] for f in ("ms", "plain_ms",
                                                "library_ms", "bound_ms")},
             bound_by=k9_bound_by,
             head_dims_checked=sorted({int(k.split("_d")[1].split("_")[0])
                                       for k in k9})),
        dict(name="qmatmul", route="cuda",
             source="naturaldiffusion_tpu_torch/csrc/qmatmul.cu",
             replaces="naturaldiffusion_tpu/ops/qmatmul.py:48",
             max_abs_err=max(r["max_abs_err"] for r in k7.values()),
             max_rel_err=max(r["max_rel_err"] for r in k7.values()),
             **{f: k7_tot[f] for f in ("ms", "plain_ms", "library_ms",
                                       "bound_ms")},
             bound_by="operations"),
    ]
    for r in timed7:
        print(f"  qmatmul M={r['M']} K={r['K']} N={r['N']} "
              f"({r['blocks']} blocks of {r['tile'][0]}x{r['tile'][1]}, "
              f"{r['splits']} splits; by splits "
              f"{ {s: round(v, 4) for s, v in r['ms_by_splits'].items()} }): "
              f"{r['ms']:.4f} ms "
              f"({r['tflops']:.1f} TFLOP/s, {100 * r['bound_share']:.1f}% of "
              f"bound, {r['vs_library']:.2f}x cuBLAS), per-call repack "
              f"{r['repack_ms']:.4f}, plain {r['plain_ms']:.4f}, cuBLAS "
              f"{r['library_ms']:.4f}, bound {r['bound_ms']:.4f} "
              f"({r['bound_by']})", flush=True)
    print(f"  flash_attention [2, {h}, {tokens}, {dh}] bf16 per launch: "
          f"{1e3 * k9_time['ms']:.2f} us, SDPA flash "
          f"{1e3 * k9_time['library_ms']:.2f} us, plain "
          f"{1e3 * k9_time['plain_ms']:.2f} us, bound "
          f"{1e3 * k9_time['bound_ms']:.3f} us ({k9_bound_by})", flush=True)
    phase("dit_kernels", t0,
          checks={"flash_attention": len(k9), "qmatmul": len(k7)},
          tolerances=dict(f32=F32_TOL, bf16=BF16_TOL),
          flash_attention_per_launch={f: round(v, 5)
                                      for f, v in k9_time.items()},
          flash_attention_tflops=flops9 / k9_time["ms"] / 1e9,
          qmatmul_tflops=k7_tot["flops"] / k7_tot["ms"] / 1e9,
          qmatmul_repack_ms_per_forward=k7_tot["repack_ms"],
          host_us_per_launch={"flash_attention": round(k9_host, 2),
                              "qmatmul": round(k7_host, 2)},
          kernels={k["name"]: dict(
              {f: round(k[f], 4) for f in ("ms", "plain_ms", "library_ms",
                                          "bound_ms")},
              max_abs_err=k["max_abs_err"], max_rel_err=k["max_rel_err"])
              for k in out},
          note="ms: sum over one DiT-XL/2 CFG forward's launches, bf16")
    return out


def profile_dit_forward(torch, model, z0, y):
    """Device time of one bf16 CFG forward (modulations hoisted) by kernel
    name, from ``torch.profiler`` (``device_profile``): the sum over the
    kernels that ran, the wall time around the profiled call, and the 8
    largest kernels.  A profiler that records no device time gives
    ``device_ms = None``."""
    from naturaldiffusion_tpu_torch.models.dit import (dit_schedule_mods,
                                                       forward_with_cfg)
    cfg = model.config
    t = torch.full((z0.shape[0],), 999.0, device="cuda")
    with torch.no_grad():
        mods = dit_schedule_mods(model, t[:1], y)
        mods = {"blocks": tuple(m[0] for m in mods["blocks"]),
                "final": mods["final"][0]}

        def fwd():
            return forward_with_cfg(
                lambda xx, tt, yy: model(xx, tt, yy, mods=mods), z0, t, y,
                DIT_CFG_SCALE, cfg.in_channels)
        fwd()
        torch.cuda.synchronize()
    wall_ms, kern = device_profile(torch, fwd)
    dev_ms = sum(ms for _, ms in kern.values())
    return dict(
        device_ms=dev_ms or None, wall_ms_profiled=wall_ms,
        kernel_launches=sum(n for n, _ in kern.values()),
        top=top_kernels(kern))


def dit_inputs(torch, cfg, gen, device):
    """One image as the CFG pair: both halves the same latents, labels
    ``[class, null]``."""
    half = torch.randn((1, cfg.input_size, cfg.input_size, cfg.in_channels),
                       generator=gen, device=device)
    y = torch.tensor([207, cfg.num_classes], device=device)
    return torch.cat([half, half]), y


def dit_forward_input(torch, cfg):
    gen = torch.Generator().manual_seed(SEED + 12)
    x, y = dit_inputs(torch, cfg, gen, "cpu")
    x[1] = torch.randn(x[1].shape, generator=gen)   # the wrapper drops it
    return x, torch.tensor([999.0, 999.0]), y


def phase_dit_forward(model32, oracles):
    """The full-width DiT-XL/2 CFG forward in f32, plain and under w8, the
    card against the oracle process's CPU forwards (of the same weights,
    made from the same seed on the card)."""
    import torch
    from naturaldiffusion_tpu_torch.models.dit import forward_with_cfg

    t0 = time.perf_counter()
    cfg = model32.config
    x, t, y = dit_forward_input(torch, cfg)
    counters = dit_counters()
    res, wants, got_all = {}, {}, {}
    for quant in (None, "w8"):
        model32.set_quant(quant)
        zero_counts(counters)
        with torch.no_grad():
            got_all[quant] = forward_with_cfg(
                model32, x.cuda(), t.cuda(), y.cuda(), DIT_CFG_SCALE,
                cfg.in_channels)
            torch.cuda.synchronize()
            res[quant or "float"] = dict(launches=read_counts(counters))
    cpu_out, _, wait_s = oracles.get("dit")
    for quant in (None, "w8"):
        got, (want, cpu_s) = got_all[quant], cpu_out[quant]
        counts = res[quant or "float"]["launches"]
        expect = {"fused_weighted_sum": 0, "flash_attention": cfg.depth,
                  "matmul_wdq": 4 * cfg.depth if quant else 0}
        err = rel_l2(got, want)
        wants[quant] = want
        res[quant or "float"] = dict(rel_l2=err, launches=counts,
                                     cpu_seconds=cpu_s)
        res["oracle_wait_s"] = wait_s
        tol = DIT_W8_FORWARD_TOL if quant else DIT_FORWARD_TOL
        if counts != expect:
            raise AssertionError(f"dit_forward {quant}: launches {counts} "
                                 f"!= {expect}")
        if not (torch.isfinite(got).all() and err <= tol
                and tuple(got.shape) == (2, 32, 32, cfg.out_channels)):
            raise AssertionError(f"dit_forward {quant}: rel L2 {err:.3e} > "
                                 f"{tol:g} or non-finite or misshapen")
    model32.set_quant(None)
    phase("dit_forward", t0, model=DIT_MODEL, results=res,
          control_w8_vs_float_on_cpu_rel_l2=rel_l2(wants["w8"], wants[None]),
          tol=DIT_FORWARD_TOL, tol_w8=DIT_W8_FORWARD_TOL,
          params=sum(p.numel() for p in model32.parameters()),
          out_abs_max=float(want.abs().max()))


def phase_dit_slice(model32, smi):
    """The DiT path through ``apps.bench_dit.make_sampler``: 50-step DDIM
    NI at one image in bf16, modulations hoisted, in both modes; then the
    10-step accuracy check with its two controls."""
    import torch
    from naturaldiffusion_tpu_torch.apps import bench_dit
    from naturaldiffusion_tpu_torch.coeffs import registry

    t0 = time.perf_counter()
    cfg = model32.config
    model = copy.deepcopy(model32).to(torch.bfloat16)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 13)
    z, y = dit_inputs(torch, cfg, gen, "cuda")
    z0 = z.to(torch.bfloat16)
    counters = dit_counters()
    runs = {}
    for quant in (None, "w8"):
        model.set_quant(quant)
        run = bench_dit.make_sampler(model, registry.derive("ddim", DIT_STEPS),
                                     cfg_scale=DIT_CFG_SCALE)
        run(z0, y)                            # warm-up: quantization
        torch.cuda.synchronize()
        zero_counts(counters)
        walls = []
        for i in range(DIT_TIMED_RUNS):
            tr = time.perf_counter()
            out = run(z0, y)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - tr)
            if i == 0:                       # the counted run
                counts = read_counts(counters)
        expect = {"fused_weighted_sum": DIT_STEPS,
                  "flash_attention": DIT_STEPS * cfg.depth,
                  "matmul_wdq": 4 * DIT_STEPS * cfg.depth if quant else 0}
        if counts != expect:
            raise AssertionError(f"dit_slice {quant}: launches {counts} != "
                                 f"{expect}")
        if not (torch.isfinite(out).all() and out.shape == z0.shape):
            raise AssertionError(f"dit_slice {quant}: non-finite or "
                                 f"misshapen latents")
        if not torch.equal(out[0], out[1]):
            raise AssertionError(f"dit_slice {quant}: the CFG halves differ")
        wall = statistics.median(walls)
        prof = profile_dit_forward(torch, model, z0, y)
        if prof["device_ms"] is not None:
            prof["busy_share"] = prof["device_ms"] / (wall / DIT_STEPS * 1e3)
        runs[quant or "float"] = dict(profile=prof,
            img_per_min=60.0 / wall, sec_per_image=wall,
            transformer_fwd_ms=wall / DIT_STEPS * 1e3, walls_s=walls,
            launches=counts, mfu=bench_dit.flops_per_forward(cfg, 1, True)
            * DIT_STEPS / (wall * PEAK_FLOPS["torch.bfloat16"]))

    # accuracy: 10 steps in bf16 through the kernels against the same run
    # in f32 through the plain versions on the card (TF32 off)
    acc_matrix = registry.derive("ddim", DIT_ACC_STEPS)
    model.set_quant(None)
    with plain_versions():
        want = bench_dit.make_sampler(model32, acc_matrix,
                                      cfg_scale=DIT_CFG_SCALE)(z, y)
        ctl_plain = rel_l2(bench_dit.make_sampler(
            model, acc_matrix, cfg_scale=DIT_CFG_SCALE)(z0, y), want)
    err = rel_l2(bench_dit.make_sampler(model, acc_matrix,
                                        cfg_scale=DIT_CFG_SCALE)(z0, y), want)
    saved = bench_dit.dit_schedule_mods
    bench_dit.dit_schedule_mods = lambda m, t_all, yy: saved(m, t_all * 1.01,
                                                             yy)
    try:
        ctl_fault = rel_l2(bench_dit.make_sampler(
            model, acc_matrix, cfg_scale=DIT_CFG_SCALE)(z0, y), want)
    finally:
        bench_dit.dit_schedule_mods = saved
    model.set_quant("w8")
    err_w8 = rel_l2(bench_dit.make_sampler(
        model, acc_matrix, cfg_scale=DIT_CFG_SCALE)(z0, y), want)
    if err > DIT_SLICE_TOL:
        raise AssertionError(f"dit_slice: {DIT_ACC_STEPS}-step bf16 rel L2 "
                             f"{err:.3e} > {DIT_SLICE_TOL:g}")
    phase("dit_slice", t0, model=DIT_MODEL, steps=DIT_STEPS, batch=1,
          cfg_scale=DIT_CFG_SCALE, card=smi, runs=runs,
          flops_per_fwd=bench_dit.flops_per_forward(cfg, 1, True),
          acc_steps=DIT_ACC_STEPS, rel_l2_bf16_vs_plain_f32=err,
          tol=DIT_SLICE_TOL, control_plain_bf16_rel_l2=ctl_plain,
          control_time_1pct_off_rel_l2=ctl_fault,
          reading_w8_bf16_rel_l2=err_w8,
          latent_abs_max=float(want.abs().max()))
    return runs

# the parallel phase (PR 20).  (1) K9's and K10's backward kernel
# (csrc/attention_bwd.cu) against attention_backward_reference on the same
# inputs, dq, dk and dv each by relative L2: f32 at BWD_F32_TOL (f32 sums
# in other orders, ~1e-6); bf16 at BWD_BF16_TOL beside the control of a
# plain version that rounds p and dS to bf16 where the kernel does (sound
# runs of the kernel read 2.4e-3, PR 20); a copy of the reference 1 % off
# must fail the f32 limit and one 5 % off the bf16 limit.  The shapes:
# DiT-XL/2's train step [32, 16, 256, 72] as the model's strided views,
# SD3-medium's joint length and the kernel table's, each head dim at a
# ragged T (201).  Timed (CUDA events, L2 flushed) in bf16 beside the
# plain version, SDPA's flash backward (the library call) and its bound;
# forward + backward beside SDPA's; the bf16 backward run twice on the same
# inputs, the largest |difference| of dq, dk and dv printed (the wgmma
# pass sums dq by f32 bulk reductions in no fixed order).
BWD_F32_TOL, BWD_BF16_TOL = 1e-4, 2e-2
BWD_SHAPES = ((32, 16, 256, 72), (SD3_B, SD3_H, SD3_LAT + 333, SD3_D),
              (SD3_B, SD3_H, SD3_LAT + SD3_CTX, SD3_D),
              (2, 3, 201, 16), (2, 3, 201, 32), (2, 3, 201, 64),
              (2, 3, 201, 72))
BWD_TIMED = BWD_SHAPES[:3]
# (2) the DiT-XL/2 train step at full width and depth (hidden 1152, depth
# 28, 16 heads of 72, patch 2, 32 x 32 x 4 latents; learn_sigma False and
# no label dropout, the dry run's config) on make_mesh's 1-rank NCCL mesh
# under dit_tp_sharding and the (data, model, -) token constraint, bf16
# mixed precision at the DiT release's per-GPU batch (256 over 8 GPUs):
# PAR_STEPS steps, each loss finite, K9 and its backward PAR_DEPTH calls a
# step each.  One f32 step's whole-model gradient at PAR_CHECK_BATCH
# against the same step through attention's plain version (autograd of
# mha_reference), relative L2 at PAR_GRAD_TOL (f32 sums in other orders
# through 28 blocks), beside a control whose backward drops dq; the same
# with attn_backend="splash" (K10 and its backward)
PAR_BATCH, PAR_STEPS, PAR_CHECK_BATCH, PAR_DEPTH = 32, 3, 4, 28
PAR_GRAD_TOL = 1e-4


def bwd_plain_bf16(torch, q, k, v, o, do, lse, scale):
    """The plain backward with p and dS rounded to bf16 where the kernel
    rounds them (the bf16 rows' control)."""
    f32, bf = torch.float32, torch.bfloat16
    qf, kf, vf, of, dof = (a.to(f32) for a in (q, k, v, o, do))
    p = torch.exp(torch.matmul(qf, kf.transpose(-1, -2)) * scale
                  - lse[..., None])
    dv = torch.matmul(p.to(bf).to(f32).transpose(-1, -2), dof)
    ds = p * (torch.matmul(dof, vf.transpose(-1, -2))
              - (dof * of).sum(-1, keepdim=True))
    ds = ds.to(bf).to(f32)
    return (torch.matmul(ds, kf) * scale,
            torch.matmul(ds.transpose(-1, -2), qf) * scale, dv)


def rel_l2_dev(a, b):
    """``rel_l2`` on the card, in float64 (the gradients at SD3's length
    are 14 M elements each: host copies would cost seconds)."""
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm())


def bwd_cost(b, h, t, d, itemsize):
    """FLOPs (5 products of 2 B H T^2 D), bytes (q, k, v, o, do read, dq,
    dk, dv written, lse read), the bound in ms and what bounds it."""
    flops = 5 * 2.0 * b * h * t * t * d
    nbytes = 8.0 * b * h * t * d * itemsize + 4.0 * b * h * t
    tf, tb = flops / PEAK_FLOPS["torch.bfloat16"], nbytes / HBM_BYTES_PER_S
    return flops, nbytes, max(tf, tb) * 1e3, ("operations" if tf >= tb
                                              else "bytes")


def bwd_inputs(torch, shape, dtype, gen):
    """q, k, v as the DiT's strided views of one [B, T, 3, H, D] tensor, do
    a [B, H, T, D] view of [B, T, H, D] (what the model's backward hands
    the kernel)."""
    b, h, t, d = shape
    qkv = torch.randn((b, t, 3, h, d), generator=gen, device="cuda").to(dtype)
    q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
    do = torch.randn((b, t, h, d), generator=gen, device="cuda").to(
        dtype).transpose(1, 2)
    return q, k, v, do


def bwd_rows(torch, A, timer, gen):
    """(1): every shape and type of BWD_SHAPES; returns (rows, timings)."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel
    rows, timed = [], {}
    for shape in BWD_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v, do = bwd_inputs(torch, shape, dtype, gen)
            scale = 1.0 / math.sqrt(shape[-1])
            o, lse = A._launch(q, k, v, scale, True, "flash_attention")
            got = A.flash_attention_backward(q, k, v, o, do, lse, scale)
            want = A.attention_backward_reference(
                *(a.float() for a in (q, k, v, o, do)), lse, scale)
            errs = [rel_l2_dev(g, w) for g, w in zip(got, want)]
            f32 = dtype == torch.float32
            tol = BWD_F32_TOL if f32 else BWD_BF16_TOL
            off = 1.01 if f32 else 1.05
            control = max(rel_l2_dev(w * off, w) for w in want)
            abs_err = max(float((g.float() - w).abs().max())
                          for g, w in zip(got, want))
            plain16 = (None if f32 else max(rel_l2_dev(p, w) for p, w in zip(
                bwd_plain_bf16(torch, q, k, v, o, do, lse, scale), want)))
            del got, want
            if max(errs) > tol or control <= tol:
                raise AssertionError(f"K9 backward {shape} {dtype}: rel L2 "
                                     f"{errs} (limit {tol:g}), control "
                                     f"{control:.2e}")
            row = dict(shape=list(shape), dtype=str(dtype),
                       rel_l2_dq_dk_dv=errs, tol=tol,
                       control_off_rel_l2=control,
                       plain_bf16_control_rel_l2=plain16,
                       max_abs_err=abs_err)
            # K10's backward: the same kernel at scale 1 on pre-scaled q
            if shape[2] == SD3_LAT + 333:
                qs = A.prescale(q, scale)
                o10, lse10 = A._launch(qs, k, v, None, True, "splash")
                got10 = A.splash_attention_backward(qs, k, v, o10, do, lse10)
                want10 = A.attention_backward_reference(
                    *(a.float() for a in (qs, k, v, o10, do)), lse10, 1.0)
                e10 = [rel_l2_dev(g, w) for g, w in zip(got10, want10)]
                if max(e10) > tol:
                    raise AssertionError(f"K10 backward {shape} {dtype}: "
                                         f"{e10} over {tol:g}")
                row["splash_rel_l2_dq_dk_dv"] = e10
                row["splash_max_abs_err"] = max(
                    float((g.float() - w).abs().max())
                    for g, w in zip(got10, want10))
                del got10, want10
            rows.append(row)
            if shape in BWD_TIMED and not f32:
                flops, nbytes, bound, by = bwd_cost(*shape, 2)
                qg, kg, vg = (a.detach().requires_grad_() for a in (q, k, v))
                with sdpa_kernel(SDPBackend.FLASH_ATTENTION), \
                        torch.enable_grad():
                    so = F.scaled_dot_product_attention(qg, kg, vg)
                    lib_ms = timer(lambda: torch.autograd.grad(
                        so, (qg, kg, vg), do, retain_graph=True))

                    def sdpa_fb():
                        out = F.scaled_dot_product_attention(qg, kg, vg)
                        torch.autograd.grad(out, (qg, kg, vg), do)

                    def k9_fb():
                        out = A.flash_attention(qg, kg, vg, scale)
                        torch.autograd.grad(out, (qg, kg, vg), do)
                    lib_fb = timer(sdpa_fb)
                    k9_fb_ms = timer(k9_fb)
                # run to run: dq is summed by f32 bulk reductions in no
                # fixed order of the key blocks; dk and dv have one writer
                again = [A.flash_attention_backward(q, k, v, o, do, lse,
                                                    scale) for _ in range(2)]
                r2r = [float((x.float() - y.float()).abs().max())
                       for x, y in zip(*again)]
                del again
                timed[str(list(shape))] = dict(
                    run_to_run_max_abs_dq_dk_dv=r2r,
                    ms=timer(lambda: A.flash_attention_backward(
                        q, k, v, o, do, lse, scale)),
                    splash_ms=(timer(lambda: A.splash_attention_backward(
                        qs, k, v, o10, do, lse10))
                        if shape[2] == SD3_LAT + 333 else None),
                    plain_ms=timer(lambda: A.attention_backward_reference(
                        q, k, v, o, do, lse, scale)),
                    library_ms=lib_ms, bound_ms=bound, bound_by=by,
                    flops=flops, bytes=nbytes,
                    fwd_bwd_ms=k9_fb_ms, library_fwd_bwd_ms=lib_fb)
                del so, qg, kg, vg
            del q, k, v, do, o, lse
        torch.cuda.empty_cache()
    return rows, timed


def par_model(torch, cfg_kw, mesh, tok):
    """The full-width DiT-XL/2 of (2), every weight random, its parameters
    placed by dit_tp_sharding."""
    from naturaldiffusion_tpu_torch.models.dit import DiT, DiTConfig
    from naturaldiffusion_tpu_torch.parallel import dit_tp_sharding
    from naturaldiffusion_tpu_torch.parallel.shardings import apply_shardings
    model = randomize_dit_(DiT(DiTConfig(**cfg_kw), device="cuda",
                               token_constraint=tok), SEED + 70)
    return apply_shardings(model, dit_tp_sharding(model, mesh))


def par_apply(torch, model):
    def apply_fn(p, x, t_label):
        y = torch.arange(x.shape[0], device=x.device) % 1000
        return torch.func.functional_call(model, p, (x, t_label, y))
    return apply_fn


def par_grads(torch, model, batch, t, z):
    """The whole-model gradient of the DSM loss at the draws, as plain
    tensors (the 1-rank mesh's local shards are whole)."""
    from naturaldiffusion_tpu_torch.parallel.shardings import full
    from naturaldiffusion_tpu_torch.sde import VPSDE
    from naturaldiffusion_tpu_torch.train.losses import sde_loss_given
    from naturaldiffusion_tpu_torch.parallel.mesh import implicit_replication
    params = dict(model.named_parameters())
    with torch.enable_grad(), implicit_replication():
        loss = full(sde_loss_given(VPSDE(), par_apply(torch, model), params,
                                   batch, t, z))
        grads = torch.autograd.grad(loss, list(params.values()))
    return [full(g).detach() for g in grads]


@contextlib.contextmanager
def dq_dropped(A, name):
    """The backward ``name`` of ``ops.attention`` with its dq zeroed (the
    gradient checks' control)."""
    saved = getattr(A, name)

    def dropped(*args):
        dq, dk, dv = saved(*args)
        return dq * 0, dk, dv
    dropped.launches = 0            # the wrapper counts on the module's name
    setattr(A, name, dropped)
    try:
        yield
    finally:
        setattr(A, name, saved)


def par_check_draws(torch, model):
    """(2)'s gradient check's batch and draws, batch-sharded."""
    from naturaldiffusion_tpu_torch.parallel import shard_batch
    gen = torch.Generator(device="cuda").manual_seed(SEED + 71)
    b = PAR_CHECK_BATCH
    batch = torch.randn((b, 32, 32, 4), generator=gen, device="cuda")
    t = torch.rand(b, generator=gen, device="cuda") * 0.9 + 0.05
    z = torch.randn((b, 32, 32, 4), generator=gen, device="cuda")
    return shard_batch(model.token_constraint.mesh, (batch, t, z))


def par_plain_grads(torch, A, model, draws):
    """The gradient through attention's plain version (autograd of
    ``mha_reference``), both backends' reference."""
    saved = A.flash_attention, A.splash_attention
    A.flash_attention = A.splash_attention = A.mha_reference
    try:
        return par_grads(torch, model, *draws)
    finally:
        A.flash_attention, A.splash_attention = saved


def par_grad_check(torch, A, model, backend, draws, want):
    """(2)'s gradient check under ``backend`` (K9 "flash" or K10 "splash"):
    the kernels' gradient against the plain attention's ``want``, and the
    control without dq."""
    for blk in model.blocks:
        blk.attn.attn_backend = backend
    try:
        got = par_grads(torch, model, *draws)
        bwd = ("splash_attention_backward" if backend == "splash"
               else "flash_attention_backward")
        with dq_dropped(A, bwd):
            control = par_grads(torch, model, *draws)
    finally:
        for blk in model.blocks:
            blk.attn.attn_backend = "auto"
    err, ctl = rel_l2_all(got, want), rel_l2_all(control, want)
    if not err <= PAR_GRAD_TOL < ctl:
        raise AssertionError(f"DiT-XL/2 {backend} gradient rel L2 {err:.2e} "
                             f"(limit {PAR_GRAD_TOL:g}), control without dq "
                             f"{ctl:.2e}")
    return dict(rel_l2=err, control_no_dq_rel_l2=ctl, tol=PAR_GRAD_TOL)


def par_train_steps(torch, A, model, smi):
    """(2)'s bf16 steps: returns (numbers, launches of the main path)."""
    from naturaldiffusion_tpu_torch.parallel import shard_batch
    from naturaldiffusion_tpu_torch.sde import VPSDE
    from naturaldiffusion_tpu_torch.train import make_train_step
    mesh = model.token_constraint.mesh
    init_fn, step_fn = make_train_step(VPSDE(), par_apply(torch, model),
                                       compute_dtype=torch.bfloat16)
    state = init_fn(dict(model.named_parameters()))
    gen = torch.Generator(device="cuda").manual_seed(SEED + 72)
    batch = shard_batch(mesh, torch.randn((PAR_BATCH, 32, 32, 4),
                                          generator=gen, device="cuda"))
    counters = {"flash_attention": A.flash_attention,
                "flash_attention_backward": A.flash_attention_backward}
    torch.cuda.reset_peak_memory_stats()
    zero_counts(counters)
    losses, ms, out = [], [], [None]

    def step(i):
        st, loss = step_fn(out[0] or state, torch.Generator(
            device="cuda").manual_seed(SEED + 80 + i), batch)
        out[0] = st
        losses.append(float(loss))
    for i in range(PAR_STEPS - 1):
        torch.cuda.synchronize()
        tw = time.perf_counter()
        step(i)
        ms.append((time.perf_counter() - tw) * 1e3)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    # the last step under the profiler (its wall is the profiler's)
    prof = profiled(torch, lambda: step(PAR_STEPS - 1))
    launches = read_counts(counters)
    want = {k: PAR_STEPS * PAR_DEPTH for k in counters}
    if launches != want or not all(map(math.isfinite, losses)):
        raise AssertionError(f"DiT-XL/2 train steps: losses {losses}, "
                             f"launches {launches} != {want}")
    del state, out
    return dict(losses=losses, step_ms=ms, steady_step_ms=ms[-1],
                img_per_s=PAR_BATCH / ms[-1] * 1e3,
                profiled_step_wall_ms=prof["wall_ms"],
                peak_memory_gib=peak, busy_share=prof["busy_share"],
                device_ms=prof["device_ms"], top=prof["top"],
                calls_per_step={k: v // PAR_STEPS
                                for k, v in launches.items()},
                card=smi), launches


def ring_grad_check(torch, A, mesh):
    """Ring attention's gradient on the card's 1-rank mesh (the ring is one
    local block) at RING_SHAPE, f32, against autograd through the plain
    attention, with sm_scale 1 % off as the control."""
    from naturaldiffusion_tpu_torch.ops.ring_attention import ring_mha
    gen = torch.Generator(device="cuda").manual_seed(SEED + 85)
    q, k, v, cot = (torch.randn(RING_SHAPE, generator=gen, device="cuda")
                    for _ in range(4))
    scale = 1.0 / math.sqrt(RING_SHAPE[-1])

    def grads(fn):
        leaves = [a.clone().requires_grad_() for a in (q, k, v)]
        out = fn(*leaves)
        return out, torch.autograd.grad((out * cot).sum(), leaves)
    out, got = grads(lambda a, b, c: ring_mha(a, b, c, mesh, sm_scale=scale))
    ref, want = grads(lambda a, b, c: A.mha_reference(a, b, c, scale))
    _, ctl = grads(lambda a, b, c: ring_mha(a, b, c, mesh,
                                            sm_scale=scale * 1.01))
    res = dict(shape=list(RING_SHAPE), out_rel_l2=rel_l2(out, ref),
               grad_rel_l2=rel_l2_all(got, want), tol=PAR_GRAD_TOL,
               control_scale_1pct_off_rel_l2=rel_l2_all(ctl, want))
    print(f"  ring attention gradient: {json.dumps(res)}", flush=True)
    if not (res["out_rel_l2"] <= PAR_GRAD_TOL
            and res["grad_rel_l2"] <= PAR_GRAD_TOL
            < res["control_scale_1pct_off_rel_l2"]):
        raise AssertionError(f"ring attention gradient: {res}")
    return res


def phase_parallel(smi, details):
    """The parallelism slice (see the constants): (1) the backward kernel's
    rows, (2) the DiT-XL/2 train step on the mesh (its launches are the
    phase's main path), its gradient checks, (3) ``dryrun_multichip(1)``
    on the card, (4) ring attention's gradient.  Returns (kernel rows,
    launches by path)."""
    import torch
    from naturaldiffusion_tpu_torch.ops import attention as A
    from naturaldiffusion_tpu_torch.parallel import make_mesh, named
    from naturaldiffusion_tpu_torch.parallel.dryrun import dryrun_multichip
    t0 = time.perf_counter()
    parts = {}
    gen = torch.Generator(device="cuda").manual_seed(SEED + 60)
    timer = Timer(torch, reps=5)
    rows, timed = bwd_rows(torch, A, timer, gen)
    del timer
    torch.cuda.empty_cache()
    parts["backward_rows"] = time.perf_counter() - t0
    tp = time.perf_counter()
    mesh = make_mesh({"data": 1, "model": 1}, device="cuda")
    cfg_kw = dict(input_size=32, patch_size=2, in_channels=4,
                  hidden_size=1152, depth=PAR_DEPTH, num_heads=16,
                  learn_sigma=False, class_dropout_prob=0.0)
    model = par_model(torch, cfg_kw, mesh, named(mesh, "data", "model",
                                                 None))
    with torch.enable_grad():
        step, launches = par_train_steps(torch, A, model, smi)
    parts["train_steps"] = time.perf_counter() - tp
    tp = time.perf_counter()
    with torch.enable_grad():
        counters = {"splash_attention": A.splash_attention,
                    "splash_attention_backward": A.splash_attention_backward}
        draws = par_check_draws(torch, model)
        want = par_plain_grads(torch, A, model, draws)
        grad_k9 = par_grad_check(torch, A, model, "flash", draws, want)
        zero_counts(counters)
        grad_k10 = par_grad_check(torch, A, model, "splash", draws, want)
        del want
    splash_launches = read_counts(counters)
    del model
    torch.cuda.empty_cache()
    parts["gradient_checks"] = time.perf_counter() - tp
    tp = time.perf_counter()
    with torch.enable_grad():
        dry = dryrun_multichip(1, device="cuda")
    parts["dryrun_multichip"] = time.perf_counter() - tp
    tp = time.perf_counter()
    with torch.enable_grad():
        ring = ring_grad_check(torch, A, mesh)
    parts["ring_gradient"] = time.perf_counter() - tp
    worst = {d: max(max(r["rel_l2_dq_dk_dv"]) for r in rows
                    if r["dtype"] == d) for d in ("torch.float32",
                                                  "torch.bfloat16")}
    for key, row in timed.items():
        print(f"  K9 backward {key} bf16 run to run, max |a - b| of dq, dk, "
              f"dv: {row['run_to_run_max_abs_dq_dk_dv']}", flush=True)
    phase("parallel", t0, card=smi, backward_rows=len(rows),
          backward_worst_rel_l2=worst, backward_timed=timed,
          dit_xl2_train=step, grad_check_k9=grad_k9,
          grad_check_k10=grad_k10, splash_launches=splash_launches,
          dryrun=dry, ring_gradient=ring, seconds_by_part=parts)
    details["parallel"] = dict(backward_rows=rows, timed=timed)
    main = timed[str(list(BWD_TIMED[0]))]
    sd3 = timed[str(list(BWD_TIMED[1]))]
    err9 = max(r["max_abs_err"] for r in rows)
    err10 = max(r["splash_max_abs_err"] for r in rows
                if "splash_max_abs_err" in r)
    kern = [dict(name="flash_attention_backward", route="cuda",
                 source="naturaldiffusion_tpu_torch/csrc/attention_bwd.cu",
                 replaces="jax/experimental/pallas/ops/tpu/flash_attention.py"
                          ":254",
                 max_abs_err=err9, ms=main["ms"], plain_ms=main["plain_ms"],
                 bound_ms=main["bound_ms"], bound_by=main["bound_by"],
                 library_ms=main["library_ms"],
                 sd3_length={f: sd3[f] for f in (
                     "ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
                     "fwd_bwd_ms", "library_fwd_bwd_ms")},
                 fwd_bwd_ms=main["fwd_bwd_ms"],
                 library_fwd_bwd_ms=main["library_fwd_bwd_ms"],
                 run_to_run_max_abs_dq_dk_dv={
                     k: timed[k]["run_to_run_max_abs_dq_dk_dv"]
                     for k in timed},
                 note="shape [32, 16, 256, 72] bf16, the DiT-XL/2 train "
                      "step's; launches count calls (each is three device "
                      "launches: in bf16 at d 64 and 72 the pre-pass, the "
                      "wgmma pass and the dq post-pass)"),
            dict(name="splash_attention_backward", route="cuda",
                 source="naturaldiffusion_tpu_torch/csrc/attention_bwd.cu",
                 replaces="jax/experimental/pallas/ops/tpu/splash_attention/"
                          "splash_attention_kernel.py:2241",
                 max_abs_err=err10, ms=sd3["splash_ms"],
                 plain_ms=sd3["plain_ms"], bound_ms=sd3["bound_ms"],
                 bound_by=sd3["bound_by"], library_ms=sd3["library_ms"],
                 note=f"shape {list(BWD_TIMED[1])} bf16 (SD3-medium's joint "
                      f"length), pre-scaled q, the kernel at scale 1")]
    return kern, {"parallel": launches, "parallel_splash": splash_launches}


def phase_dit_validate():
    from naturaldiffusion_tpu_torch.apps import validate_dit

    t0 = time.perf_counter()
    rc = validate_dit.main(["--model", DIT_MODEL, "--alg", "ddim",
                            "--steps", str(DIT_ACC_STEPS), "--device",
                            "cuda"])
    if rc != 0:
        raise AssertionError("dit_validate: direct recursion and NI differ "
                             "beyond validate_dit's 1e-3 check")
    phase("dit_validate", t0, model=DIT_MODEL, alg="ddim",
          steps=DIT_ACC_STEPS, rc=rc)

# ------------------------------------------------------------------ VE path

def gn_inputs(torch, sig, dtype, gen):
    """Random inputs of a K6 signature: activations with a mean offset (the
    fast variance's hard case), scale near 1, small biases."""
    (b, h, w, c), _, _, eb_rows = sig

    def rn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")
    x = (1.0 + rn(b, h, w, c)).to(dtype)
    scale, bias = 1.0 + 0.1 * rn(c), 0.1 * rn(c)
    eb = None if eb_rows is None else (0.5 * rn(eb_rows, c)).to(dtype)
    return x, scale, bias, eb


def k6_row(torch, sig, mult, timer, gen, other_form=False, clean=None):
    """K6 at one signature ``((b, h, w, c), groups, act, extra-bias rows)``
    against its plain version in f32 and bf16, in its plan's form and, with
    ``other_form``, in the forms after it in ``K6_OTHER`` (those the shape
    also fits); then timed in bf16 beside the plain version,
    ``F.group_norm`` and the bytes bound, with the host time a call, and by
    the ``clean`` timer where one is given.  ``mult``: launches per
    forward."""
    import torch.nn.functional as F
    from naturaldiffusion_tpu_torch.ops import group_norm as G
    (b, h, w, c), groups, act, eb_rows = sig
    row = dict(sig=repr(sig), per_forward=mult)
    for dtype, tol in ((torch.float32, F32_TOL), (torch.bfloat16, BF16_TOL)):
        xx, sc, bi, eb = gn_inputs(torch, sig, dtype, gen)
        kw = dict(act=act, extra_bias=eb)
        want = G.fused_group_norm_reference(xx, sc, bi, groups, **kw)
        plan = G._gn_plan(b, h, w, c, groups, xx.element_size())
        dn = str(dtype)
        row[f"err_{dn}"], row[f"rel_err_{dn}"] = check_close(
            f"K6 group_norm {sig} {dn} {plan['form']}",
            G.fused_group_norm(xx, sc, bi, groups, **kw), want, tol)
        others = K6_OTHER[plan["form"]] if other_form else ()
        for other in others:
            row[f"err_{dn}_{other}"], row[f"rel_err_{dn}_{other}"] = (
                check_close(f"K6 group_norm {sig} {dn} {other}", G._launch(
                    xx, sc, bi, groups, 1e-6, act, eb, other), want, tol))
        if dtype != torch.bfloat16:
            continue
        xn = xx.permute(0, 3, 1, 2)
        sc16, bi16 = sc.to(dtype), bi.to(dtype)
        nbytes = 2 * 2 * b * h * w * c + 4 * 2 * c + (
            0 if eb is None else 2 * eb.numel())
        row.update(
            form=plan["form"], cluster=plan["cluster"],
            vec_bytes=plan["vec_bytes"], slice=plan["slice"],
            device_launches=plan["launches"],
            ms=timer(lambda: G.fused_group_norm(xx, sc, bi, groups, **kw)),
            plain_ms=timer(lambda: G.fused_group_norm_reference(
                xx, sc, bi, groups, **kw)),
            library_ms=timer(lambda: F.group_norm(xn, groups, sc16, bi16,
                                                  1e-6)),
            bytes=nbytes, bound_ms=nbytes / HBM_BYTES_PER_S * 1e3,
            bound_by="bytes",
            host_us=host_us(torch, lambda: G.fused_group_norm(
                xx, sc, bi, groups, **kw), n=50))
        row["bound_share"] = row["bound_ms"] / row["ms"]
        if clean is not None:
            row["ms_clean_l2"] = clean(lambda: G.fused_group_norm(
                xx, sc, bi, groups, **kw))
        for other in others:
            row[f"ms_{other}"] = timer(lambda: G._launch(
                xx, sc, bi, groups, 1e-6, act, eb, other))
    return row


def print_k6_row(r):
    other = "".join(f", {k[3:]} {v:.4f}" for k, v in r.items()
                    if k in ("ms_clean_l2", "ms_grid", "ms_streamed"))
    print(f"  group_norm {r['sig']} x{r['per_forward']}: {r['form']} "
          f"cluster {r['cluster']}, {r['ms']:.4f} ms{other}, bound "
          f"{r['bound_ms']:.4f} ({r['bound_share']:.0%}), plain "
          f"{r['plain_ms']:.4f}, library {r['library_ms']:.4f}, host "
          f"{r['host_us']:.1f} us", flush=True)


def phase_ve_kernels(model_bf16, details):
    """K4 and K6 at every shape of one batch-4 bf16 forward of the
    full-width VE model (and K4 at the three shapes named for it), against
    their plain versions in f32 and bf16, then timed in bf16.  Returns the
    kernels' rows and the forward's kernel signatures."""
    import torch
    import torch.nn.functional as F
    from naturaldiffusion_tpu_torch.ops import conv3x3 as C
    from naturaldiffusion_tpu_torch.ops import group_norm as G

    t0 = time.perf_counter()
    timer = Timer(torch)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 21)
    x = torch.rand((VE_BATCH, 256, 256, 3), generator=gen,
                   device="cuda").to(torch.bfloat16)
    sig_t = torch.full((VE_BATCH,), 2.0, device="cuda")
    sigs = kernel_signatures(model_bf16, x, sig_t)
    named = [((VE_BATCH, hw, hw, ci), (3, 3, ci, co), False, False, False)
             for hw, ci, co in ((256, 128, 128), (256, 256, 128),
                                (64, 512, 256))]
    k4_sigs = [sg for (kind, sg) in sigs if kind == "conv3x3_tiled"]
    if any(sg not in k4_sigs for sg in named):
        raise AssertionError(f"the forward's K4 shapes {k4_sigs} miss one "
                             f"of {named}")
    rows = {"conv3x3_tiled": [], "group_norm": []}
    for sg in k4_sigs:
        row = dict(sig=repr(sg), per_forward=sigs["conv3x3_tiled", sg])
        for dtype, tol in ((torch.float32, F32_TOL), (torch.bfloat16,
                                                      BF16_TOL)):
            xx, ww, bb, _, _ = conv_inputs(torch, sg, dtype, gen)
            with torch.backends.cudnn.flags(enabled=False):
                want = C.conv3x3_gn_reference(xx, ww, bb)
            got = C.conv3x3_tiled(xx, ww, bb)
            dn = str(dtype)
            row[f"err_{dn}"], row[f"rel_err_{dn}"] = check_close(
                f"K4 conv3x3_tiled {sg} {dn}", got, want, tol)
            if dtype == torch.bfloat16:
                xcl = xx.permute(0, 3, 1, 2)
                wcl = ww.permute(3, 2, 0, 1).contiguous(
                    memory_format=torch.channels_last)
                row.update(
                    ms=timer(lambda: C.conv3x3_tiled(xx, ww, bb)),
                    plain_ms=timer(lambda: C.conv3x3_gn_reference(xx, ww,
                                                                  bb)),
                    library_ms=timer(lambda: F.conv2d(xcl, wcl, bb,
                                                      padding=1)))
                (row["flops"], row["bytes"], row["bound_ms"],
                 row["bound_by"]) = conv_cost(sg, 2, dn)
                row["plan"] = plan_of(sg)
        rows["conv3x3_tiled"].append(row)
    clean = Timer(torch, clean=True)
    for (kind, sg), mult in sigs.items():
        if kind == "group_norm":
            rows["group_norm"].append(k6_row(
                torch, sg, mult, timer, gen, other_form=sg in K6_FORCED,
                clean=clean))
    if any(("group_norm", sg) not in sigs for sg in K6_FORCED):
        raise AssertionError(f"the forward's K6 shapes miss one of "
                             f"{K6_FORCED}")
    # and at ragged shapes of no model, in both forms
    rows["group_norm_ragged"] = [k6_row(torch, sg, 0, timer, gen,
                                        other_form=True)
                                 for sg in K6_RAGGED]
    details["ve_kernels"] = rows

    # host cost of one launch through each wrapper, at small shapes
    sg4 = ((1, 64, 64, 128), (3, 3, 128, 128), False, False, False)
    xx, ww, bb, _, _ = conv_inputs(torch, sg4, torch.bfloat16, gen)
    gx, gs, gb, geb = gn_inputs(torch, ((1, 16, 16, 128), 32, "silu", 1),
                                torch.bfloat16, gen)
    host = {"conv3x3_tiled": host_us(torch, lambda: C.conv3x3_tiled(
        xx, ww, bb)), "group_norm": host_us(torch, lambda: G.fused_group_norm(
            gx, gs, gb, 32, act="silu", extra_bias=geb))}

    meta = {"conv3x3_tiled": (
        "naturaldiffusion_tpu/ops/conv3x3.py:368",
        "naturaldiffusion_tpu/ops/conv3x3.py:472",
        "naturaldiffusion_tpu_torch/csrc/conv3x3.cu"),
        "group_norm": ("naturaldiffusion_tpu/ops/group_norm.py:76", None,
                       "naturaldiffusion_tpu_torch/csrc/group_norm.cu")}
    out = []
    for kind, (replaces, also, source) in meta.items():
        tot = {k: sum(r[k] * r["per_forward"] for r in rows[kind])
               for k in ("ms", "plain_ms", "library_ms", "bound_ms",
                         "bytes")}
        flops = sum(r.get("flops", 0) * r["per_forward"] for r in rows[kind])
        row = dict(
            name=kind, route="cuda", source=source, replaces=replaces,
            max_abs_err=max(v for r in rows[kind] + rows.get(
                kind + "_ragged", []) for k, v in r.items()
                if k.startswith("err_")),
            max_rel_err=max(v for r in rows[kind] + rows.get(
                kind + "_ragged", []) for k, v in r.items()
                if k.startswith("rel_err_")),
            ms=tot["ms"], plain_ms=tot["plain_ms"], bound_ms=tot["bound_ms"],
            bound_by=("operations" if flops / PEAK_FLOPS["torch.bfloat16"]
                      >= tot["bytes"] / HBM_BYTES_PER_S else "bytes"),
            library_ms=tot["library_ms"])
        out.append(row)
        if also:
            out.append(dict(row, name="conv3x3_tiledew", replaces=also,
                            served_by="conv3x3_tiled"))
        details[f"ve_{kind}_per_forward"] = dict(
            launches=sum(r["per_forward"] for r in rows[kind]), flops=flops,
            **tot)
    for r in rows["conv3x3_tiled"]:
        print_conv_row("conv3x3_tiled", r)
    for r in rows["group_norm"] + rows["group_norm_ragged"]:
        print_k6_row(r)
    per_fwd = {k: sum(n for (kind, _), n in sigs.items() if kind == k)
               for k in ("conv3x3", "conv3x3_gn", "conv3x3_tiled",
                         "group_norm")}
    phase("ve_kernels", t0, config=VE_CONFIG, batch=VE_BATCH,
          checks={k: len(v) for k, v in rows.items()},
          tolerances=dict(f32=F32_TOL, bf16=BF16_TOL),
          per_forward_launches=per_fwd,
          host_us_per_launch={k: round(v, 2) for k, v in host.items()},
          kernels={k["name"]: dict(
              {f: round(k[f], 4) for f in ("ms", "plain_ms", "library_ms",
                                          "bound_ms")},
              max_abs_err=k["max_abs_err"], max_rel_err=k["max_rel_err"])
              for k in out},
          k4_tflops=details["ve_conv3x3_tiled_per_forward"]["flops"]
          / details["ve_conv3x3_tiled_per_forward"]["ms"] / 1e9,
          k6_forms={f: sum(r["per_forward"] for r in rows["group_norm"]
                           if r["form"] == f) for f in ("onchip", "streamed")},
          k6_bound_share=details["ve_group_norm_per_forward"]["bound_ms"]
          / details["ve_group_norm_per_forward"]["ms"],
          k6_ms_clean_l2=sum(r["ms_clean_l2"] * r["per_forward"]
                             for r in rows["group_norm"]),
          note="ms: sum over one batch-4 bf16 forward's launches; library: "
               "F.conv2d channels-last with cuDNN, F.group_norm on the NCHW "
               "view (without the extra bias and the SiLU)")
    return out, sigs


def ve_model(seed):
    from naturaldiffusion_tpu_torch import configs
    from naturaldiffusion_tpu_torch.models.ncsnpp import NCSNpp
    cfg = configs.get_config(VE_CONFIG)
    return cfg, randomize_(NCSNpp(cfg.model, device="cpu"), seed).eval()


def ve_input(torch):
    gen = torch.Generator().manual_seed(SEED + 22)
    return torch.rand((1, 256, 256, 3), generator=gen), torch.tensor([1.87])


def phase_ve_forward(model_f32, oracles):
    """The full-width VE forward at one image, f32, card against CPU (the
    oracle process's forward); then a level-0 resblock at the path's shape
    in its unfused and fused forms."""
    import torch
    from naturaldiffusion_tpu_torch.models.layers import ResnetBlockBigGANpp
    t0 = time.perf_counter()
    x, sigma = ve_input(torch)
    card = copy.deepcopy(model_f32).to("cuda")
    with torch.no_grad():
        got = card(x.cuda(), sigma.cuda())
        torch.cuda.synchronize()
    want, cpu_s, _ = oracles.get("ve")
    err = rel_l2(got, want)
    if not (torch.isfinite(got).all() and err <= VE_FORWARD_TOL
            and got.shape == (1, 256, 256, 3)):
        raise AssertionError(f"ve_forward: rel L2 {err:.3e} > "
                             f"{VE_FORWARD_TOL:g} or non-finite")
    del card

    # the first resblock: 256^2, 128 -> 128, unfused on the path
    blk = next(m for m in model_f32.layers.values()
               if isinstance(m, ResnetBlockBigGANpp))
    blk = copy.deepcopy(blk).to(device="cuda", dtype=torch.bfloat16)
    g2 = torch.Generator(device="cuda").manual_seed(SEED + 23)
    h = torch.randn((VE_BATCH, 256, 256, 128), generator=g2,
                    device="cuda").to(torch.bfloat16)
    temb = torch.randn((VE_BATCH, 512), generator=g2,
                       device="cuda").to(torch.bfloat16)
    form = blk.route(h)
    if form != "unfused":
        raise AssertionError(f"level-0 resblock routed {form}")
    timer = Timer(torch)
    with torch.no_grad():
        unfused = blk(h, temb)
        t_unfused = timer(lambda: blk(h, temb))
        blk.route = lambda x: "fused"
        fused = blk(h, temb)
        t_fused = timer(lambda: blk(h, temb))
    blk_err = rel_l2(fused, unfused)
    if blk_err > BF16_TOL:
        raise AssertionError(f"level-0 resblock: fused vs unfused rel L2 "
                             f"{blk_err:.3e}")
    phase("ve_forward", t0, config=VE_CONFIG, rel_l2=err, tol=VE_FORWARD_TOL,
          cpu_seconds=cpu_s,
          params=sum(p.numel() for p in model_f32.parameters()),
          out_abs_max=float(want.abs().max()),
          level0_block=dict(shape=list(h.shape), unfused_ms=t_unfused,
                            fused_ms=t_fused, rel_l2_fused_vs_unfused=blk_err,
                            faster_form=("unfused" if t_unfused <= t_fused
                                         else "fused")))


def ve_counters():
    from naturaldiffusion_tpu_torch.ops import conv3x3 as C
    from naturaldiffusion_tpu_torch.ops import group_norm as G
    return {"conv3x3": C.conv3x3, "conv3x3_gn": C.conv3x3_gn,
            "conv3x3_tiled": C.conv3x3_tiled,
            "fused_group_norm": G.fused_group_norm}


def phase_ve_slice(cfg, model_f32, sigs, smi):
    """PC sampling over the full-width VE model in bf16 at batch 4 through
    ``get_pc_sampler``, N = VE_STEPS; then the accuracy check with its two
    controls."""
    import torch
    from naturaldiffusion_tpu_torch.samplers.pc import get_pc_sampler
    from naturaldiffusion_tpu_torch.scaler import get_inverse_scaler
    from naturaldiffusion_tpu_torch.sde import VESDE, get_score_fn

    t0 = time.perf_counter()
    model = copy.deepcopy(model_f32).to(device="cuda", dtype=torch.bfloat16)
    model32 = copy.deepcopy(model_f32).to("cuda")
    sde = VESDE(sigma_min=cfg.sde.sigma_min, sigma_max=cfg.sde.sigma_max,
                N=VE_STEPS)
    shape = (VE_BATCH, 256, 256, 3)
    pc_kw = dict(predictor=cfg.sampling.predictor,
                 corrector=cfg.sampling.corrector, snr=cfg.sampling.snr,
                 n_steps=cfg.sampling.n_steps_each, device="cuda")

    def sampler(net, dtype, time_scale=1.0):
        score = get_score_fn(sde, lambda x, s: net(x.to(dtype),
                                                   s * time_scale))
        return get_pc_sampler(sde, score, shape, **pc_kw)

    def seeded():
        return torch.Generator(device="cuda").manual_seed(SEED + 24)

    run = sampler(model, torch.bfloat16)
    xs = torch.rand(shape, generator=seeded(), device="cuda")
    with torch.no_grad():
        model(xs.to(torch.bfloat16), torch.full((VE_BATCH,), 2.0,
                                                device="cuda"))  # warm-up
    torch.cuda.synchronize()
    counters = ve_counters()
    zero_counts(counters)
    tr = time.perf_counter()
    out, nfe = run(seeded())
    torch.cuda.synchronize()
    wall = time.perf_counter() - tr
    counts = read_counts(counters)
    per_fwd = {"conv3x3": 0, "conv3x3_gn": 0, "conv3x3_tiled": 0,
               "fused_group_norm": 0}
    for (kind, _), n in sigs.items():
        per_fwd["fused_group_norm" if kind == "group_norm" else kind] += n
    expect = {k: nfe * v for k, v in per_fwd.items()}
    if counts != expect or nfe != 2 * VE_STEPS:
        raise AssertionError(f"ve_slice: launches {counts} != {expect}")
    img = get_inverse_scaler(cfg.model.centered)(out)
    if not (torch.isfinite(img).all() and img.shape == shape):
        raise AssertionError("ve_slice: non-finite or misshapen samples")

    # device-busy share of one forward, from the profiler
    s_lab = torch.full((VE_BATCH,), 2.0, device="cuda")
    prof = profiled(torch, lambda: model(xs.to(torch.bfloat16), s_lab))

    # accuracy: the same seeded run in f32 through the plain versions on
    # the card (TF32 off), against the kernels in bf16; two controls
    with plain_convs_and_norms():
        want, _ = sampler(model32, torch.float32)(seeded())
        ctl_plain = rel_l2(sampler(model, torch.bfloat16)(seeded())[0], want)
    err = rel_l2(out, want)
    err32 = rel_l2(sampler(model32, torch.float32)(seeded())[0], want)
    ctl_fault = rel_l2(sampler(model, torch.bfloat16, 1.01)(seeded())[0],
                       want)
    fwd_s = wall / nfe
    phase("ve_slice", t0, config=VE_CONFIG, batch=VE_BATCH, steps=VE_STEPS,
          steps_in_config=cfg.sde.num_scales,
          reduction=f"N = {VE_STEPS} PC steps instead of "
                    f"{cfg.sde.num_scales}", card=smi,
          img_per_s=VE_BATCH / wall, wall_s=wall, nfe=nfe,
          sec_per_forward=fwd_s,
          computed_sec_per_image_at_config_steps=(
              wall / VE_BATCH * cfg.sde.num_scales / VE_STEPS),
          mfu=VE_FLOP_PER_IMAGE * VE_BATCH * nfe / wall
          / PEAK_FLOPS["torch.bfloat16"],
          launches=counts, launches_per_forward=per_fwd,
          profiled_forward=prof,
          rel_l2_bf16_vs_plain_f32=err, tol=VE_SLICE_TOL,
          rel_l2_f32_vs_plain_f32=err32, tol_f32=VE_SLICE_F32_TOL,
          control_plain_bf16_rel_l2=ctl_plain,
          control_time_1pct_off_rel_l2=ctl_fault,
          sample_abs_max=float(out.abs().max()))
    if err > VE_SLICE_TOL or err32 > VE_SLICE_F32_TOL:
        raise AssertionError(f"ve_slice: rel L2 {err:.3e} (bf16, tol "
                             f"{VE_SLICE_TOL:g}), {err32:.3e} (f32, tol "
                             f"{VE_SLICE_F32_TOL:g})")
    del model, model32
    return counts


# ------------------------------------------------------------ backbones

def zoo_model(name, seed):
    """A zoo entry's config and its model through ``models.create_model``
    on the CPU, every weight random from ``seed``."""
    from naturaldiffusion_tpu_torch import configs
    from naturaldiffusion_tpu_torch.models import create_model
    cfg = configs.get_config(name)
    net = create_model(cfg.model_family, cfg.model, device="cpu")
    return cfg, randomize_(net, seed).eval()


def check_model_kernels(model, x, t, what):
    """Every kernel call of one forward of ``model`` on ``x``, ``t``
    (``kernel_signatures``: K2, K3, K4 and K6, each signature once) against
    its plain version on fresh inputs, f32 and bf16; returns the signatures
    and the rows."""
    import torch
    from naturaldiffusion_tpu_torch.ops import conv3x3 as C
    from naturaldiffusion_tpu_torch.ops import group_norm as G
    gen = torch.Generator(device="cuda").manual_seed(SEED + 80)
    sigs = kernel_signatures(model, x, t)
    rows = []
    for (kind, sig), n in sigs.items():
        row = dict(kind=kind, sig=repr(sig), per_forward=n)
        for dtype in (torch.float32, torch.bfloat16):
            dn = str(dtype)
            if kind != "group_norm":
                row[f"err_{dn}"], _, row[f"stats_err_{dn}"] = check_conv(
                    torch, C, kind, sig, dtype, gen, f"{what} ")
                continue
            (b, h, w, c), groups, act, _ = sig
            xx, sc, bi, eb = gn_inputs(torch, sig, dtype, gen)
            row["form"] = G._gn_plan(b, h, w, c, groups,
                                     xx.element_size())["form"]
            row[f"err_{dn}"] = check_close(
                f"{what} K6 {sig} {dn}",
                G.fused_group_norm(xx, sc, bi, groups, act=act,
                                   extra_bias=eb),
                G.fused_group_norm_reference(xx, sc, bi, groups, act=act,
                                             extra_bias=eb),
                F32_TOL if dtype == torch.float32 else BF16_TOL)[0]
        rows.append(row)
    print(f"  {what}: {len(rows)} kernel signatures against their plain "
          f"versions, max abs err {max(v for r in rows for k, v in r.items() if k.startswith('err_')):.3e}",
          flush=True)
    return sigs, rows


def time_conv(sig, kind, timer, gen):
    """One bf16 conv signature timed: the kernel, the plain version,
    ``F.conv2d`` on channels-last views, and the bound."""
    import torch
    import torch.nn.functional as F
    from naturaldiffusion_tpu_torch.ops import conv3x3 as C
    xx, ww, bb, _, _ = conv_inputs(torch, sig, torch.bfloat16, gen)
    xcl = xx.permute(0, 3, 1, 2)
    wcl = ww.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
    row = dict(sig=repr(sig), per_forward=1,
               ms=timer(lambda: getattr(C, kind)(xx, ww, bb)),
               plain_ms=timer(lambda: C.conv3x3_gn_reference(xx, ww, bb)),
               library_ms=timer(lambda: F.conv2d(xcl, wcl, bb, padding=1)),
               plan=plan_of(sig))
    row["flops"], row["bytes"], row["bound_ms"], row["bound_by"] = \
        conv_cost(sig, 2, "torch.bfloat16")
    print_conv_row(kind, row)
    return row


def backbones_ddpm(drive, smi, oracles):
    """(a) The CIFAR-10 DDPM under 10-step DDPM NI, batch 64, bf16, through
    ``cifar10_ni.make_sampler``: the eager run, the graphed sampler's build
    (warm-up and capture) and a replay, each drive's launches against the
    walk's; graph against eager; 2 samples in f32 and bf16 against a CPU
    f32 run with the same noises, beside the slice's two controls; every
    K2 and K6 shape of its forward, and each Q1 shape under int8_static
    bit for bit, against their plain versions."""
    import torch
    from naturaldiffusion_tpu_torch.apps.cifar10_ni import make_sampler
    from naturaldiffusion_tpu_torch.coeffs import registry
    from naturaldiffusion_tpu_torch.ops import quant as Q

    _, model = zoo_model(DDPM_CONFIG, SEED + 70)
    params = sum(p.numel() for p in model.parameters())
    matrix = registry.derive("ddpm", STEPS)
    init, noises = ni_draws(torch, SEED + 71)
    net16 = copy.deepcopy(model).to(device="cuda", dtype=torch.bfloat16)
    per_fwd = per_forward_counts(net16, torch.bfloat16, BATCH)
    if per_fwd != DDPM_PER_FORWARD:
        raise AssertionError(f"ddpm: launches a forward {per_fwd} != "
                             f"{DDPM_PER_FORWARD}")
    eager = make_sampler(model, matrix, micro=BATCH, device="cuda")
    graphed = make_sampler(model, matrix, micro=BATCH, device="cuda",
                           graph=True)
    eager(init, noises=noises)                  # warm-up
    torch.cuda.synchronize()
    te = time.perf_counter()
    with drive("ddpm eager NI", lambda: expect_counts(per_fwd, STEPS,
                                                      STEPS)):
        out = eager(init, noises=noises)
    wall_eager = time.perf_counter() - te
    with drive("ddpm graph build", lambda: expect_counts(
            per_fwd, 2 * STEPS, 2 * STEPS)):
        built = graphed(init, noises=noises)
    tg = time.perf_counter()
    with drive("ddpm graph replay", lambda: expect_counts(per_fwd, 0)):
        replay = graphed(init, noises=noises)
    wall_graph = time.perf_counter() - tg
    err_graph = max(rel_l2(built, out), rel_l2(replay, out))
    if not (torch.isfinite(out).all() and out.shape == init.shape
            and err_graph <= BENCH_GRAPH_TOL):
        raise AssertionError(f"ddpm: graph against eager {err_graph:.3e} "
                             f"> {BENCH_GRAPH_TOL:g}, or non-finite")

    got32 = make_sampler(model, matrix, micro=BATCH, dtype=torch.float32,
                         device="cuda")(init[:2], noises=noises[:, :2])
    plain, fault = slice_controls(model, matrix, init[:2], noises[:, :2])
    want, cpu_s, _ = oracles.get("ddpm")
    err, err32 = rel_l2(out[:2], want), rel_l2(got32, want)
    ctl_plain, ctl_fault = rel_l2(plain, want), rel_l2(fault, want)
    if err > SLICE_TOL or err32 > SLICE_F32_TOL:
        raise AssertionError(f"ddpm: rel L2 {err:.3e} (bf16, tol "
                             f"{SLICE_TOL:g}), {err32:.3e} (f32, tol "
                             f"{SLICE_F32_TOL:g})")
    del eager, graphed

    x16 = init.to(torch.bfloat16)
    tc = torch.full((BATCH,), 500.0, device="cuda")
    sigs, rows = check_model_kernels(net16, x16, tc, "ddpm")
    if {k for k, _ in sigs} != {"conv3x3", "group_norm"}:
        raise AssertionError(f"ddpm: kernels {sorted({k for k, _ in sigs})}")
    amax = Q.static_amax()
    g8 = torch.Generator(device="cuda").manual_seed(SEED + 73)
    q_sigs = int8_signatures(net16, x16, tc)
    if sum(q_sigs.values()) != DDPM_INT8_PER_FORWARD:
        raise AssertionError(f"ddpm: {sum(q_sigs.values())} int8 convs a "
                             f"forward, not {DDPM_INT8_PER_FORWARD}")
    q_counts = per_forward_counts(net16, torch.bfloat16, BATCH,
                                  BENCH_DEFAULT_FORM[:2])
    if q_counts["conv3x3_int8"] != DDPM_INT8_PER_FORWARD:
        raise AssertionError(f"ddpm int8_static: launches {q_counts}")
    for (xs, ws) in q_sigs:
        xx = (2.0 * torch.randn(xs, generator=g8, device="cuda")).to(
            torch.bfloat16)
        wt = (torch.randn(ws, generator=g8, device="cuda")
              / math.sqrt(9 * xs[3])).to(torch.bfloat16)
        bias = (0.1 * torch.randn(ws[3], generator=g8, device="cuda")).to(
            torch.bfloat16)
        w_i8, s_w, wk = Q.quantize_conv_weight(wt)
        got = Q.conv3x3_int8(xx, None, bias, w_i8=w_i8, s_w=s_w, w_kern=wk,
                             act_amax=amax)
        if not torch.equal(got, Q.conv3x3_int8_reference(
                xx, w_i8, s_w, bias, act_amax=amax)):
            raise AssertionError(f"ddpm Q1 {xs} -> {ws[3]}: differs from "
                                 f"the plain version")
    row = dict(config=DDPM_CONFIG, params=params, batch=BATCH, steps=STEPS,
               per_forward=per_fwd, cpu_oracle_s=cpu_s,
               img_per_s_graphed=BATCH / wall_graph,
               img_per_s_eager=BATCH / wall_eager,
               rel_l2_graph_vs_eager=err_graph, tol_graph=BENCH_GRAPH_TOL,
               rel_l2_bf16_vs_cpu_f32=err, tol=SLICE_TOL,
               rel_l2_f32_vs_cpu_f32=err32, tol_f32=SLICE_F32_TOL,
               control_plain_bf16_rel_l2=ctl_plain,
               control_time_1pct_off_rel_l2=ctl_fault,
               k2_shapes=sum(k == "conv3x3" for k, _ in sigs),
               k6_shapes=sum(k == "group_norm" for k, _ in sigs),
               q1_shapes=len(q_sigs), q1_per_forward=DDPM_INT8_PER_FORWARD,
               q1_bitwise_equal=True, card=smi)
    print(f"  ddpm: {json.dumps(row)}", flush=True)
    del net16, model
    return row


def backbones_ddpm_256(drive, timer):
    """(b) One bf16 forward of the CelebA-HQ 256 DDPM at one image: its
    launches, and every kernel shape of it (K4 at the 128-channel 256^2 and
    128^2 convs) against the plain versions; the largest K4 shape timed."""
    import torch
    _, model = zoo_model(DDPM_256_CONFIG, SEED + 72)
    net = model.to(device="cuda", dtype=torch.bfloat16)
    x = torch.rand((1, 256, 256, 3), generator=torch.Generator(
        device="cuda").manual_seed(SEED + 74), device="cuda").to(
        torch.bfloat16)
    t = torch.full((1,), 500.0, device="cuda")
    per_fwd = per_forward_counts(net, torch.bfloat16, 1, hw=256)
    with drive("ddpm 256 forward", lambda: expect_counts(per_fwd, 1)), \
            torch.no_grad():
        out = net(x, t)
    if not (torch.isfinite(out).all() and out.shape == x.shape
            and per_fwd["conv3x3_tiled"] > 0):
        raise AssertionError(f"ddpm 256: launches {per_fwd}, or non-finite")
    sigs, rows = check_model_kernels(net, x, t, "ddpm 256")
    k4 = max((s for k, s in sigs if k == "conv3x3_tiled"),
             key=lambda s: math.prod(s[0]) * s[1][3])
    timed = time_conv(k4, "conv3x3_tiled", timer, torch.Generator(
        device="cuda").manual_seed(SEED + 75))
    res = dict(config=DDPM_256_CONFIG,
               params=sum(p.numel() for p in model.parameters()),
               per_forward=per_fwd,
               k4_shapes=sum(k == "conv3x3_tiled" for k, _ in sigs),
               k6_forms=sorted({r["form"] for r in rows
                                if r["kind"] == "group_norm"}),
               k4_timed=timed)
    del net, model
    return res


def refinenet_inputs(torch):
    """The NCSNv2 and NCSN models of ``backbones_refinenets`` on the CPU
    with their inputs (one 32^2 image from SEED + 76, the label a third of
    the scales): [((cfg, model), x, label)]."""
    gen = torch.Generator().manual_seed(SEED + 76)
    out = []
    for name, seed in ((NCSNV2_CONFIG, SEED + 77), (NCSN_CONFIG, SEED + 78)):
        cfg, model = zoo_model(name, seed)
        x = torch.rand((1, 32, 32, 3), generator=gen)
        lab = torch.tensor([cfg.model.num_scales // 3], dtype=torch.float32)
        out.append(((cfg, model), x, lab))
    return out


def backbones_refinenets(drive, oracles):
    """(c) NCSNv2 and NCSN at 32^2, f32, the card against the CPU at one
    image (the CPU forwards in the oracle process); NCSNv2_128 at 128^2 in bf16 against the card's f32 beside a
    1 %-off input control; annealed Langevin over NCSN (``ve/ncsn/*``'s
    sampling) through ``get_pc_sampler``.  No kernel of the port is on
    these paths (their convs are library convs, as the JAX package's are
    XLA): each drive must count none."""
    import torch
    from naturaldiffusion_tpu_torch.samplers.pc import get_pc_sampler
    from naturaldiffusion_tpu_torch.sde import VESDE, get_score_fn
    none = {k: 0 for k in bench_counters()}
    res = {}
    wants = oracles.get("refinenets")[0]       # the CPU forwards
    for name, ((cfg, model), x, lab), want in zip(
            (NCSNV2_CONFIG, NCSN_CONFIG), refinenet_inputs(torch), wants):
        ncsn = cfg, model                         # NCSN last: ALD's
        card = copy.deepcopy(model).to("cuda")
        with drive(f"{name} forward", lambda: none), torch.no_grad():
            got = card(x.cuda(), lab.cuda())
        err = rel_l2(got, want)
        res[name] = dict(family=cfg.model_family, rel_l2=err,
                         params=sum(p.numel() for p in model.parameters()))
        if not (torch.isfinite(got).all() and err <= FORWARD_TOL):
            raise AssertionError(f"{name}: card against CPU rel L2 "
                                 f"{err:.3e} > {FORWARD_TOL:g}")
        del card
    cfg, model = zoo_model(NCSNV2_128_CONFIG, SEED + 79)
    net32 = model.to("cuda")
    net16 = copy.deepcopy(net32).to(torch.bfloat16)
    gen = torch.Generator().manual_seed(SEED + 76)
    for _ in range(2):                   # past the two 32^2 images above
        torch.rand((1, 32, 32, 3), generator=gen)
    x = torch.rand((1, 128, 128, 3), generator=gen).cuda()
    lab = torch.full((1,), 500.0, device="cuda")
    with torch.no_grad():
        want = net32(x, lab)
        with drive(f"{NCSNV2_128_CONFIG} forward", lambda: none):
            got = net16(x.to(torch.bfloat16), lab)
        ctl = net16((x * 1.01).to(torch.bfloat16), lab)
    err, err_ctl = rel_l2(got, want), rel_l2(ctl, want)
    res[NCSNV2_128_CONFIG] = dict(
        family=cfg.model_family, rel_l2_bf16_vs_f32=err,
        tol=NCSNV2_BF16_TOL, control_input_1pct_off_rel_l2=err_ctl,
        params=sum(p.numel() for p in model.parameters()))
    if not (torch.isfinite(got).all() and err <= NCSNV2_BF16_TOL):
        raise AssertionError(f"{NCSNV2_128_CONFIG}: bf16 against f32 rel "
                             f"L2 {err:.3e} > {NCSNV2_BF16_TOL:g}")
    del net16, net32, model

    cfg, model = ncsn
    net = model.to("cuda")
    sde = VESDE(sigma_min=cfg.sde.sigma_min, sigma_max=cfg.sde.sigma_max,
                N=cfg.sde.num_scales)
    shape = (ALD_BATCH, 32, 32, 3)
    sampler = get_pc_sampler(
        sde, get_score_fn(sde, net, continuous=cfg.sde.continuous), shape,
        predictor=cfg.sampling.predictor, corrector=cfg.sampling.corrector,
        snr=cfg.sampling.snr, n_steps=ALD_STEPS_EACH, device="cuda")
    tr = time.perf_counter()
    with drive("ncsn ald", lambda: none):
        out, nfe = sampler(torch.Generator(device="cuda").manual_seed(
            SEED + 81))
    wall = time.perf_counter() - tr
    res["ald"] = dict(config=NCSN_CONFIG, sigmas=sde.N,
                      n_steps_each=ALD_STEPS_EACH,
                      n_steps_each_in_config=cfg.sampling.n_steps_each,
                      reduction=f"n_steps_each = {ALD_STEPS_EACH} instead "
                                f"of {cfg.sampling.n_steps_each}",
                      batch=ALD_BATCH, nfe=nfe, wall_s=wall,
                      sample_abs_max=float(out.abs().max()))
    if not (torch.isfinite(out).all() and out.shape == shape
            and nfe == sde.N * (ALD_STEPS_EACH + 1)
            and cfg.sampling.predictor == "none"
            and cfg.sampling.corrector == "ald"):
        raise AssertionError(f"ncsn ald: {res['ald']}")
    del net, model
    return res


def backbones_ncsnpp_1024(drive, timer):
    """(d) One forward of the 1024^2 NCSN++ at one image: the bf16 kernels
    and the f32 kernels against the f32 plain versions on the card, beside
    a 1 %-off sigma control; its launches and ms; every kernel shape of
    the forward (the C < 128 convs at 256^2-1024^2 on K2) against the plain
    versions; the largest K2 shape and K6 at 1024^2 x 16 timed."""
    import torch
    _, model = zoo_model(NCSNPP_1024_CONFIG, SEED + 82)
    net32 = model.to("cuda")
    net16 = copy.deepcopy(net32).to(torch.bfloat16)
    x = torch.rand((1, 1024, 1024, 3), generator=torch.Generator(
        device="cuda").manual_seed(SEED + 83), device="cuda")
    x16 = x.to(torch.bfloat16)
    sigma = torch.full((1,), 50.0, device="cuda")
    per_fwd = per_forward_counts(net16, torch.bfloat16, 1, hw=1024,
                                 label=50.0)
    with torch.no_grad():
        with drive("ncsnpp 1024 forward", lambda: expect_counts(per_fwd, 1)):
            s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            s.record()
            out = net16(x16, sigma)
            e.record()
            e.synchronize()
        fwd_ms = s.elapsed_time(e)
        got32 = net32(x, sigma)
        with plain_convs_and_norms():
            want = net32(x, sigma)
            plain16 = net16(x16, sigma)
        ctl = net16(x16, sigma * 1.01)
    err, err32, err_ctl = (rel_l2(out, want), rel_l2(got32, want),
                           rel_l2(ctl, want))
    if not (torch.isfinite(out).all() and out.shape == x.shape
            and err <= NCSNPP_1024_TOL and err32 <= FORWARD_TOL):
        raise AssertionError(f"ncsnpp 1024: rel L2 {err:.3e} (bf16, tol "
                             f"{NCSNPP_1024_TOL:g}), {err32:.3e} (f32, "
                             f"tol {FORWARD_TOL:g})")
    sigs, rows = check_model_kernels(net16, x16, sigma, "ncsnpp 1024")
    narrow = [s for k, s in sigs if k != "group_norm"
              and min(s[0][3], s[1][3]) < 128 and s[0][1] >= 256]
    gn1024 = ((1, 1024, 1024, 16), 4, "silu", None)
    if not narrow or any(k != "conv3x3" for k, s in sigs if s in narrow) \
            or not any(k == "group_norm" and s[:2] == gn1024[:2]
                       for k, s in sigs):
        raise AssertionError(f"ncsnpp 1024: signatures {sorted(sigs)}")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 84)
    k2 = max(narrow, key=lambda s: math.prod(s[0]) * s[1][3])
    timed = dict(conv3x3=time_conv(k2, "conv3x3", timer, gen),
                 group_norm=k6_row(torch, gn1024, 2, timer, gen))
    print_k6_row(timed["group_norm"])
    res = dict(config=NCSNPP_1024_CONFIG,
               params=sum(p.numel() for p in model.parameters()),
               per_forward=per_fwd, forward_ms_bf16=fwd_ms,
               rel_l2_bf16_vs_plain_f32=err, tol=NCSNPP_1024_TOL,
               rel_l2_f32_vs_plain_f32=err32, tol_f32=FORWARD_TOL,
               control_plain_bf16_rel_l2=rel_l2(plain16, want),
               control_sigma_1pct_off_rel_l2=err_ctl,
               narrow_conv_shapes=len(narrow),
               shapes_checked=len(rows),
               k6_forms=sorted({r["form"] for r in rows
                                if r["kind"] == "group_norm"}))
    del net16, net32, model
    return res, timed


def phase_backbones(smi, details, oracles):
    """The other backbones through their zoo entries: (a) the CIFAR DDPM
    under NI, (b) the 256^2 DDPM, (c) NCSNv2, NCSN and ALD, (d) the 1024^2
    NCSN++.  Its launches are the drives' (``Drive``)."""
    import torch
    t0 = time.perf_counter()
    drive = Drive("backbones")
    timer = Timer(torch, reps=5)
    parts, res = {}, {}
    for part, fn in (("ddpm", lambda: backbones_ddpm(drive, smi, oracles)),
                     ("ddpm_256", lambda: backbones_ddpm_256(drive, timer)),
                     ("refinenets",
                      lambda: backbones_refinenets(drive, oracles)),
                     ("ncsnpp_1024", lambda: backbones_ncsnpp_1024(
                         drive, timer))):
        tp = time.perf_counter()
        res[part] = fn()
        torch.cuda.empty_cache()
        parts[part] = time.perf_counter() - tp
    res["ncsnpp_1024"], details["backbones_timed"] = res["ncsnpp_1024"]
    details["backbones"] = res
    phase("backbones", t0, card=smi, **res, seconds_by_part=parts,
          launches=drive.total)
    return drive.total


# --------------------------------------------------------------- SD3 path

def sd3_counters():
    from naturaldiffusion_tpu_torch.ops import attention as A
    from naturaldiffusion_tpu_torch.ops import qmatmul as Q
    from naturaldiffusion_tpu_torch.ops import weighted_sum as WS
    return {"fused_weighted_sum": WS.fused_weighted_sum,
            "flash_attention": A.flash_attention,
            "matmul_wdq": Q.matmul_wdq}


def sd3_models(torch):
    """SD3-medium's five models at full width, made on the card from seeds:
    the MMDiT in f32 (the plain reference) with every weight random
    (``randomize_dit_``: its init zeroes the adaLN layers and proj_out)
    and its bf16 copy; CLIP-L, CLIP-G, T5-XXL and the SD3 VAE in bf16 at
    their own random init."""
    from naturaldiffusion_tpu_torch.models.mmdit import SD3_MEDIUM, MMDiT
    from naturaldiffusion_tpu_torch.models.text_encoders import (
        CLIP_G_SD3, CLIP_L_SD3, T5_XXL, CLIPTextEncoder, T5Encoder)
    from naturaldiffusion_tpu_torch.models.vae import SD3_VAE, AutoencoderKL
    bf = torch.bfloat16
    mm32 = randomize_dit_(MMDiT(SD3_MEDIUM, device="cuda", seed=SEED + 40),
                          SEED + 41).eval()
    mm16 = copy.deepcopy(mm32).to(bf)
    enc = dict(
        clip_l=CLIPTextEncoder(CLIP_L_SD3, device="cuda", seed=SEED + 42),
        clip_g=CLIPTextEncoder(CLIP_G_SD3, device="cuda", seed=SEED + 43),
        t5=T5Encoder(T5_XXL, device="cuda", seed=SEED + 44))
    enc = {k: m.to(bf).eval() for k, m in enc.items()}
    vae = AutoencoderKL(SD3_VAE, device="cuda", seed=SEED + 45).to(bf).eval()
    return mm32, mm16, enc, vae


@contextlib.contextmanager
def first_attention_inputs(store):
    """Within the block, the first ``ops.attention.mha`` call's q, k and v
    (the model's own strided views) are kept in ``store``."""
    from naturaldiffusion_tpu_torch.ops import attention as A
    saved = A.mha

    def keep(q, k, v, **kw):
        if not store:
            store.extend((q, k, v))
        return saved(q, k, v, **kw)
    A.mha = keep
    try:
        yield
    finally:
        A.mha = saved


def sd3_k9_in_model(torch, qkv, timer):
    """K9 on the first joint attention's own q, k, v (bf16 ``[2, 24, 4429,
    64]`` strided views): against its plain version, then timed beside it,
    SDPA's flash backend and the card's bound."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel
    from naturaldiffusion_tpu_torch.ops import attention as A
    q, k, v = qkv
    b, h, t, d = q.shape
    scale = 1.0 / math.sqrt(d)
    err = check_close("K9 in the SD3 model", A.flash_attention(q, k, v,
                                                               scale),
                      A.mha_reference(q, k, v, scale), BF16_TOL)

    def sdpa():
        with sdpa_kernel(SDPBackend.FLASH_ATTENTION):
            return F.scaled_dot_product_attention(q, k, v, scale=scale)
    flops, nbytes, bound, bound_by = attn_cost(b, h, t, d, 2)
    row = dict(shape=[b, h, t, d], strides=list(q.stride()),
               max_abs_err=err[0], max_rel_err=err[1],
               ms=timer(lambda: A.flash_attention(q, k, v, scale)),
               plain_ms=timer(lambda: A.mha_reference(q, k, v, scale)),
               library_ms=timer(sdpa), bound_ms=bound, bound_by=bound_by)
    row["tflops"] = flops / row["ms"] / 1e9
    return row


def sd3_k7_in_model(torch, model, run, timer):
    """K7 at SD3-medium's latent-stream product shapes (``SD3_K7_LAYERS``)
    on the first block's own int8 weights: ``run()`` (one forward of
    ``model`` under w8) gives each layer its activations, and its bf16 output is held against the plain
    version at BF16_TOL; the same activations in f32 go through K7 against
    the plain version at F32_TOL.  Returns a row per shape, timed in bf16
    beside the plain version, cuBLAS on the dequantized weight and the
    card's bound."""
    from naturaldiffusion_tpu_torch.ops import qmatmul as Q
    block = model.blocks[0]
    seen = {}

    def keep(name):
        def hook(mod, args, out):
            if name not in seen:
                seen[name] = (args[0].detach().clone(), out.detach().clone())
        return hook
    hooks = [getattr(block, n).register_forward_hook(keep(n))
             for n in SD3_K7_LAYERS]
    try:
        with torch.no_grad():
            before = Q.matmul_wdq.launches
            run()
            ran = Q.matmul_wdq.launches - before
    finally:
        for h in hooks:
            h.remove()
    rows = {}
    for name in SD3_K7_LAYERS:
        layer = getattr(block, name)
        x, got = seen[name]
        w_i8, s_w, b32 = layer._quantized(x.dtype)
        kk, n = w_i8.shape
        m = x.numel() // kk
        key = f"M{m}_K{kk}_N{n}"
        err16 = check_close(f"K7 in the SD3 model {key} bf16", got,
                            Q.matmul_wdq_reference(x, w_i8, s_w, b32),
                            BF16_TOL)
        x32 = x.float()
        err32 = check_close(
            f"K7 in the SD3 model {key} f32",
            Q.matmul_wdq(x32, w_i8, s_w, b32, layer._packed),
            Q.matmul_wdq_reference(x32, w_i8, s_w, b32), F32_TOL)
        w_dq = (w_i8.float() * s_w).to(x.dtype)
        flops = 2.0 * m * kk * n
        nbytes = 2 * m * kk + kk * n + 4 * n + 4 * n + 2 * m * n
        rows[key] = dict(
            layer=name, splits=Q._qm_plan(m, kk, n)["splits"],
            max_abs_err_bf16=err16[0], max_rel_err_bf16=err16[1],
            max_abs_err_f32=err32[0], max_rel_err_f32=err32[1],
            ms=timer(lambda: Q.matmul_wdq(x, w_i8, s_w, b32, layer._packed)),
            plain_ms=timer(lambda: Q.matmul_wdq_reference(x, w_i8, s_w,
                                                          b32)),
            library_ms=timer(lambda: torch.matmul(x, w_dq)),
            bound_ms=max(flops / PEAK_FLOPS["torch.bfloat16"],
                         nbytes / HBM_BYTES_PER_S) * 1e3)
    # the forward ran every latent-stream QDense on K7, 6 a block
    if ran != 6 * model.config.depth:
        raise AssertionError(f"sd3 w8 check: {ran} K7 launches in one "
                             f"forward, not {6 * model.config.depth}")
    return rows


def sd3_cfg_forward(model, t_all, ctx2, pool2):
    """``(fwd, step)``: the CFG predictor of ``mmdit_cfg_fwd_mods`` and its
    one step's hoisted conditioning at the single time ``t_all``."""
    from naturaldiffusion_tpu_torch.models.mmdit import mmdit_cfg_fwd_mods
    fwd, aux = mmdit_cfg_fwd_mods(model, ctx2=ctx2, pool2=pool2, t_all=t_all)
    return fwd, {"blocks": tuple((a[0], c[0]) for a, c in aux["blocks"]),
                 "out": aux["out"][0]}


def sd3_ids(torch, gen, b):
    """Random token ids of one prompt: CLIP rows of 77 (bos ... eos, the
    eos the highest id, as the real vocabulary's 49407), T5 rows of 256."""
    def rows(n, vocab):
        return torch.randint(1, vocab, (b, n), generator=gen, device="cuda")
    ids_l = rows(SD3_CLIP_LEN, 49406)
    ids_l[:, 0], ids_l[:, -1] = 49406, 49407
    return ids_l, ids_l.clone(), rows(SD3_T5_LEN, 32100)


def phase_sd3(smi, details):
    """The SD3 path through ``SD3Pipeline`` at SD3-medium's full width,
    1024^2, bf16: (1) random ids through ``encode_prompt`` with CLIP-L,
    CLIP-G and T5-XXL (t = 4096 + 333); (2) K9 on the model's own q, k, v
    against its plain version, timed; one forward and a 3-step NI through
    the kernels against the f32 plain versions on the card, beside the
    bf16 plain control and a 1 %-off time control; the 3-step latents
    decoded; (3) one image, warm: ``encode_prompt`` and ``__call__`` over
    the 28-step Euler matrix with the VAE decode at 1024^2, its K1, K9 and
    K7 launches counted, wall and sec/image, and one CFG forward profiled
    (busy share, K9's share); (4) the MMDiT under w8: K7 held against its
    plain version at each latent-stream shape on the model's own weights
    and activations, then 3 steps.  Returns the launches of the 28-step
    run, of the w8 run, K9's row and K7's rows."""
    import torch
    from naturaldiffusion_tpu_torch.models import mmdit as MM
    from naturaldiffusion_tpu_torch.pipeline import SD3Pipeline

    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    mm32, mm16, enc, vae = sd3_models(torch)
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    pipe = SD3Pipeline(mmdit=mm16, vae=vae, **enc)
    cfg = mm16.config
    hw = cfg.sample_size
    t_ctx = SD3_CLIP_LEN + SD3_T5_LEN
    gen = torch.Generator(device="cuda").manual_seed(SEED + 46)
    ids = (sd3_ids(torch, gen, 1), sd3_ids(torch, gen, 1))
    noise = torch.randn((1, hw, hw, cfg.in_channels), generator=gen,
                        device="cuda")
    counters = sd3_counters()

    def encode():
        """The prompt's and the negative prompt's conditioning."""
        (ctx, pooled), (nctx, npooled) = (pipe.encode_prompt(*i)
                                          for i in ids)
        return dict(context=ctx, pooled=pooled, neg_context=nctx,
                    neg_pooled=npooled)

    # (1) encode_prompt, with T5
    cond = encode()
    for a, shape in ((cond["context"], (1, t_ctx, cfg.joint_attention_dim)),
                     (cond["pooled"], (1, cfg.pooled_projection_dim))):
        if tuple(a.shape) != shape or not torch.isfinite(a).all():
            raise AssertionError(f"sd3 encode_prompt: {tuple(a.shape)} != "
                                 f"{shape} or non-finite")
    ctx2 = torch.cat([cond["context"], cond["neg_context"]])
    pool2 = torch.cat([cond["pooled"], cond["neg_pooled"]])

    # (2) K9 on the model's own q, k, v; one CFG forward at t = 500 on the
    # noise, f32 and bf16, against the f32 plain versions
    t_all = torch.tensor([500.0], device="cuda")
    fwd, step = sd3_cfg_forward(mm16, t_all, ctx2, pool2)
    fwd32, step32 = sd3_cfg_forward(mm32, t_all, ctx2.float(),
                                    pool2.float())
    fwd_off, step_off = sd3_cfg_forward(mm16, t_all * 1.01, ctx2, pool2)
    z16, z32 = noise.to(torch.bfloat16), noise
    timer = Timer(torch, reps=5)
    qkv = []
    with torch.no_grad():
        with first_attention_inputs(qkv):
            got16 = fwd(z16, t_all[0], step)
        k9 = sd3_k9_in_model(torch, qkv, timer)
        del qkv
        got32 = fwd32(z32, t_all[0], step32)
        fault = fwd_off(z16, t_all[0] * 1.01, step_off)
        with plain_versions():
            want32 = fwd32(z32, t_all[0], step32)
            plain16 = fwd(z16, t_all[0], step)
    fwd_check = dict(
        f32_rel_l2=rel_l2(got32, want32), f32_tol=SD3_FORWARD_TOL,
        bf16_rel_l2=rel_l2(got16, want32),
        control_plain_bf16_rel_l2=rel_l2(plain16, want32),
        control_time_1pct_off_rel_l2=rel_l2(fault, want32))
    fwd_check["bf16_limit"] = SD3_CONTROL_FACTOR * fwd_check[
        "control_plain_bf16_rel_l2"]
    del got32, want32, plain16, fault, got16, fwd32, fwd_off

    # the 3-step NI through the pipeline: kernels in bf16 against the f32
    # plain versions, beside the plain bf16 run and the time 1 % off
    pipe32 = SD3Pipeline(mmdit=mm32)
    cond32 = {k: v.float() for k, v in cond.items()}

    def ni(p, c):
        return p(noises=noise, num_steps=SD3_ACC_STEPS, decode=False, **c)
    with plain_versions():
        want = ni(pipe32, cond32)
        ctl_plain = rel_l2(ni(pipe, cond), want)
    lat3 = ni(pipe, cond)
    err_ni = rel_l2(lat3, want)
    saved = MM.mmdit_schedule_mods
    MM.mmdit_schedule_mods = lambda m, t, p, c, dtype=None: saved(
        m, t * 1.01, p, c, dtype)
    try:
        ctl_fault = rel_l2(ni(pipe, cond), want)
    finally:
        MM.mmdit_schedule_mods = saved
    ni_check = dict(steps=SD3_ACC_STEPS, bf16_rel_l2=err_ni,
                    control_plain_bf16_rel_l2=ctl_plain,
                    control_time_1pct_off_rel_l2=ctl_fault,
                    bf16_limit=SD3_CONTROL_FACTOR * ctl_plain)
    with torch.no_grad():
        img3 = vae.decode(vae.unscale_latents(lat3))
    if not torch.isfinite(img3).all():
        raise AssertionError("sd3: the 3-step image is not finite")
    del pipe32, mm32, img3, lat3

    # (3) one image, warm: encode, 28 steps, decode; counted and timed
    torch.cuda.synchronize()
    zero_counts(counters)
    tw = time.perf_counter()
    cond = encode()
    torch.cuda.synchronize()
    t_encode = time.perf_counter() - tw
    tw = time.perf_counter()
    lat = pipe(noises=noise, num_steps=SD3_STEPS, decode=False, **cond)
    torch.cuda.synchronize()
    t_sample = time.perf_counter() - tw
    tw = time.perf_counter()
    with torch.no_grad():
        img = vae.decode(vae.unscale_latents(lat))
    torch.cuda.synchronize()
    t_decode = time.perf_counter() - tw
    launches = read_counts(counters)
    expect = {"fused_weighted_sum": SD3_STEPS,
              "flash_attention": SD3_STEPS * cfg.depth, "matmul_wdq": 0}
    if launches != expect:
        raise AssertionError(f"sd3: launches {launches} != {expect}")
    if tuple(img.shape) != (1, 8 * hw, 8 * hw, 3) or not (
            torch.isfinite(img).all() and torch.isfinite(lat).all()):
        raise AssertionError(f"sd3: image {tuple(img.shape)} non-finite or "
                             f"misshapen")
    wall = t_encode + t_sample + t_decode

    # the CFG forward of (2) profiled SD3_PROFILED times over
    with torch.no_grad():
        wall_ms, kern = device_profile(torch, lambda: [
            fwd(z16, t_all[0], step) for _ in range(SD3_PROFILED)])
    dev_ms = sum(ms for _, ms in kern.values()) / SD3_PROFILED
    k9_ms = sum(ms for name, (_, ms) in kern.items()
                if "flash_ring_kernel" in name) / SD3_PROFILED
    fwd_wall_ms = t_sample / SD3_STEPS * 1e3
    prof = dict(device_ms_per_fwd=dev_ms, wall_ms_per_fwd=fwd_wall_ms,
                busy_share=dev_ms / fwd_wall_ms, k9_ms_per_fwd=k9_ms,
                k9_share_of_fwd=k9_ms / dev_ms if dev_ms else None,
                profiled_wall_ms=wall_ms / SD3_PROFILED,
                top=top_kernels(kern))

    # (4) w8: every latent-stream QDense on K7 (the context stream's 666
    # rows fail qmatmul_ok, as in JAX); the warm-up forward quantizes the
    # weights and gives K7's check at each latent-stream shape its inputs
    mm16.set_quant("w8")
    k7 = sd3_k7_in_model(torch, mm16, lambda: fwd(z16, t_all[0], step),
                         timer)
    torch.cuda.synchronize()
    zero_counts(counters)
    tw = time.perf_counter()
    lat_w8 = ni(pipe, cond)
    torch.cuda.synchronize()
    t_w8 = time.perf_counter() - tw
    launches_w8 = read_counts(counters)
    mm16.set_quant(None)
    expect_w8 = {"fused_weighted_sum": SD3_ACC_STEPS,
                 "flash_attention": SD3_ACC_STEPS * cfg.depth,
                 "matmul_wdq": SD3_ACC_STEPS * 6 * cfg.depth}
    if launches_w8 != expect_w8 or not torch.isfinite(lat_w8).all():
        raise AssertionError(f"sd3 w8: launches {launches_w8} != "
                             f"{expect_w8} or non-finite")
    w8 = dict(steps=SD3_ACC_STEPS, wall_s=t_w8, launches=launches_w8,
              reading_rel_l2_vs_f32_plain=rel_l2(lat_w8, want),
              k7_in_model=k7)

    details["sd3"] = dict(profile=prof, k9_in_model=k9, forward=fwd_check,
                          ni=ni_check, w8=w8)
    bad = []
    if not fwd_check["f32_rel_l2"] <= SD3_FORWARD_TOL:
        bad.append("f32 forward")
    for what, r in (("bf16 forward", fwd_check), ("bf16 NI", ni_check)):
        if not (r["bf16_rel_l2"] <= r["bf16_limit"]
                < r["control_time_1pct_off_rel_l2"]):
            bad.append(what)
    phase("sd3", t0, card=smi, steps=SD3_STEPS, latent=hw, image=8 * hw,
          context_tokens=t_ctx, wall_s=wall, sec_per_image=wall,
          seconds=dict(build=t_build, encode=t_encode, sample=t_sample,
                       decode=t_decode),
          cfg_forward_ms=fwd_wall_ms, launches=launches, profile=prof,
          k9_in_model={f: k9[f] for f in ("shape", "ms", "plain_ms",
                                          "library_ms", "bound_ms",
                                          "max_abs_err", "tflops")},
          forward=fwd_check, ni=ni_check, w8=w8,
          control_factor=SD3_CONTROL_FACTOR,
          params=dict(mmdit=sum(p.numel() for p in mm16.parameters()),
                      **{k: sum(p.numel() for p in m.parameters())
                         for k, m in dict(enc, vae=vae).items()}),
          peak_gb=torch.cuda.max_memory_allocated() / 2 ** 30)
    if bad:
        raise AssertionError(f"sd3: {bad} outside their limits: "
                             f"{fwd_check} {ni_check}")
    del pipe, mm16, enc, vae, lat, img, lat_w8
    torch.cuda.empty_cache()
    return launches, launches_w8, k9, k7


# ------------------------------------------------------------ tooling path

def check_abs(what, got, want, atol):
    """max |got - want| <= atol; returns it."""
    import torch
    err = float((got.float() - want.float()).abs().max())
    if not torch.isfinite(got.float()).all() or err > atol:
        raise AssertionError(f"{what}: max abs err {err:.3e} over {atol:g}")
    return err


def attn_cost(b, h, t, d, itemsize):
    flops = 4.0 * b * h * t * t * d
    nbytes = 4.0 * b * h * t * d * itemsize            # q, k, v, o
    bound = max(flops / PEAK_FLOPS["torch.bfloat16"],
                nbytes / HBM_BYTES_PER_S)
    return flops, nbytes, bound * 1e3, ("operations" if flops / PEAK_FLOPS[
        "torch.bfloat16"] >= nbytes / HBM_BYTES_PER_S else "bytes")


def phase_tool_kernels(details, child):
    """K10 and ``mha_joint`` at SD3's lengths, K8 at the level-0
    activations: checked, then timed in bf16, and K9 and K10 timed at each
    of SD3's joint lengths.  Returns the kernels' rows, K8's path counts
    and the times by length."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel
    from naturaldiffusion_tpu_torch.ops import attention as A
    from naturaldiffusion_tpu_torch.ops import fused_act as FA

    t0 = time.perf_counter()
    timer = Timer(torch)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 31)
    b, h, d = SD3_B, SD3_H, SD3_D
    t_sd3 = SD3_LAT + SD3_CTX
    scale = 1.0 / math.sqrt(d)

    def rn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    def sdpa(q, k, v, sc):
        with sdpa_kernel(SDPBackend.FLASH_ATTENTION):
            return F.scaled_dot_product_attention(q, k, v, scale=sc)

    # K10 against its plain version, output and logsumexp
    k10 = {}
    for t in SD3_LENGTHS:
        for dtype, tol in ((torch.float32, F32_TOL),
                           (torch.bfloat16, BF16_TOL)):
            q, k, v = (rn(b, h, t, d).to(dtype) for _ in range(3))
            got, lse = A.splash_attention(q, k, v, scale, save_residuals=True)
            want, lse_want = A.splash_reference(A.prescale(q, scale), k, v,
                                                save_residuals=True)
            key = f"t{t}_{str(dtype).split('.')[-1]}"
            row = dict(zip(("max_abs_err", "max_rel_err"), check_close(
                f"K10 splash {key}", got, want, tol)))
            if dtype == torch.float32:
                row["max_abs_err"] = check_abs(f"K10 splash {key}", got,
                                               want, F32_TOL)
                row["lse_err"] = check_abs(f"K10 lse {key}", lse, lse_want,
                                           LSE_TOL)
            else:
                row["lse_err"] = check_close(f"K10 lse {key}", lse,
                                             lse_want, F32_TOL)[0]
            # the entry without the logsumexp runs the other instance
            plain_out = A.splash_attention(q, k, v, scale)
            row["no_lse_err"] = check_close(f"K10 splash {key} without lse",
                                            plain_out, want, tol)[0]
            row["no_lse_equal"] = bool(torch.equal(plain_out, got))
            k10[key] = row
    del q, k, v, got, want, lse, lse_want, plain_out

    # mha_joint at SD3's split against one softmax per row (f32 and bf16),
    # then timed against mha through K9, which masks past t by index
    joint = {}
    for dtype, tol in ((torch.float32, JOINT_F32_TOL),
                       (torch.bfloat16, JOINT_BF16_TOL)):
        q, k, v = (rn(b, h, t_sd3, d).to(dtype) for _ in range(3))
        A.splash_attention.launches = 0
        got = A.mha_joint(q, k, v, split=SD3_LAT)
        if A.splash_attention.launches != 1:
            raise AssertionError("mha_joint did not launch K10 once")
        err = rel_l2(got, A.mha_reference(q, k, v, scale))
        if not torch.isfinite(got).all() or err > tol:
            raise AssertionError(f"mha_joint {dtype}: rel L2 {err:.3e} > "
                                 f"{tol:g}")
        joint[str(dtype).split(".")[-1]] = dict(rel_l2=err, tol=tol)
    joint["timing_bf16"] = dict(
        mha_joint_ms=timer(lambda: A.mha_joint(q, k, v, split=SD3_LAT)),
        mha_flash_ms=timer(lambda: A.mha(q, k, v)),
        mha_splash_ms=timer(lambda: A.mha(q, k, v, backend="splash")))
    jt = joint["timing_bf16"]
    jt["faster"] = min(("mha_joint", "mha_flash", "mha_splash"),
                       key=lambda n: jt[f"{n}_ms"])
    # where mha_joint's time goes: device time by kernel of one call, in a
    # fresh process (see profile_joint_in_child), which must list K10
    prof = profile_joint_in_child(child)
    jt["profiled_device_ms"] = prof["device_ms"]
    jt["profiled_kernels"] = prof["kernels"]
    jt["profiled_top"] = prof["top"]
    jt["profiled_k10_ms"] = prof["k10_ms"]
    if not prof["k10_ms"]:
        raise AssertionError(f"the profile of mha_joint lists no K10 "
                             f"launch: {prof['top']}")
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as here:
        A.mha_joint(q, k, v, split=SD3_LAT)
        torch.cuda.synchronize()
    jt["in_process_profile"] = kernel_summary(sorted(
        (e for e in here.key_averages()
         if str(e.device_type).endswith("CUDA")
         and e.self_device_time_total > 0),
        key=lambda e: -e.self_device_time_total))
    print(f"  mha_joint profiled in a fresh process: {prof['kernels']} "
          f"kernels, {prof['device_ms']:.3f} ms, K10 {prof['k10_ms']:.3f} "
          f"ms; in this process: {jt['in_process_profile']['kernels']} "
          f"kernels, {jt['in_process_profile']['device_ms']:.3f} ms, K10 "
          f"{jt['in_process_profile']['k10_ms']:.3f} ms", flush=True)

    # K10 timed at SD3's length in bf16 (q, k, v from above); K9 is checked
    # and timed at SD3's length on the model's own q, k, v (phase sd3)
    qs = A.prescale(q, scale)
    flops, nbytes, bound, bound_by = attn_cost(b, h, t_sd3, d, 2)
    k10_time = dict(
        ms=timer(lambda: A._splash(qs, k, v, False)),
        wrapper_ms=timer(lambda: A.splash_attention(q, k, v, scale)),
        plain_ms=timer(lambda: A.splash_reference(qs, k, v)),
        library_ms=timer(lambda: sdpa(qs, k, v, 1.0)),
        bound_ms=bound, bound_by=bound_by, flops=flops, bytes=nbytes)
    k10_time["tflops"] = flops / k10_time["ms"] / 1e9
    del q, k, v, qs, got
    # K9 and K10 (with and without the logsumexp) at each of SD3's joint
    # lengths beside SDPA's flash backend, bf16
    by_length = {}
    for t in SD3_LENGTHS:
        q, k, v = (rn(b, h, t, d).to(torch.bfloat16) for _ in range(3))
        qs = A.prescale(q, scale)
        fl, nb, bd, bb = attn_cost(b, h, t, d, 2)
        r = dict(flash_ms=timer(lambda: A.flash_attention(q, k, v, scale)),
                 splash_ms=timer(lambda: A._splash(qs, k, v, False)),
                 splash_lse_ms=timer(lambda: A._splash(qs, k, v, True)),
                 sdpa_flash_ms=timer(lambda: sdpa(q, k, v, scale)),
                 bound_ms=bd, bound_by=bb, flops=fl,
                 plan=A._attn_plan(b, h, t, d, torch.bfloat16)["warps"])
        for f in ("flash", "splash", "splash_lse"):
            r[f"{f}_tflops"] = fl / r[f"{f}_ms"] / 1e9
            r[f"{f}_vs_sdpa"] = r[f"{f}_ms"] / r["sdpa_flash_ms"]
        by_length[t] = r
        print(f"  attention [{b}, {h}, {t}, {d}] bf16 ({r['plan']} warps a "
              f"block): flash {r['flash_ms']:.4f} ms "
              f"({r['flash_tflops']:.1f} TFLOP/s, "
              f"{r['flash_vs_sdpa']:.2f}x SDPA), splash "
              f"{r['splash_ms']:.4f}, splash with lse "
              f"{r['splash_lse_ms']:.4f}, SDPA flash "
              f"{r['sdpa_flash_ms']:.4f}, bound {r['bound_ms']:.4f} "
              f"({r['bound_by']})", flush=True)
    del q, k, v, qs

    # K8: the path (the wrapper at the two level-0 activations), counted
    FA.fused_leaky_relu_pallas.launches = 0
    for shape in K8_PATH_SHAPES:
        x = rn(*shape).to(torch.bfloat16)
        FA.fused_leaky_relu_pallas(x, (0.1 * rn(shape[-1])).to(x.dtype))
    torch.cuda.synchronize()
    k8_count = {"fused_leaky_relu_pallas":
                FA.fused_leaky_relu_pallas.launches}
    if k8_count["fused_leaky_relu_pallas"] != len(K8_PATH_SHAPES):
        raise AssertionError(f"K8 path launches {k8_count}")
    # then bit for bit against the plain version, and timed on the path's
    # shapes in bf16
    k8 = {}
    for shape in K8_CHECK_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            x = (3.0 * rn(*shape)).to(dtype)
            bias = rn(shape[-1]).to(dtype)
            got = FA.fused_leaky_relu_pallas(x, bias)
            want = FA.fused_leaky_relu(x, bias)
            key = f"{list(shape)}_{str(dtype).split('.')[-1]}"
            if got.dtype != dtype or not torch.equal(got, want):
                n = int((got != want).sum())
                raise AssertionError(f"K8 {key}: {n} elements differ from "
                                     f"the plain version")
            row = dict(bit_exact=True)
            if shape in K8_PATH_SHAPES and dtype == torch.bfloat16:
                nb = 2 * 2 * x.numel() + 2 * shape[-1]
                row.update(
                    ms=timer(lambda: FA.fused_leaky_relu_pallas(x, bias)),
                    plain_ms=timer(lambda: FA.fused_leaky_relu(x, bias)),
                    bytes=nb, bound_ms=nb / HBM_BYTES_PER_S * 1e3)
                row["gb_per_s"] = nb / row["ms"] / 1e6
                row["bound_share"] = row["bound_ms"] / row["ms"]
            k8[key] = row
    k8_timed = [r for r in k8.values() if "ms" in r]

    details["tool_kernels"] = dict(splash=k10, splash_time=k10_time,
                                   mha_joint=joint, fused_act=k8,
                                   attention_by_length=by_length)
    out = [
        dict(name="splash_attention", route="cuda",
             source="naturaldiffusion_tpu_torch/csrc/attention.cu",
             replaces="naturaldiffusion_tpu/ops/attention.py:66",
             also_replaces="naturaldiffusion_tpu/ops/attention.py:146",
             max_abs_err=max(r["max_abs_err"] for r in k10.values()),
             max_rel_err=max(r["max_rel_err"] for r in k10.values()),
             lse_max_abs_err=max(r["lse_err"] for r in k10.values()),
             **{f: k10_time[f] for f in ("ms", "plain_ms", "bound_ms",
                                         "bound_by", "library_ms")},
             note=f"per launch at [{b}, {h}, {t_sd3}, {d}] bf16; library: "
                  f"SDPA flash on the pre-scaled q, scale 1"),
        dict(name="fused_leaky_relu", route="cuda",
             source="naturaldiffusion_tpu_torch/csrc/fused_act.cu",
             replaces="naturaldiffusion_tpu/ops/fused_act.py:52",
             max_abs_err=0.0, max_rel_err=0.0,
             **{f: sum(r[f] for r in k8_timed)
                for f in ("ms", "plain_ms", "bound_ms")},
             bound_by="bytes", library_ms=None,
             note="sum over the fused_act path's two bf16 calls; no single "
                  "PyTorch call computes scale * leaky_relu(x + bias)"),
    ]
    for key, r in k8.items():
        if "ms" in r:
            print(f"  fused_leaky_relu {key}: {r['ms']:.4f} ms "
                  f"({r['gb_per_s']:.0f} GB/s, {100 * r['bound_share']:.1f}% "
                  f"of bound), plain {r['plain_ms']:.4f}, bound "
                  f"{r['bound_ms']:.4f}", flush=True)
    r = k10_time
    print(f"  splash_attention [{b}, {h}, {t_sd3}, {d}] bf16: {r['ms']:.4f} "
          f"ms ({r['tflops']:.1f} TFLOP/s), plain {r['plain_ms']:.4f}, SDPA "
          f"flash {r['library_ms']:.4f}, bound {r['bound_ms']:.4f}",
          flush=True)
    phase("tool_kernels", t0,
          checks={"splash_attention": len(k10), "mha_joint": 2,
                  "fused_leaky_relu": len(k8)},
          tolerances=dict(f32=F32_TOL, bf16=BF16_TOL, lse=LSE_TOL,
                          joint_f32=JOINT_F32_TOL,
                          joint_bf16=JOINT_BF16_TOL, fused_act="bit-exact"),
          splash=k10, mha_joint=joint,
          splash_attention_per_launch={f: k10_time[f] for f in (
              "ms", "wrapper_ms", "plain_ms", "library_ms", "bound_ms",
              "tflops")},
          attention_by_length={t: {f: round(v, 5) for f, v in r.items()
                                   if f.endswith("_ms")}
                               for t, r in by_length.items()},
          fused_act_path_launches=k8_count)
    return out, k8_count, by_length


# One mha_joint call at SD3's length in bf16, profiled, its device time by
# kernel printed as JSON.  torch.profiler in torch 2.11 + CUDA 12.8 loses
# device records at the start of a short window late in a long process,
# whichever library launched the kernels: in this script's process, some
# 200 s old, the same profile lists fewer kernels and no K10 (the first
# launch), which a fresh process lists; so the call is profiled in a fresh
# process, and the in-process profile is kept beside it for the record
_JOINT_PROFILE = f"""
import json, math, sys, torch
from torch.profiler import ProfilerActivity, profile, schedule
from chip_smoke import kernel_summary
from naturaldiffusion_tpu_torch.ops import attention as A
torch.zeros(1, device="cuda")
if sys.stdin.readline() != "warm\\n":  # the parent has gone
    sys.exit(0)
# a process's first profiler session sets the profiler up (seconds of host
# time), paid here while the parent's phases run
with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
    torch.ones(8, device="cuda").sum().item()
if not sys.stdin.readline():          # the parent has gone
    sys.exit(0)
gen = torch.Generator(device="cuda").manual_seed({SEED} + 32)
q, k, v = (torch.randn(({SD3_B}, {SD3_H}, {SD3_LAT + SD3_CTX}, {SD3_D}),
                       generator=gen, device="cuda").bfloat16()
           for _ in range(3))
A.mha_joint(q, k, v, split={SD3_LAT})
torch.cuda.synchronize()
# a second session can lose the device records at the start of its window:
# the profiler's warm-up step takes them and is dropped, the active step
# is the one call reported
ready = []
with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
             schedule=schedule(wait=0, warmup=1, active=1),
             on_trace_ready=lambda p: ready.append(p.key_averages())) as prof:
    for _ in range(2):
        A.mha_joint(q, k, v, split={SD3_LAT})
        torch.cuda.synchronize()
        prof.step()
kern = sorted((e for e in ready[-1]
               if str(e.device_type).endswith("CUDA")
               and e.self_device_time_total > 0
               and not e.key.startswith("ProfilerStep")),
              key=lambda e: -e.self_device_time_total)
print(json.dumps(kernel_summary(kern)))
"""


def kernel_summary(kern):
    """Device ms, kernel count, K10's ms and the top 8 of a profile's
    device events (``key_averages`` rows, longest first)."""
    k10 = [e for e in kern if "flash_ring_kernel<64, true" in e.key]
    return dict(
        device_ms=sum(e.self_device_time_total for e in kern) / 1e3,
        kernels=sum(e.count for e in kern),
        k10_ms=sum(e.self_device_time_total for e in k10) / 1e3,
        top=[(e.key[:60], e.count, e.self_device_time_total / 1e3)
             for e in kern[:8]])


def start_joint_profile():
    """The child process of :func:`profile_joint_in_child`, started two
    phases ahead: it imports torch, the profiler and the attention module
    and sets up the card, then waits for a line on its stdin; told
    ``warm`` (by :func:`warm_joint_profile`) it runs the profiler's first
    session, a tiny one, and waits again, so its set-up (seconds of host
    time) runs beside the other phases."""
    root = os.path.dirname(os.path.abspath(__file__))
    env = {k: v for k, v in os.environ.items() if k != "TEARDOWN_CUPTI"}
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (root, os.environ.get("PYTHONPATH")) if p)
    return subprocess.Popen([sys.executable, "-c", _JOINT_PROFILE],
                            cwd=root, env=env, stdin=subprocess.PIPE,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


def warm_joint_profile(child):
    child.stdin.write("warm\n")
    child.stdin.flush()


def stop_process(proc):
    if proc.poll() is None:
        proc.kill()
        proc.wait()


def profile_joint_in_child(child):
    """Device time by kernel of one ``mha_joint`` call, profiled in a fresh
    process (late in a long process the profiler drops device records at
    the start of a short window): ``child`` from :func:`start_joint_profile`
    runs it when told."""
    try:
        out, err = child.communicate("go\n", timeout=180)
    except subprocess.TimeoutExpired:
        child.kill()
        child.communicate()
        raise
    if child.returncode != 0:
        raise AssertionError(f"mha_joint profile: {err[-2000:]}")
    return json.loads(out.strip().splitlines()[-1])


def phase_attention_bench():
    """``apps.bench_attention`` at its defaults, the path of K10; the K9
    and K10 counters read around it."""
    import contextlib as cl
    import io
    from naturaldiffusion_tpu_torch.apps import bench_attention
    from naturaldiffusion_tpu_torch.ops import attention as A

    t0 = time.perf_counter()
    counters = {"splash_attention": A.splash_attention,
                "flash_attention": A.flash_attention}
    zero_counts(counters)
    buf = io.StringIO()
    with cl.redirect_stdout(buf):
        rc = bench_attention.main([])
    counts = read_counts(counters)
    rows = [json.loads(ln) for ln in buf.getvalue().splitlines()]
    for ln in buf.getvalue().splitlines():
        print("  " + ln, flush=True)
    # per length and backend: a warm-up chain and 3 timed chains of 20
    # calls, and one finite check
    per = 3 * (4 * 20 + 1)
    if rc != 0 or [r["t"] for r in rows] != [4096, 4250, 4429] or counts != {
            "splash_attention": per, "flash_attention": per}:
        raise AssertionError(f"attention_bench: rc {rc}, launches {counts}")
    phase("attention_bench", t0, rows=rows, launches=counts)
    return counts, rows


# the FLOP count that ``bench_dit --toy --count-flops`` (tool_trace) asks
# of a CPU subprocess, started beside the build: (module, its argv)
TOOL_TRACE_COUNT = ("naturaldiffusion_tpu_torch.apps.bench_dit",
                    ("--model", "DiT-XL/2", "--batch", "1", "--cfg-scale",
                     "4.0", "--toy"))


@contextlib.contextmanager
def count_started_early(module, key, early):
    """Within the block, ``module.flops_via_cpu_subprocess`` answers the
    call ``key`` (module, argv) with the result of ``early``, the future of
    the same call started earlier; any other call runs as before."""
    saved = module.flops_via_cpu_subprocess

    def answer(mod, argv):
        if (mod, tuple(argv)) == key:
            return early.result()
        return saved(mod, argv)
    module.flops_via_cpu_subprocess = answer
    try:
        yield
    finally:
        module.flops_via_cpu_subprocess = saved


def warm_profiler(torch):
    """One short ``torch.profiler`` session on the card: a process's first
    session sets the profiler up, seconds of host time (~9 s on the H100's
    host) that the slice phase's profile would otherwise pay."""
    from torch.profiler import ProfilerActivity, profile
    x = torch.ones(1024, device="cuda")
    with profile(activities=[ProfilerActivity.CUDA]):
        (x * 2).sum().item()


def phase_tool_trace(dit_count):
    """``bench_dit --toy --trace --count-flops`` on the card (its CPU count
    ``dit_count``, the future of ``TOOL_TRACE_COUNT`` started beside the
    build) and the trace summary of its trace; ``bench_conv --shapes 1``."""
    import contextlib as cl
    import io
    import shutil
    import tempfile
    from naturaldiffusion_tpu_torch.apps import bench_conv, bench_dit
    from naturaldiffusion_tpu_torch.utils import trace_summary

    t0 = time.perf_counter()
    logdir = tempfile.mkdtemp(prefix="natdiff_trace_")
    try:
        buf = io.StringIO()
        with cl.redirect_stdout(buf), count_started_early(
                bench_dit, TOOL_TRACE_COUNT, dit_count):
            rc = bench_dit.main(["--toy", "--steps", "10", "--trace",
                                 logdir, "--count-flops"])
        dit = json.loads(buf.getvalue().splitlines()[-1])
        total_us, fam = trace_summary.summarize(logdir)
        buf = io.StringIO()
        with cl.redirect_stdout(buf):
            trace_summary.main([logdir, "--top", "6"])
        summary = buf.getvalue().splitlines()
    finally:
        shutil.rmtree(logdir, ignore_errors=True)
    # K9's kernel families: the bf16 ring loop and the f32 split loop
    k9_fams = sorted({"flash_ring_kernel", "flash_split_kernel"} & set(fam))
    if rc != 0 or total_us <= 0 or not k9_fams:
        raise AssertionError(f"tool_trace: rc {rc}, device total "
                             f"{total_us} us, families {sorted(fam)}")
    if dit["flops_source"] != "counted" or dit["flops_per_fwd"] != (
            bench_dit.flops_per_forward(bench_dit.TOY, 1, True)):
        raise AssertionError(f"tool_trace: counted FLOPs {dit}")
    for ln in summary:
        print("  " + ln, flush=True)
    buf = io.StringIO()
    with cl.redirect_stdout(buf):
        rc = bench_conv.main(["--shapes", "1"])
    conv = json.loads(buf.getvalue().splitlines()[-1])
    print("  " + json.dumps(conv), flush=True)
    if rc != 0 or conv["best_variant"] not in conv["serves"]:
        raise AssertionError(f"bench_conv: rc {rc}, {conv}")
    phase("tool_trace", t0, bench_dit_toy=dit, device_total_us=total_us,
          families=len(fam),
          flash_kernel_us=sum(fam[f] for f in k9_fams),
          bench_conv=conv)
    return dit, conv


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None,
                    help="also write every per-shape number to this JSON file")
    args = ap.parse_args(argv)

    root = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(root, "naturaldiffusion_tpu_torch")):
        print("chip_smoke: run it from a checkout of the repository",
              file=sys.stderr)
        return 2
    sys.path.insert(0, root)
    # nvcc and the CPU oracles' child process start before torch's import
    # (seconds of one core)
    early = EarlyBuild()
    oracles = Oracles()
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        oracles.stop()
        return 2
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    # inference everywhere but the train phase, which turns grad mode on
    # where it differentiates: the kernels' autograd Functions stay off the
    # inference paths (grad mode is per thread: a pool thread that runs a
    # model sets its own)
    torch.set_grad_enabled(False)

    from naturaldiffusion_tpu_torch.models.ncsnpp import (
        CIFAR10_DDPMPP_CONTINUOUS, NCSNpp)

    smi = phase_env()
    # the port bench's FLOPs and tool_trace's count, on the CPU, and the
    # profiler's first session (seconds of set-up), while the kernels build
    from naturaldiffusion_tpu_torch.utils.flops import flops_via_cpu_subprocess
    # (at a lower CPU priority than the build and this process's phases;
    # each count is read where it is needed)
    pool = concurrent.futures.ThreadPoolExecutor(4)
    counting = pool.submit(flops_via_cpu_subprocess,
                           "naturaldiffusion_tpu_torch.apps.bench", [], 10)
    # DTensor's package (seconds of import on this host), which the meshes
    # of the train, eval and parallel phases load
    pool.submit(importlib.import_module, "torch.distributed.tensor")
    dit_count = pool.submit(flops_via_cpu_subprocess, TOOL_TRACE_COUNT[0],
                            list(TOOL_TRACE_COUNT[1]), 10)
    building = pool.submit(phase_build, early)
    # a profiler session leaves CUPTI's per-launch cost behind unless CUPTI
    # is torn down at its end (one A/B on one host: the phases after the
    # build ~7 % faster with it); set before the first session, and kept
    # from tool_kernels' profiling child (it timed out under it)
    os.environ["TEARDOWN_CUPTI"] = "1"
    warm_profiler(torch)
    building.result()
    # the train phase's FLOPs a step (bench_train on the CPU), counted while
    # the card runs the phases before it
    train_count = pool.submit(flops_via_cpu_subprocess,
                              "naturaldiffusion_tpu_torch.apps.bench_train",
                              list(BENCH_TRAIN_ARGS[:2]), 10)
    pool.shutdown(wait=False)
    model = randomize_(NCSNpp(CIFAR10_DDPMPP_CONTINUOUS, device="cpu"),
                       SEED).eval()
    details = {}
    model_bf16 = copy.deepcopy(model).to(device="cuda", dtype=torch.bfloat16)
    kernels, n_plain, n_gn, n_k6 = phase_kernels(model_bf16, details)
    int8_entry, n_int8 = phase_int8_kernels(model_bf16, details)
    kernels.append(int8_entry)
    quant_ops_launches, quant_ops_lines = phase_quant_ops(smi)
    routes = phase_routes(model_bf16, model, n_plain, n_gn, n_int8)
    del model_bf16
    phase_forward(model, oracles)
    launches, ips = phase_slice(model, n_plain, n_gn, n_k6, smi, oracles)
    sampler_launches = phase_samplers(model, n_plain, n_gn, n_k6, smi)
    eval_launches = phase_eval(model, n_plain, n_gn, n_k6, smi, oracles)
    train_launches, train_bench_rows, train_dir = phase_train(model, smi,
                                                              train_count)
    del model
    oracles.submit("likelihood")        # in the oracle process, beside:
    entry_launches = phase_entry_points(train_dir, oracles, n_plain, n_gn,
                                        n_k6, smi)
    lik_launches = phase_likelihood(oracles, smi)
    bench_flops = int(counting.result())
    bench_launches, bench_traced, bench_lines = phase_bench(
        n_plain, n_gn, n_k6, bench_flops)
    int8_launches, int8_traced, form_lines = phase_bench_forms(
        bench_flops, n_plain, n_gn, n_int8)

    from naturaldiffusion_tpu_torch.models.dit import DIT_CONFIGS, DiT
    dit32 = randomize_dit_(DiT(DIT_CONFIGS[DIT_MODEL], device="cuda"),
                           SEED + 10).eval()
    kernels += phase_dit_kernels(details)
    phase_dit_forward(dit32, oracles)
    dit_runs = phase_dit_slice(dit32, smi)
    del dit32
    phase_dit_validate()
    par_kernels, par_launches = phase_parallel(smi, details)
    kernels += par_kernels

    ve_cfg, ve32 = ve_model(SEED + 20)
    ve16 = copy.deepcopy(ve32).to(device="cuda", dtype=torch.bfloat16)
    ve_kernels, ve_sigs = phase_ve_kernels(ve16, details)
    kernels += ve_kernels
    del ve16
    phase_ve_forward(ve32, oracles)
    ve_launches = phase_ve_slice(ve_cfg, ve32, ve_sigs, smi)
    del ve32
    # tool_kernels' profiling child, started and warmed beside the
    # backbones and sd3 phases (a child left idle for minutes after its
    # first profiler session lost the device records of its second, as
    # late sessions in this process do), stopped at exit
    child = start_joint_profile()
    atexit.register(stop_process, child)
    warm_joint_profile(child)
    backbone_launches = phase_backbones(smi, details, oracles)
    sd3_launches, sd3_w8_launches, k9_sd3, k7_sd3 = phase_sd3(smi,
                                                               details)

    tool_kernels, k8_launches, by_length = phase_tool_kernels(details, child)
    kernels += tool_kernels
    attn_launches, attn_rows = phase_attention_bench()
    dit_toy, conv_row = phase_tool_trace(dit_count)
    conv_model = phase_conv_model()
    for k in kernels:
        if k["name"] == "flash_attention":
            # K9 at SD3-medium's joint attention: on the model's own q, k,
            # v (phase sd3), and standalone beside SDPA (tool_kernels)
            k["sd3_length"] = dict(
                {f: k9_sd3[f] for f in ("shape", "ms", "plain_ms",
                                        "library_ms", "bound_ms")},
                standalone_ms=by_length[SD3_LAT + 333]["flash_ms"])
        if k["name"] == "qmatmul":
            # K7 at SD3-medium's latent-stream shapes (phase sd3)
            k["sd3_shapes"] = {key: {f: r[f] for f in (
                "ms", "plain_ms", "library_ms", "bound_ms", "max_abs_err_bf16",
                "max_abs_err_f32")} for key, r in k7_sd3.items()}
            k["max_abs_err"] = max([k["max_abs_err"]] + [
                r[f] for r in k7_sd3.values()
                for f in ("max_abs_err_bf16", "max_abs_err_f32")])

    by_path = {"cifar_slice": launches,
               "bench": bench_launches,
               "bench_int8": int8_launches,
               "dit_slice": dit_runs["float"]["launches"],
               "dit_slice_w8": dit_runs["w8"]["launches"],
               "ve_slice": ve_launches,
               "backbones": backbone_launches,
               "sd3_slice": sd3_launches,
               "sd3_slice_w8": sd3_w8_launches,
               "samplers": sampler_launches,
               "likelihood": lik_launches,
               "eval": eval_launches,
               "train": train_launches,
               "bench_quant_ops": quant_ops_launches,
               **entry_launches,
               "attention_bench": attn_launches,
               "fused_act": k8_launches, **par_launches}
    # each kernel's count from the path that exercises it: K1-K3 the
    # CIFAR slice, K9 the DiT slice, K7 the DiT slice under w8 (each also
    # on the SD3 slice, launches_by_path), K4 (serving
    # K5) and K6 the VE slice, K10 the attention bench, K8 its own path, the
    # int8 conv the bench in its default form (bench.py's, unfused int8)
    main_path = {"weighted_sum": ("cifar_slice", "fused_weighted_sum"),
                 "conv3x3_int8": ("bench_int8", "conv3x3_int8"),
                 "conv3x3": ("cifar_slice", "conv3x3"),
                 "conv3x3_gn": ("cifar_slice", "conv3x3_gn"),
                 "flash_attention": ("dit_slice", "flash_attention"),
                 "qmatmul": ("dit_slice_w8", "matmul_wdq"),
                 "conv3x3_tiled": ("ve_slice", "conv3x3_tiled"),
                 "conv3x3_tiledew": ("ve_slice", "conv3x3_tiled"),
                 "group_norm": ("ve_slice", "fused_group_norm"),
                 "splash_attention": ("attention_bench", "splash_attention"),
                 "flash_attention_backward": ("parallel",
                                              "flash_attention_backward"),
                 "splash_attention_backward": ("parallel_splash",
                                               "splash_attention_backward"),
                 "fused_leaky_relu": ("fused_act", "fused_leaky_relu_pallas")}
    for k in kernels:
        path, fn = main_path[k["name"]]
        k["launches"] = by_path[path][fn]
        k["launches_by_path"] = {p: c[fn] for p, c in by_path.items()
                                 if c.get(fn)}
        traced = int8_traced if path == "bench_int8" else bench_traced
        if traced.get(fn):
            k["bench_trace_launches"] = dict(
                replays=BENCH_CHUNKS_TRACED, launches=traced[fn])
        if not k["launches"]:
            raise AssertionError(f"{k['name']} was not launched on {path}")
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
            "launches_by_path")
    extras = ("also_replaces", "served_by", "head_dims_checked",
              "bench_trace_launches", "library_int_mm_ms", "ms_dynamic",
              "lse_max_abs_err", "sd3_length", "fwd_bwd_ms",
              "library_fwd_bwd_ms", "note")
    kernels = [dict({k: kern[k] for k in keys},
                    **{k: kern[k] for k in extras if k in kern})
               for kern in kernels]
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(dict(card=smi, img_per_s=ips, dit=dit_runs,
                           bench=bench_lines, bench_forms=form_lines,
                           routes=routes, bench_conv_model=conv_model,
                           bench_train=train_bench_rows,
                           bench_quant_ops=quant_ops_lines,
                           attention_bench=attn_rows, bench_dit_toy=dit_toy,
                           bench_conv=conv_row, kernels=kernels,
                           details=details), fh, indent=1)
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
