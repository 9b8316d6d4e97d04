"""The port's sampler apps against the JAX package's on the CPU:
``analyze``'s npz and CSV, ``sweep``'s cell grid and one cell through a
small NCSN++, ``cifar10_ni --ckpt --outdir`` with ``with_params``,
``validate_dit --ckpt``, and the slice as a whole: DPM-Solver++ multistep
and DEIS t-AB over a small VP NCSN++ whose JAX params ``load_jax_params``
carries across, in both packages."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_util  # noqa: F401  binds torch's CPU math first
from naturaldiffusion_tpu.apps import analyze as janalyze
from naturaldiffusion_tpu.apps import sweep as jsweep
from naturaldiffusion_tpu.models.ncsnpp import NCSNpp as JaxNCSNpp
from naturaldiffusion_tpu.models.ncsnpp import NCSNppConfig as JaxConfig
from naturaldiffusion_tpu.samplers import deis as jdeis
from naturaldiffusion_tpu.samplers import dpm_solver as jdpm
from naturaldiffusion_tpu.schedules import LinearVPSDE as JLinearVPSDE
from naturaldiffusion_tpu_torch.apps import (analyze, cifar10_ni, sweep,
                                             validate_dit)
from naturaldiffusion_tpu_torch.coeffs import registry
from naturaldiffusion_tpu_torch.coeffs.matrix import CoeffMatrix
from naturaldiffusion_tpu_torch.models import convert
from naturaldiffusion_tpu_torch.models.convert import load_jax_params
from naturaldiffusion_tpu_torch.models.dit import dit_torch_path_map
from naturaldiffusion_tpu_torch.models.ncsnpp import NCSNpp, NCSNppConfig
from naturaldiffusion_tpu_torch.samplers import deis
from naturaldiffusion_tpu_torch.samplers import dpm_solver as pdpm
from naturaldiffusion_tpu_torch.schedules import LinearVPSDE
from torch_port_util import SMALL, random_flax_params, rel_l2

torch.set_num_threads(2)

# the slice, f32 on both sides: 5 solver steps over an 8-layer NCSN++
# whose forwards agree to ~1e-6; relative L2
SLICE_TOL = 1e-4
# a 32 x 32 NCSN++ small enough for a sweep cell on the CPU
SWEEP_SMALL = dict(nf=32, ch_mult=(1, 2), num_res_blocks=1,
                   attn_resolutions=(16,), image_size=32)


def _torch_layout(model, path_map=convert.ncsnpp_torch_path_map):
    """The model's parameters as a reference-layout torch state dict (the
    inverse of ``fill_from_torch``'s transposes)."""
    root = getattr(model, "layers", model)
    sd = {}
    for name, p in root.named_parameters():
        path = tuple(name.split("."))
        leaf, _ = convert._torch_leaf_and_transform(path)
        a = p.detach().numpy()
        if path[-1] in ("kernel", "weight") and a.ndim == 4:
            a = a.transpose(3, 2, 0, 1)
        elif path[-1] == "kernel":
            a = a.T
        sd[path_map(path[:-1]) + "." + leaf] = torch.from_numpy(
            np.ascontiguousarray(a))
    return sd


@pytest.mark.parametrize("alg", ["ddim", "dpmsolverpp2s"])
def test_analyze_writes_jax_files(tmp_path, alg):
    analyze.analyze(alg, [4, 6], str(tmp_path / "port"), plot=False)
    janalyze.analyze(alg, [4, 6], str(tmp_path / "jax"), plot=False)
    spec = registry.DERIVERS[alg]
    for n in (4, 6):
        base = f"{spec.result_dir}/{spec.prefix}_{n * spec.rows_per_step:03d}"
        got = CoeffMatrix.load(str(tmp_path / "port" / (base + ".npz")))
        want = CoeffMatrix.load(str(tmp_path / "jax" / (base + ".npz")))
        for f in ("x0", "eps", "node"):
            np.testing.assert_allclose(getattr(got, f), getattr(want, f),
                                       atol=1e-12, rtol=0)
        assert (tmp_path / "port" / (base + ".csv")).read_text() == \
            (tmp_path / "jax" / (base + ".csv")).read_text()


def test_analyze_main_plots(tmp_path):
    pytest.importorskip("matplotlib")
    assert analyze.main(["--alg", "ddim", "--steps", "4", "--outdir",
                         str(tmp_path)]) == 0
    assert (tmp_path / "ddim" / "ddim_sympy_004.jpg").stat().st_size > 0


@pytest.mark.parametrize("family,steps", [("deis", 10), ("dpmsolver", 10),
                                          ("dpmsolverpp", 2)])
def test_sweep_cell_grid_equals_jax(monkeypatch, family, steps):
    """The cells JAX's sweep builds, caught before it samples."""
    monkeypatch.setattr(jsweep, "_model", lambda args: None)
    monkeypatch.setattr(jsweep, "_sample_cells",
                        lambda args, cells, build: cells)
    args = jsweep.argparse.Namespace(steps=steps, discrete=False)
    if family == "deis":
        want, got = jsweep.sweep_deis(args), sweep.deis_cells()
    else:
        want = jsweep.sweep_dpmsolver(
            args, "dpmsolver++" if family == "dpmsolverpp" else family)
        got = sweep.dpmsolver_cells(steps)
    assert got == want


@pytest.mark.parametrize("family,only", [("deis", "t:t_ab:3"),
                                         ("dpmsolverpp", "multistep:2")])
def test_sweep_cell_runs_a_small_ncsnpp(tmp_path, family, only):
    """One cell over a small 32 x 32 NCSN++ in bf16 on the CPU: two
    batches of two in micro-batches of one, the JAX app's row fields, the
    CSV."""
    model = NCSNpp(NCSNppConfig(**SWEEP_SMALL), device="cpu", seed=0)
    out = tmp_path / "sweep.csv"
    args = sweep.parse_args(["--family", family, "--only", only, "--steps",
                             "3", "--num", "4", "--batch", "2", "--micro",
                             "1", "--device", "cpu", "--out", str(out)])
    rows = sweep.run(args, model=model)
    assert len(rows) == 1 and rows[0]["finite"] is True
    want_keys = ["weights"] + list(_cell(family, only)) + [
        "img_per_sec", "wall_s", "finite"]
    assert list(rows[0]) == want_keys and rows[0]["weights"] == "random"
    assert rows[0]["img_per_sec"] > 0
    assert out.read_text().splitlines()[0] == ",".join(want_keys)


def _cell(family, only):
    cells = sweep.deis_cells() if family == "deis" \
        else sweep.dpmsolver_cells(3)
    return next(c for c in cells
                if ":".join(str(v) for v in c.values()) == only)


@pytest.fixture(scope="module")
def vp_pair():
    jm = JaxNCSNpp(config=JaxConfig(**SMALL))
    shapes = jax.eval_shape(
        lambda k: jm.init(k, jnp.zeros((1, 8, 8, 3), jnp.float32),
                          jnp.zeros((1,), jnp.float32))["params"],
        jax.random.PRNGKey(0))
    params = random_flax_params(shapes, np.random.default_rng(0))
    tm = load_jax_params(NCSNpp(NCSNppConfig(**SMALL), device="cpu"), params)
    init = np.random.default_rng(1).standard_normal((2, 8, 8, 3)).astype(
        np.float32)
    return jm, params, tm, init


@pytest.mark.parametrize("sampler", ["dpmsolverpp_multistep2", "deis_tab3"])
def test_slice_matches_jax(vp_pair, sampler):
    """5 steps over the small VP NCSN++ (continuous label t * 999, eps
    prediction), f32, in both packages from the same init."""
    jm, params, tm, init = vp_pair
    apply = jax.jit(lambda x, t: jm.apply({"params": params}, x, t))

    def jraw(x, t):
        return apply(x.astype(jnp.float32),
                     jnp.broadcast_to(jnp.asarray(t, jnp.float32) * 999.0,
                                      (x.shape[0],)))

    def praw(x, t):
        with torch.no_grad():
            return tm(x.float(), (t.float() * 999.0).expand(x.shape[0]))

    if sampler.startswith("dpm"):
        nj, np_ = jdpm.NoiseScheduleVP(), pdpm.NoiseScheduleVP()
        kw = dict(steps=5, order=2, method="multistep", t_end=1e-3)
        with jax.enable_x64(False):
            want = np.asarray(jdpm.DPMSolver(
                jdpm.model_wrapper(jraw, nj), nj).sample(
                jnp.asarray(init), **kw))
        got = pdpm.DPMSolver(pdpm.model_wrapper(praw, np_), np_).sample(
            torch.from_numpy(init), **kw)
    else:
        with jax.enable_x64(False):
            want = np.asarray(jdeis.get_sampler_t_ab(
                JLinearVPSDE(), jraw, "t", 2.0, 5, ab_order=3)(
                jnp.asarray(init)))
        got = deis.get_sampler_t_ab(LinearVPSDE(), praw, "t", 2.0, 5,
                                    ab_order=3)(torch.from_numpy(init))
    assert np.isfinite(want).all() and np.abs(want).max() > 0.1
    assert rel_l2(got.numpy(), want) < SLICE_TOL


def test_cifar10_ni_ckpt_outdir_and_with_params(tmp_path, monkeypatch):
    """``main --ckpt --outdir`` over a small model: the converted weights,
    the grid, the samples and meta.json with the JAX app's keys; and
    ``with_params`` re-pointing a sampler at another state in place."""
    cfg = NCSNppConfig(**SWEEP_SMALL)
    src = NCSNpp(cfg, device="cpu", seed=3)
    torch.save({"model": {"module." + k: v for k, v in
                          _torch_layout(src).items()}},
               tmp_path / "ckpt.pth")
    monkeypatch.setattr(cifar10_ni, "CIFAR10_DDPMPP_CONTINUOUS", cfg)
    out = tmp_path / "out"
    assert cifar10_ni.main(["--ckpt", str(tmp_path / "ckpt.pth"), "--num",
                            "4", "--batch", "2", "--steps", "2",
                            "--device", "cpu", "--outdir", str(out)]) == 0
    meta = json.loads((out / "meta.json").read_text())
    assert set(meta) == {"weights", "ckpt", "num", "steps", "seed", "wall_s"}
    assert meta["weights"] == "converted" and meta["num"] == 4
    samples = np.load(out / "samples_converted.npy")
    assert samples.shape == (4, 32, 32, 3) and np.isfinite(samples).all()
    assert (out / "grid_converted.png").stat().st_size > 0

    other = NCSNpp(cfg, device="cpu", seed=4)
    m = registry.derive("ddim", 2)
    init = torch.randn((2, 32, 32, 3),
                       generator=torch.Generator().manual_seed(0))
    want = cifar10_ni.make_sampler(other, m, dtype=torch.float32,
                                   device="cpu")(init)
    run = cifar10_ni.make_sampler(src, m, dtype=torch.float32, device="cpu")
    assert not torch.equal(run(init), want)
    assert torch.equal(run.with_params(other.state_dict())(init), want)
    with pytest.raises(RuntimeError, match="Missing key"):
        run.with_params({"layers.m0.bias": other.layers.m0.bias})


def test_validate_dit_ckpt(tmp_path, capsys):
    """The small DiT of ``--small`` from a DiT release layout
    ``{model, ema}``: every parameter from ``ema``, and the app's check."""
    src = validate_dit.build_model(validate_dit.SMALL, device="cpu", seed=5)
    ema = _torch_layout(src, dit_torch_path_map)
    torch.save({"model": {k: v * 0 for k, v in ema.items()}, "ema": ema},
               tmp_path / "dit.pt")
    model = validate_dit.build_model(validate_dit.SMALL, device="cpu",
                                     seed=6, ckpt=str(tmp_path / "dit.pt"))
    for (name, a), b in zip(model.named_parameters(), src.parameters()):
        assert torch.equal(a, b), name
    assert validate_dit.main(["--small", "--ckpt", str(tmp_path / "dit.pt"),
                              "--steps", "3", "--device", "cpu"]) == 0
    assert "loaded" in capsys.readouterr().out
