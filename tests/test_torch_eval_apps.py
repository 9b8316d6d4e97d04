"""The port's evaluation apps on the CPU: ``fid_selfcheck --toy --device
cpu`` and its artifacts (as ``tests/test_fid_selfcheck_app.py`` checks the
JAX app's), ``NativeBatchLoader`` (against both backends of JAX's) and
``fid_stats`` against the JAX package's on a synthetic CIFAR-binary file
(as ``tests/test_fid_stats.py`` builds one), ``quant_accuracy`` on a small
config, and ``cifar10_ni`` / ``sweep --fid-stats`` against JAX's
``fid_from_samples`` on the same images and statistics."""

import csv
import inspect
import json
import re

import numpy as np
import pytest
import torch

import torch_port_util  # noqa: F401  (binds torch's CPU math first)
from naturaldiffusion_tpu.apps import fid_selfcheck as jax_selfcheck
from naturaldiffusion_tpu.apps import fid_stats as jax_fid_stats
from naturaldiffusion_tpu.apps import quant_accuracy as jax_quant
from naturaldiffusion_tpu.data.native_loader import (NativeBatchLoader as
                                                     JaxLoader)
from naturaldiffusion_tpu.eval import fid as jfid
from naturaldiffusion_tpu_torch.apps import (cifar10_ni, fid_selfcheck,
                                             fid_stats, quant_accuracy, sweep)
from naturaldiffusion_tpu_torch.data import NativeBatchLoader
from naturaldiffusion_tpu_torch.eval import fid as pfid
from naturaldiffusion_tpu_torch.models.convert import randomize_
from naturaldiffusion_tpu_torch.models.ncsnpp import NCSNpp, NCSNppConfig
from torch_port_util import rel_l2

torch.set_num_threads(2)

# a 32 x 32 NCSN++ small enough for sampling on the CPU
TINY = dict(nf=16, ch_mult=(1, 2), num_res_blocks=1, attn_resolutions=(16,))


def _dict_keys(src, name):
    """The string keys of the dict literal assigned to ``name`` in ``src``."""
    body = src[src.index(f"{name} = {{"):]
    body = body[:body.index("\n    }")]
    return re.findall(r'"(\w+)":', body)


def _selfcheck(tmp_path, extra):
    out = str(tmp_path / "selfcheck.csv")
    rc = fid_selfcheck.main(["--toy", "--num", "16", "--batch", "16",
                             "--micro", "0", "--steps", "4", "--feat-batch",
                             "16", "--feat-dim", "6", "--device", "cpu",
                             "--out", out] + extra)
    assert rc in (0, 1)     # 16 samples: the estimator check means little
    with open(out, newline="") as fh:
        row = next(csv.DictReader(fh))
    stats = np.load(str(tmp_path / "selfcheck_stats.npz"))
    assert stats["mu"].shape == (6,) and stats["sigma"].shape == (6, 6)
    assert str(stats["weights"]) == "random-toy"
    assert list(row) == _dict_keys(inspect.getsource(jax_selfcheck.main),
                                   "row")
    return row


def test_selfcheck_app_with_is(tmp_path):
    row = _selfcheck(tmp_path, [])
    assert row["weights"] == "random-toy" and row["inception"] == "random"
    assert float(row["is_mean"]) >= 1.0 and float(row["is_std"]) >= 0.0
    # one batch: the steady sample rate excludes it, so it is nan
    for k in ("self_fid_25k_split", "shifted_fid", "feature_img_per_sec"):
        assert np.isfinite(float(row[k])), (k, row)


def test_selfcheck_app_no_is(tmp_path):
    row = _selfcheck(tmp_path, ["--no-is"])
    assert row["is_mean"] == "" and row["is_std"] == ""
    assert np.isfinite(float(row["shifted_fid"]))


def test_selfcheck_default_out_is_the_ports():
    """The JAX app writes ``results/FID/selfcheck.csv``, a file that came
    before the port; the port's default is ``results_torch/FID/``."""
    src = inspect.getsource(fid_selfcheck.main)
    assert '"results_torch/FID/selfcheck.csv"' in src


@pytest.fixture(scope="module")
def cifar_bin(tmp_path_factory):
    rng = np.random.default_rng(0)
    d = tmp_path_factory.mktemp("cifar_fid")
    paths = []
    for fi in range(2):
        n = 40
        rec = np.empty((n, 1 + 3072), np.uint8)
        rec[:, 0] = rng.integers(0, 10, n)
        rec[:, 1:] = rng.integers(0, 256, (n, 3072))
        p = d / f"data_batch_{fi + 1}.bin"
        rec.tofile(p)
        paths.append(str(p))
    return paths


@pytest.mark.parametrize("force_numpy", [False, True])
def test_loader_matches_jax(cifar_bin, force_numpy):
    """The port's loader (numpy) against each backend of JAX's, the C++
    one and its numpy fallback."""
    got = NativeBatchLoader(cifar_bin, seed=3)
    want = JaxLoader(cifar_bin, seed=3, force_numpy=force_numpy)
    assert got.backend == "numpy"
    assert want.backend == ("numpy" if force_numpy else "native")
    assert len(got) == len(want) == 80
    idx = np.array([0, 39, 40, 79, 5])
    flip = np.array([0, 1, 1, 0, 1], np.uint8)
    # JAX's C++ fill multiplies by 1/255, numpy divides by 255
    tol = 0 if force_numpy else 1e-7
    for a, b in zip(got.gather(idx, flip), want.gather(idx, flip)):
        np.testing.assert_allclose(a, b, rtol=0, atol=tol)
    for a, b in zip(got.next_batch(8), want.next_batch(8)):
        np.testing.assert_allclose(a, b, rtol=0, atol=tol)
    with pytest.raises(IndexError):
        got.gather(np.array([80]))


def test_loader_whole_dataset_and_a_missing_file_raises(cifar_bin, tmp_path):
    """Every record, labels exact, against JAX's C++ loader; the second
    file's records follow the first's."""
    ia, la = NativeBatchLoader(cifar_bin).gather(np.arange(80))
    ib, lb = JaxLoader(cifar_bin).gather(np.arange(80))
    np.testing.assert_array_equal(la, lb)
    np.testing.assert_allclose(ia, ib, rtol=0, atol=1e-7)   # x/255 vs x*inv
    raw = np.fromfile(cifar_bin[1], np.uint8).reshape(40, 3073)
    np.testing.assert_array_equal(la[40:], raw[:, 0])
    with pytest.raises(OSError):
        NativeBatchLoader([str(tmp_path / "absent.bin")])


def _np_feat(images):
    x = np.asarray(images, np.float64).reshape(len(images), -1, 3)
    return np.concatenate([x.mean(1), x.std(1), x.min(1)[:, :1],
                           x.max(1)[:, :1]], axis=1).astype(np.float32)


def _torch_feat(images):
    return torch.from_numpy(_np_feat(images.numpy()))


def test_dataset_stats_match_jax(cifar_bin):
    """Against JAX's pipeline over its numpy loader, the port's path (the
    C++ one's pixels differ in last bits: test_loader_matches_jax)."""
    for batch in (16, 32):
        mu, sigma, n = fid_stats.compute_dataset_stats(
            NativeBatchLoader(cifar_bin), _torch_feat, batch_size=batch)
        jmu, jsigma, jn = jax_fid_stats.compute_dataset_stats(
            JaxLoader(cifar_bin, force_numpy=True), _np_feat,
            batch_size=batch)
        assert n == jn == 80
        np.testing.assert_allclose(mu, jmu, rtol=1e-12, atol=0)
        np.testing.assert_allclose(sigma, jsigma, rtol=1e-12, atol=1e-15)


def test_fid_stats_main_writes_what_fid_from_samples_reads(
        cifar_bin, tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(
        "naturaldiffusion_tpu_torch.eval.inception.default_feature_fn",
        lambda pth=None, **kw: _torch_feat)
    out = tmp_path / "stats.npz"
    assert fid_stats.main(["--data", *cifar_bin, "--out", str(out),
                           "--batch", "32", "--device", "cpu"]) == 0
    assert "80 records (numpy backend)" in capsys.readouterr().out
    with np.load(out) as f:
        assert f["mu"].shape == (8,) and f["sigma"].shape == (8, 8)
        assert str(f["weights"]) == "random"
    imgs, _ = NativeBatchLoader(cifar_bin).gather(np.arange(80))
    assert abs(pfid.fid_from_samples(imgs * 2 - 1, str(out),
                                     feature_fn=_torch_feat)) < 1e-6
    other = np.random.default_rng(1).uniform(-0.4, 0.4, imgs.shape)
    got = pfid.fid_from_samples(other.astype(np.float32), str(out),
                                feature_fn=_torch_feat)
    want = jfid.fid_from_samples(other.astype(np.float32), str(out),
                                 feature_fn=_np_feat)
    assert got > 1e-3 and abs(got - want) <= 1e-10 * want


def test_quant_accuracy_small_config(tmp_path, capsys):
    """Every weight random (no zero-init Conv_1), so the int8 convs move
    the output; the JAX app's report keys; the JSON file."""
    args = quant_accuracy.parse_args([
        "--nf", "128", "--ch-mult", "1", "--num-res-blocks", "1",
        "--batch", "2", "--steps", "2", "--mode", "int8_static",
        "--device", "cpu"])
    model = randomize_(NCSNpp(NCSNppConfig(nf=128, ch_mult=(1,),
                                           num_res_blocks=1), device="cpu"),
                       5)
    rep = quant_accuracy.run(args, model=model)
    assert list(rep) == _dict_keys(inspect.getsource(jax_quant.main),
                                   "report")
    assert rep["finite"] and rep["mode"] == "int8_static"
    assert rep["mae_int8_vs_bf16"] > 0     # route 0: the int8 convs ran
    assert rep["mae_bf16_vs_fp64oracle"] > 0
    out = tmp_path / "q.json"
    assert quant_accuracy.main([
        "--nf", "128", "--ch-mult", "1", "--num-res-blocks", "1", "--batch",
        "1", "--steps", "2", "--device", "cpu", "--out", str(out)]) == 0
    assert json.loads(out.read_text())["weights"] == "random"


# quant_accuracy's model, 32 x 32 (the app's size) with one int8 block
QA_CFG = dict(nf=128, ch_mult=(1,), num_res_blocks=1)
QA_BATCH, QA_STEPS = 2, 2
# the fp64 oracle around the f32 model, port against JAX: f32 model
# differences (~2e-6) over two steps; reads 9.4e-7
QA_ORACLE_TOL = 1e-4
# the bf16 engine, port against JAX and against JAX's oracle, at most
# BF16_FACTOR x JAX's own bf16-against-oracle control (the reasoning of
# test_torch_ncsnpp.py::BF16_CONTROL_FACTOR); reads 1.00x and 1.05x
BF16_FACTOR = 1.5
# the int8 engine, port against JAX: the limits of the JAX package's int8
# model test (tests/test_quant.py:89-94).  An f32 bit that flips one int8
# rounding moves a whole step, so the two packages' int8 runs differ about
# as much as int8 from bf16 (1.7e-2 and 1.6e-2 here).  So the gap itself
# is held as well: the port's int8-against-bf16 MAE within GAP_RATIO of
# JAX's (reads 1.012 in int8_static, 1.004 in int8), and likewise its
# bf16-against-oracle MAE (reads 1.05); an int8 path that did not run, or
# quantized at another scale, moves the gap by O(1)
INT8_REL, INT8_COS, GAP_RATIO = 5e-2, 0.99, 1.25


@pytest.fixture(scope="module")
def qa_pair():
    """One numpy-drawn NCSN++ tree in both packages."""
    import jax
    import jax.numpy as jnp
    from naturaldiffusion_tpu.models.ncsnpp import NCSNpp as JaxNCSNpp
    from naturaldiffusion_tpu.models.ncsnpp import NCSNppConfig as JaxConfig
    from naturaldiffusion_tpu_torch.models.convert import load_jax_params
    from torch_port_util import random_flax_params

    jm = JaxNCSNpp(config=JaxConfig(**QA_CFG))
    with jax.enable_x64(False):
        shapes = jax.eval_shape(
            lambda k: jm.init(k, jnp.zeros((1, 32, 32, 3), jnp.float32),
                              jnp.zeros((1,), jnp.float32))["params"],
            jax.random.PRNGKey(0))
    params = random_flax_params(shapes, np.random.default_rng(4))
    tm = load_jax_params(NCSNpp(NCSNppConfig(**QA_CFG), device="cpu"),
                         params)
    return jm, params, tm


def _jax_quant_trajectories(jm, params, mode, monkeypatch):
    """JAX's app's three runs (quant_accuracy.main) over ``params``, from
    the init and noises the port's app draws."""
    import jax
    import jax.numpy as jnp
    from naturaldiffusion_tpu.coeffs import registry as jreg
    from naturaldiffusion_tpu.engine import NISchedule as JaxSchedule
    from naturaldiffusion_tpu.engine import natural_inference as jax_ni
    from naturaldiffusion_tpu.engine import (
        natural_inference_reference as jax_ref)

    shape = (QA_BATCH, 32, 32, 3)
    z0 = torch.randn(shape, generator=torch.Generator().manual_seed(0))
    noises = torch.randn((QA_STEPS,) + shape,
                         generator=torch.Generator().manual_seed(9))
    z0, noises = z0.numpy(), noises.numpy()
    m = jreg.derive("ddpm", QA_STEPS)
    sched = JaxSchedule.from_matrix(m)
    p16 = jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), params)

    def eps_bf16(z, t, *a):
        return jm.apply({"params": p16}, z.astype(jnp.bfloat16),
                        jnp.full((z.shape[0],), t, jnp.float32))

    def engine(quant):
        # a fresh function per mode: JAX reads the switches at trace time
        monkeypatch.setenv("NATDIFF_PALLAS_CONV", "0")
        if quant:
            monkeypatch.setenv("NATDIFF_QUANT", quant)
        else:
            monkeypatch.delenv("NATDIFF_QUANT", raising=False)
        out = jax.jit(lambda: jax_ni(
            eps_bf16, sched, jnp.asarray(z0), prediction_type="eps",
            model_dtype=jnp.bfloat16, noises=jnp.asarray(noises),
            unroll=False))()
        monkeypatch.delenv("NATDIFF_QUANT", raising=False)
        return np.asarray(out, np.float32)

    f32 = jax.jit(lambda z, t: jm.apply(
        {"params": params}, z, jnp.full((z.shape[0],), t, jnp.float32)))
    oracle = jax_ref(lambda z, t: np.asarray(f32(jnp.asarray(z,
                                                             jnp.float32), t)),
                     m, z0, noises=noises, prediction_type="eps")
    return engine(""), engine(mode), oracle


@pytest.mark.parametrize("mode", ["int8_static", "int8"])
def test_quant_accuracy_matches_jax(qa_pair, monkeypatch, mode):
    """The port's three trajectories and report against the JAX app's runs
    on one numpy-drawn tree, init and noises (see QA_ORACLE_TOL,
    BF16_FACTOR, INT8_REL and GAP_RATIO)."""
    jm, params, tm = qa_pair
    args = quant_accuracy.parse_args([
        "--nf", "128", "--ch-mult", "1", "--num-res-blocks", "1",
        "--batch", str(QA_BATCH), "--steps", str(QA_STEPS), "--mode", mode,
        "--device", "cpu"])
    bf16, int8, oracle = quant_accuracy.trajectories(args, model=tm)
    rep = quant_accuracy.run(args, model=tm)
    jbf16, jint8, joracle = _jax_quant_trajectories(jm, params, mode,
                                                    monkeypatch)
    assert np.isfinite(joracle).all() and np.abs(joracle).mean() > 1.0
    assert rel_l2(oracle, joracle) < QA_ORACLE_TOL
    control = rel_l2(jbf16, joracle)
    assert 1e-3 < control < 5e-2
    assert rel_l2(bf16, jbf16) <= BF16_FACTOR * control
    assert rel_l2(bf16, joracle) <= BF16_FACTOR * control
    a, b = int8.ravel().astype(np.float64), jint8.ravel().astype(np.float64)
    assert rel_l2(int8, jint8) < INT8_REL
    assert a @ b / (np.linalg.norm(a) * np.linalg.norm(b)) > INT8_COS

    def mae(x, y):
        return float(np.abs(np.float64(x) - np.float64(y)).mean())
    assert rep["mae_int8_vs_bf16"] == mae(int8, bf16)
    assert rep["mae_bf16_vs_fp64oracle"] == mae(bf16, oracle)
    for got, want in ((rep["mae_int8_vs_bf16"], mae(jint8, jbf16)),
                      (rep["mae_bf16_vs_fp64oracle"], mae(jbf16, joracle))):
        assert want / GAP_RATIO < got < want * GAP_RATIO, (got, want)


def _fid_hooks(monkeypatch, pths=None):
    """The tiny feature fn in place of the Inception (the ``.pth`` each
    call named appended to ``pths``), and the images each
    ``fid_from_samples`` call got."""
    def feature_fn(pth=None, **kw):
        if pths is not None:
            pths.append(pth)
        return _torch_feat
    monkeypatch.setattr(
        "naturaldiffusion_tpu_torch.eval.inception.default_feature_fn",
        feature_fn)
    seen = []
    real = pfid.fid_from_samples

    def spy(images, path, **kw):
        seen.append(np.asarray(torch.as_tensor(images).cpu()))
        return real(images, path, **kw)
    monkeypatch.setattr(pfid, "fid_from_samples", spy)
    return seen


def _stats_npz(tmp_path):
    rng = np.random.default_rng(2)
    mu, sigma = jfid.compute_statistics(
        _np_feat(rng.uniform(0, 1, (50, 32, 32, 3))))
    path = str(tmp_path / "ref_stats.npz")
    np.savez(path, mu=mu, sigma=sigma)
    return path


@pytest.mark.parametrize("inception", [None, "pt_inception.pth"])
def test_cifar10_ni_fid_stats(tmp_path, monkeypatch, capsys, inception):
    """The FID of the samples, and the Inception's provenance beside it:
    ``--inception`` reaches ``default_feature_fn``."""
    pths = []
    seen = _fid_hooks(monkeypatch, pths)
    stats = _stats_npz(tmp_path)
    monkeypatch.setattr(cifar10_ni, "CIFAR10_DDPMPP_CONTINUOUS",
                        NCSNppConfig(**TINY))
    extra = ["--inception", inception] if inception else []
    assert cifar10_ni.main(["--num", "4", "--batch", "2", "--steps", "2",
                            "--device", "cpu", "--outdir",
                            str(tmp_path / "out"), "--fid-stats",
                            stats] + extra) == 0
    line = [ln for ln in capsys.readouterr().out.splitlines()
            if ln.startswith("FID = ")]
    samples = np.load(tmp_path / "out" / "samples_random.npy")
    np.testing.assert_array_equal(seen[0], samples)
    assert pths == [inception]
    want = jfid.fid_from_samples(samples, stats, feature_fn=_np_feat)
    prov = "converted" if inception else "random"
    assert line == [f"FID = {want:.3f} (inception={prov})"] and want > 1e-3


def test_sweep_fid_stats(tmp_path, monkeypatch):
    seen = _fid_hooks(monkeypatch)
    stats = _stats_npz(tmp_path)
    args = sweep.parse_args(["--family", "deis", "--only", "t:t_ab:3",
                             "--steps", "3", "--num", "4", "--batch", "2",
                             "--micro", "1", "--device", "cpu", "--out",
                             str(tmp_path / "s.csv"), "--fid-stats", stats])
    row, = sweep.run(args, model=NCSNpp(NCSNppConfig(**TINY), device="cpu"))
    assert list(row)[-2:] == ["inception", "fid"]
    assert row["inception"] == "random" and seen[0].shape == (4, 32, 32, 3)
    want = jfid.fid_from_samples(seen[0], stats, feature_fn=_np_feat)
    assert row["fid"] == round(want, 3) and want > 1e-3
    with open(tmp_path / "s.csv") as fh:
        assert next(csv.reader(fh))[-1] == "fid"


def test_graphed_sampler_refuses_the_cpu():
    with pytest.raises(ValueError, match="CUDA device"):
        cifar10_ni.make_sampler(NCSNpp(NCSNppConfig(**TINY), device="cpu"),
                                None, device="cpu", graph=True)
