"""The port stands alone: it imports neither JAX nor the JAX package, its
entry points refuse to run on a missing card, and its registry holds every
derivation of the JAX package's."""

import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from naturaldiffusion_tpu_torch.apps.cifar10_ni import make_sampler
from naturaldiffusion_tpu_torch.coeffs import registry
from naturaldiffusion_tpu_torch.engine import NISchedule
from naturaldiffusion_tpu_torch.models.ncsnpp import NCSNpp, NCSNppConfig
from torch_port_util import SMALL

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent

_PROBE = f"""
import sys
import torch
torch.set_num_threads(2)
from naturaldiffusion_tpu_torch.apps.cifar10_ni import make_sampler
from naturaldiffusion_tpu_torch.coeffs import registry
from naturaldiffusion_tpu_torch.models.ncsnpp import NCSNpp, NCSNppConfig
model = NCSNpp(NCSNppConfig(**{SMALL!r}), device="cpu")
run = make_sampler(model, registry.derive("ddim", 2), dtype=torch.float32,
                   device="cpu")
out = run(torch.randn(1, 8, 8, 3))
assert torch.isfinite(out).all()
from naturaldiffusion_tpu_torch.apps import bench_dit, validate_dit
from naturaldiffusion_tpu_torch.models.dit import DiT
from naturaldiffusion_tpu_torch.ops.attention import mha
from naturaldiffusion_tpu_torch.ops.qmatmul import matmul_wdq
from naturaldiffusion_tpu_torch.ops.quant import quantize_weight
dm = validate_dit.build_model(bench_dit.TOY, device="cpu").set_quant("w8")
z0 = torch.randn(1, 8, 8, 4)
dout = bench_dit.make_sampler(dm, registry.derive("ddim", 2))(
    torch.cat([z0, z0]), torch.tensor([1, 10]))
assert torch.isfinite(dout).all()
q = torch.randn(1, 2, 16, 64)
assert torch.isfinite(mha(q, q, q)).all()
w_i8, s_w = quantize_weight(torch.randn(128, 128))
assert torch.isfinite(matmul_wdq(torch.randn(16, 128), w_i8, s_w.flatten())).all()
from naturaldiffusion_tpu_torch import configs
from naturaldiffusion_tpu_torch.sde import get_score_fn
from naturaldiffusion_tpu_torch.samplers.pc import get_pc_sampler
from naturaldiffusion_tpu_torch.scaler import get_inverse_scaler
import dataclasses
cfg = configs.get_config("ve/celebahq_256_ncsnpp_continuous")
small = dataclasses.replace(cfg.model, image_size=16, nf=16, ch_mult=(1, 2),
                            num_res_blocks=1, attn_resolutions=(8,))
ve = NCSNpp(small, device="cpu")
sde = configs.get_sde(cfg)
sde = type(sde)(sigma_min=sde.sigma_min, sigma_max=sde.sigma_max, N=3)
sampler = get_pc_sampler(sde, get_score_fn(sde, ve), (1, 16, 16, 3),
                         predictor="reverse_diffusion", corrector="langevin",
                         snr=cfg.sampling.snr, device="cpu")
img, nfe = sampler(torch.Generator().manual_seed(0))
assert torch.isfinite(get_inverse_scaler(small.centered)(img)).all()
assert nfe == 6
import contextlib, io, tempfile
from naturaldiffusion_tpu_torch.apps import bench_attention, bench_conv
from naturaldiffusion_tpu_torch.ops.attention import mha_joint
from naturaldiffusion_tpu_torch.ops.fused_act import fused_leaky_relu_pallas
from naturaldiffusion_tpu_torch.utils import NFECounter, Timer, trace
from naturaldiffusion_tpu_torch.utils import flops, trace_summary
assert torch.isfinite(mha(q, q, q, backend="splash")).all()
qj = torch.randn(1, 2, 520, 64)
assert torch.isfinite(mha_joint(qj, qj, qj, split=512, interpret=True)).all()
assert torch.isfinite(fused_leaky_relu_pallas(torch.randn(3, 8),
                                              torch.zeros(8))).all()
assert Timer(iters=1, device="cpu")(lambda: None) >= 0
assert NFECounter(abs)(-1) == 1
assert flops.flops_counted(lambda a: a @ a, torch.randn(4, 4)) == 128
with contextlib.redirect_stdout(io.StringIO()):
    bench_attention.main(["--lengths", "64", "--heads", "1", "--device",
                          "cpu"])
    bench_conv.main(["--toy", "--device", "cpu"])
with tempfile.TemporaryDirectory() as d:
    with trace(d):
        torch.randn(4, 4).sum()
    assert trace_summary.summarize(d)[0] == 0
from naturaldiffusion_tpu_torch.apps import bench
from naturaldiffusion_tpu_torch.engine import graph
from naturaldiffusion_tpu_torch.ops.quant import conv1x1_int8, conv3x3_int8
from naturaldiffusion_tpu_torch.models.ncsnpp import ncsnpp_schedule_biases
xq = torch.randn(1, 4, 4, 128)
assert torch.isfinite(conv3x3_int8(xq, torch.randn(3, 3, 128, 128),
                                   act_amax=6.0)).all()
assert torch.isfinite(conv1x1_int8(xq, torch.randn(128, 128))).all()
dd = NCSNpp(NCSNppConfig(**dict({SMALL!r}, resblock_type="ddpm")),
            device="cpu")
hoisted = ncsnpp_schedule_biases(dd, torch.tensor([10.0]))
assert torch.isfinite(dd(torch.randn(1, 8, 8, 3), torch.tensor([10.0]),
                         mods={{k: v[0] for k, v in hoisted.items()}})).all()
from naturaldiffusion_tpu_torch.apps import analyze, sweep, validate
from naturaldiffusion_tpu_torch.models import convert
from naturaldiffusion_tpu_torch.samplers import deis, direct, dpm_solver
from naturaldiffusion_tpu_torch.samplers.pc import get_ode_sampler
from naturaldiffusion_tpu_torch.utils import plotting
vp = configs.get_sde(configs.get_config("vp/cifar10_ddpmpp_continuous"))
xv, nfe = get_ode_sampler(vp, lambda x, t: -x, (1, 4), rtol=1e-2, atol=1e-2,
                          device="cpu")(torch.Generator())
assert torch.isfinite(xv).all() and nfe > 1
assert validate.validate("ddim", 3, device="cpu") < 1e-4
ns = dpm_solver.NoiseScheduleVP()
dpm = dpm_solver.DPMSolver(dpm_solver.model_wrapper(lambda x, t: x * 0.1, ns),
                           ns)
assert torch.isfinite(dpm.sample(torch.randn(1, 4), steps=3)).all()
from naturaldiffusion_tpu_torch.schedules import LinearVPSDE
assert torch.isfinite(deis.get_sampler_t_ab(
    LinearVPSDE(), lambda x, t: x * 0.1, "t", 2.0, 3)(torch.randn(1, 4))).all()
assert sweep.deis_cells() and convert.strip_prefixes({{"module.a": 1}}) == {{"a": 1}}
assert callable(analyze.analyze) and callable(plotting.save_image_grid)
from naturaldiffusion_tpu_torch.apps import (fid_selfcheck, fid_stats,
                                             quant_accuracy)
from naturaldiffusion_tpu_torch.data import NativeBatchLoader
from naturaldiffusion_tpu_torch.eval import fid, inception
from naturaldiffusion_tpu_torch.samplers.controllable import (
    get_pc_colorizer, get_pc_inpainter)
import numpy as np
feats = fid.activations(np.random.rand(3, 32, 32, 3).astype(np.float32),
                        inception.default_feature_fn(with_logits=True,
                                                     device="cpu"),
                        batch_size=2, pad_to_batch=True)
assert feats.shape == (3, 2048 + 1008) and np.isfinite(feats).all()
mu, sigma = fid.compute_statistics(np.random.rand(16, 3))
assert abs(fid.frechet_distance(mu, sigma, mu, sigma)) < 1e-6
assert fid.inception_score(np.full((4, 5), 0.2), splits=2)[0] > 0.99
vp2 = type(vp)(N=2)
kw = dict(predictor="euler_maruyama", corrector="none", eps=1e-3,
          device="cpu")
g = torch.Generator().manual_seed(0)
gray = torch.zeros(1, 8, 8, 3)
assert torch.isfinite(get_pc_inpainter(vp2, lambda x, t: -x, **kw)(
    g, gray, torch.ones_like(gray))).all()
assert torch.isfinite(get_pc_colorizer(vp2, lambda x, t: -x, **kw)(
    g, gray)).all()
assert callable(fid_selfcheck.main) and callable(fid_stats.main)
assert callable(quant_accuracy.run) and NativeBatchLoader.__len__
for name in ("deis_tab", "dpmsolver3s", "flow_euler", "ode_heun"):
    m = registry.derive(name, 4)
    assert np.isfinite(m.x0).all() and np.isfinite(m.eps).all()
from naturaldiffusion_tpu_torch import models as zoo
from naturaldiffusion_tpu_torch.apps import bench_sd3, degradation, sd3_ni
from naturaldiffusion_tpu_torch.models import text_encoders as te
from naturaldiffusion_tpu_torch.pipeline import SD3Pipeline
from naturaldiffusion_tpu_torch.text import (CLIPBPETokenizer,
                                             SentencePieceUnigram,
                                             sd3_tokenize_ids)
from naturaldiffusion_tpu_torch.text.clip_bpe import basic_clean, pretokenize
mm = zoo.create_model("mmdit", device="cpu", **vars(bench_sd3.toy_config(8)))
vae = zoo.create_model("vae", device="cpu", base_channels=32, ch_mult=(1,),
                       layers_per_block=1)
clip = te.CLIPTextEncoder(te.CLIPTextConfig(vocab_size=9, hidden_size=16,
                                            num_layers=1, num_heads=2,
                                            intermediate_size=8,
                                            max_positions=4,
                                            projection_dim=16), device="cpu")
t5 = te.T5Encoder(te.T5Config(vocab_size=9, d_model=32, d_kv=8, d_ff=8,
                              num_layers=1, num_heads=2), device="cpu")
pipe = SD3Pipeline(mmdit=mm, vae=vae, clip_l=clip, clip_g=clip, t5=t5)
ctx, pooled = pipe.encode_prompt(np.ones((1, 4)), np.ones((1, 4)),
                                 np.ones((1, 3)))
assert ctx.shape == (1, 7, 32) and pooled.shape == (1, 32)
img = pipe(noises=torch.randn(1, 8, 8, 4), context=ctx, pooled=pooled,
           neg_context=ctx, neg_pooled=pooled, num_steps=2)
assert img.shape == (1, 8, 8, 3) and torch.isfinite(img).all()
assert pretokenize(basic_clean("It's a Café, 42!")) == [
    "it", "'s", "a", "café", ",", "4", "2", "!"]
assert callable(sd3_ni.main) and callable(degradation.posterior_stats)
assert callable(CLIPBPETokenizer.from_files) and SentencePieceUnigram
assert callable(sd3_tokenize_ids)
import tempfile
from naturaldiffusion_tpu_torch import train as ttrain
from naturaldiffusion_tpu_torch.apps import bench_train, toy_dataset
from naturaldiffusion_tpu_torch.apps import train as train_app
from naturaldiffusion_tpu_torch.data import datasets, image_folder, tfrecord
from naturaldiffusion_tpu_torch.eval import likelihood
from naturaldiffusion_tpu_torch.train import checkpoint
from naturaldiffusion_tpu_torch.train.state import functional_apply
from naturaldiffusion_tpu_torch.utils.metrics import MetricsWriter
lin = torch.nn.Linear(3, 3)
init, step = ttrain.make_train_step(
    vp, lambda p, x, l: torch.func.functional_call(lin, p, (x,)), warmup=1)
st, loss = step(init(dict(lin.named_parameters())),
                torch.Generator().manual_seed(0), torch.randn(2, 2, 2, 3))
assert torch.isfinite(loss) and st.step == 1
with tempfile.TemporaryDirectory() as d:
    checkpoint.save_meta(d, st)
    assert checkpoint.restore(d, st).step == 1
    MetricsWriter(d).close()
    toy_dataset.main(["--out", d, "--n-train", "8", "--n-eval", "8"])
    xb, _ = next(datasets.get_dataset("cifar10", 2, data_dir=d))
    assert xb.shape == (2, 32, 32, 3)
lk = likelihood.get_likelihood_fn(vp2, lambda x, t: -x, rtol=1e-2,
                                  atol=1e-2)
assert torch.isfinite(lk(torch.Generator(), torch.zeros(1, 4, 4, 3))[0]).all()
assert callable(train_app.main) and callable(bench_train.count_flops)
assert callable(tfrecord.tfrecord_iterator) and callable(functional_apply)
assert callable(image_folder.image_folder_iterator)
bad = sorted(k for k in sys.modules
             if k in ("jax", "naturaldiffusion_tpu", "regex", "pandas",
                      "optax", "orbax")
             or k.startswith(("jax.", "jaxlib", "naturaldiffusion_tpu.",
                              "regex.", "pandas.", "optax.", "orbax.")))
print("LEAKED", bad)
"""


def test_port_runs_without_jax_in_a_fresh_process():
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    res = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-2000:]
    assert "LEAKED []" in res.stdout, res.stdout


def test_no_source_imports_jax_or_the_jax_package():
    """Nor optax or orbax: the trainer's optimizer and checkpoints are the
    port's own."""
    pat = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|naturaldiffusion_tpu"
                     r"|optax|orbax)(\.|\s|$)", re.M)
    files = list((ROOT / "naturaldiffusion_tpu_torch").rglob("*.py"))
    files += [ROOT / "chip_smoke.py", ROOT / "int8_ablation.py"]
    assert len(files) > 10
    offenders = [str(f) for f in files if pat.search(f.read_text())]
    assert not offenders


def test_no_source_imports_regex_or_pandas():
    """The card's machine has neither: the CLIP pretokenizer is written
    with ``unicodedata`` and ``re``, the SD3 weight CSV read with ``csv``."""
    pat = re.compile(r"^\s*(import|from)\s+(regex|pandas)(\.|\s|$)", re.M)
    files = list((ROOT / "naturaldiffusion_tpu_torch").rglob("*.py"))
    files += [ROOT / "chip_smoke.py"]
    offenders = [str(f) for f in files if pat.search(f.read_text())]
    assert not offenders


def test_scipy_only_for_the_frechet_distance():
    """scipy is allowed in the port for ``sqrtm`` in ``eval/fid.py``
    alone."""
    pat = re.compile(r"^\s*(import|from)\s+scipy(\.|\s|$)", re.M)
    users = sorted(str(f.relative_to(ROOT)) for f in
                   (ROOT / "naturaldiffusion_tpu_torch").rglob("*.py")
                   if pat.search(f.read_text()))
    assert users == ["naturaldiffusion_tpu_torch/eval/fid.py"]


def test_entry_points_refuse_a_missing_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = NCSNppConfig(**SMALL)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        NCSNpp(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        NISchedule.from_matrix(registry.derive("ddpm", 2))
    model = NCSNpp(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_sampler(model, registry.derive("ddpm", 2))
    from naturaldiffusion_tpu_torch.apps.cifar10_ni import main
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main(["--num", "1"])


def test_ve_entry_points_refuse_a_missing_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    from naturaldiffusion_tpu_torch import configs
    from naturaldiffusion_tpu_torch.samplers.pc import get_pc_sampler
    from naturaldiffusion_tpu_torch.sde import VESDE
    with pytest.raises(RuntimeError, match="device='cpu'"):
        NCSNpp(configs.get_config("ve/cifar10_ncsnpp_continuous").model)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        get_pc_sampler(VESDE(N=2), lambda x, t: x, (1, 8, 8, 3))


def test_sampler_entry_points_refuse_a_missing_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    from naturaldiffusion_tpu_torch.apps import sweep, validate
    from naturaldiffusion_tpu_torch.samplers.pc import get_ode_sampler
    from naturaldiffusion_tpu_torch.sde import VPSDE
    with pytest.raises(RuntimeError, match="device='cpu'"):
        get_ode_sampler(VPSDE(), lambda x, t: x, (1, 8, 8, 3))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        validate.main(["--alg", "ddim", "--steps", "2"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        sweep.main(["--family", "deis", "--num", "1"])


def test_dit_entry_points_refuse_a_missing_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    from naturaldiffusion_tpu_torch.apps import bench_dit, validate_dit
    from naturaldiffusion_tpu_torch.models.dit import DiT
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DiT(bench_dit.TOY)
    for main in (bench_dit.main, validate_dit.main):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            main(["--steps", "2"])


@pytest.mark.parametrize("family", ["ddpm", "ncsnv2_64", "ncsnv2_128",
                                    "ncsnv2_256", "ncsn"])
def test_backbones_refuse_a_missing_card(monkeypatch, family):
    """Each backbone of the registry, by its constructor and through
    ``create_model``, at its config class's defaults."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    from naturaldiffusion_tpu_torch import models
    cls, cfg_cls = models.get_model(family)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cls(cfg_cls())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        models.create_model(family)


@pytest.mark.parametrize("name", ["dpmsolver2s", "ode_heun", "deis_tab",
                                  "flow_euler", "nonexistent"])
def test_registry_refuses_unported_derivations(name):
    """Every derivation of the JAX registry is ported: the four names that
    once raised here derive and equal the JAX package's matrices, and only
    a name neither registry knows still raises ``KeyError``."""
    from naturaldiffusion_tpu.coeffs import registry as jax_registry
    if name == "nonexistent":
        with pytest.raises(KeyError, match="unknown derivation"):
            registry.derive(name, 10)
        return
    got, want = registry.derive(name, 10), jax_registry.derive(name, 10)
    for f in ("x0", "eps", "node"):
        np.testing.assert_allclose(getattr(got, f), getattr(want, f),
                                   atol=1e-12, rtol=0)


def test_registry_derives_the_ported_samplers():
    m = registry.derive("ddpm", 10)
    assert m.x0.shape == (10, 10) and np.isfinite(m.eps).all()
    assert not m.is_deterministic
    assert registry.derive("ddim", 10).is_deterministic


def test_eval_entry_points_refuse_a_missing_card(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    from naturaldiffusion_tpu_torch.apps import (fid_selfcheck, fid_stats,
                                                 quant_accuracy)
    from naturaldiffusion_tpu_torch.eval import fid, inception
    from naturaldiffusion_tpu_torch.samplers import controllable
    from naturaldiffusion_tpu_torch.sde import VPSDE
    with pytest.raises(RuntimeError, match="device='cpu'"):
        inception.default_feature_fn()
    np.savez(tmp_path / "s.npz", mu=np.zeros(2), sigma=np.eye(2))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        fid.fid_from_samples(np.zeros((1, 32, 32, 3)),
                             str(tmp_path / "s.npz"))
    for make in (controllable.get_pc_inpainter,
                 controllable.get_pc_colorizer):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make(VPSDE(N=2), lambda x, t: x)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        fid_selfcheck.main(["--toy", "--num", "1"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        fid_stats.main(["--data", str(tmp_path / "none.bin")])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        quant_accuracy.main(["--batch", "1"])


def test_sd3_entry_points_refuse_a_missing_card(monkeypatch, tmp_path):
    """Every SD3 model at its default config (nothing is allocated before
    the refusal), through ``create_model`` too, and the SD3 apps."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    from naturaldiffusion_tpu_torch import models
    from naturaldiffusion_tpu_torch.apps import (bench_sd3, degradation,
                                                 sd3_ni, validate_dit)
    from naturaldiffusion_tpu_torch.models import text_encoders as te
    for make in (models.MMDiT, models.AutoencoderKL, te.CLIPTextEncoder,
                 te.T5Encoder, lambda: models.create_model("mmdit"),
                 lambda: models.create_model("vae")):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()
    for main, argv in ((sd3_ni.main, ["--small", "--latent", "8"]),
                       (bench_sd3.main, ["--toy", "--latent", "8"]),
                       (degradation.main, ["--n", "4", "--dim", "2"]),
                       (validate_dit.main, ["--small", "--vae",
                                            str(tmp_path / "v.pth")])):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            main(argv)
