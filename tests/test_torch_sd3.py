"""The port's SD3 path against the JAX package's at small sizes, every
weight random from numpy and carried across by ``load_jax_params``:
``SD3Pipeline`` from raw text (the fixture tokenizers, CLIP-L, CLIP-G and
T5 encoders, the CFG NI over the Euler and a sharp weight matrix, the VAE
decode) against JAX's ``SD3Pipeline`` with the same weights and noise;
``sd3_natural_inference`` against the port's reference-shaped host loop
and against JAX's; ``load_weight_csv``; ``bench_sd3 --toy``; the
degradation study; ``sd3_ni --small``; and ``validate_dit --vae`` against
JAX's decode."""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from naturaldiffusion_tpu import pipeline as jpipe
from naturaldiffusion_tpu import text as jtext
from naturaldiffusion_tpu.apps import degradation as jdeg
from naturaldiffusion_tpu.apps import sd3_ni as jsd3
from naturaldiffusion_tpu.models import mmdit as jm
from naturaldiffusion_tpu.models import text_encoders as jt
from naturaldiffusion_tpu.models import vae as jv
from naturaldiffusion_tpu.models.convert import fill_from_torch as jfill
from naturaldiffusion_tpu_torch import pipeline as tpipe
from naturaldiffusion_tpu_torch import text as ttext
from naturaldiffusion_tpu_torch.apps import (bench_sd3, degradation, sd3_ni,
                                             validate_dit)
from naturaldiffusion_tpu_torch.models import mmdit as tm
from naturaldiffusion_tpu_torch.models import text_encoders as tt
from naturaldiffusion_tpu_torch.models import vae as tv
from naturaldiffusion_tpu_torch.models.convert import load_jax_params
from test_text import _clip_fixture, _spm_fixture
from torch_port_util import jax_params, rel_l2

torch.set_num_threads(2)

# f32 on both sides over a run of 4-6 steps; rel L2
RUN_TOL = 1e-4
MM = dict(sample_size=8, patch_size=2, in_channels=16, hidden_size=64,
          depth=2, num_heads=4, caption_projection_dim=64,
          joint_attention_dim=96, pooled_projection_dim=40,
          pos_embed_max_size=16)
VA = dict(base_channels=32, ch_mult=(1, 2), layers_per_block=1,
          latent_channels=16, scaling_factor=1.5305, shift_factor=0.0609)
CL = dict(vocab_size=530, hidden_size=32, num_layers=2, num_heads=4,
          intermediate_size=48, max_positions=12, projection_dim=24)
CG = dict(CL, hidden_size=40, num_heads=5, projection_dim=16,
          hidden_act="gelu")
T5 = dict(vocab_size=12, d_model=96, d_kv=8, d_ff=48, num_layers=2,
          num_heads=4)


def _t(a):
    return torch.from_numpy(np.array(a))


def _both(jcls, jcfg_cls, tcls, tcfg_cls, cfg, *args, seed=0):
    jmod = jcls(config=jcfg_cls(**cfg))
    params = jax_params(jmod, *args, seed=seed)
    tmod = load_jax_params(tcls(tcfg_cls(**cfg), device="cpu"), params)
    return jmod, params, tmod


@pytest.fixture(scope="module")
def mmdits():
    z = np.zeros((1, 8, 8, 16), np.float32)
    return _both(jm.MMDiT, jm.MMDiTConfig, tm.MMDiT, tm.MMDiTConfig, MM, z,
                 np.zeros(1, np.float32), np.zeros((1, 5, 96), np.float32),
                 np.zeros((1, 40), np.float32))


def _cond(seed, b=2, t=7):
    rng = np.random.default_rng(seed)
    ctx = rng.standard_normal((b, t, 96)).astype(np.float32)
    pooled = rng.standard_normal((b, 40)).astype(np.float32)
    return ctx, pooled, 0.3 * ctx[::-1].copy(), 0.0 * pooled


def _sharp(n, seed=3):
    """A lower-triangular weight matrix with old columns clipped and the
    diagonal boosted, as the reference's sharp CSVs."""
    w = np.tril(np.random.default_rng(seed).uniform(0.2, 1.0, (n, n)))
    w[np.tril_indices(n, -3)] = 0.0
    w[np.diag_indices(n)] *= 3.0
    return w


@pytest.mark.parametrize("sharp", [False, True])
def test_pipeline_from_text_matches_jax(mmdits, tmp_path, sharp):
    """Raw text -> tokenizers -> the three encoders -> 5-step CFG NI ->
    VAE decode, each package with its own modules and the same weights;
    the latents and the images at rel L2 < 1e-4."""
    jmm, jmp, tmm = mmdits
    ids = np.zeros((1, 12), np.int32)
    jl, pl, tl = _both(jt.CLIPTextEncoder, jt.CLIPTextConfig,
                       tt.CLIPTextEncoder, tt.CLIPTextConfig, CL, ids, seed=1)
    jg, pg, tg = _both(jt.CLIPTextEncoder, jt.CLIPTextConfig,
                       tt.CLIPTextEncoder, tt.CLIPTextConfig, CG, ids, seed=2)
    j5, p5, t5 = _both(jt.T5Encoder, jt.T5Config, tt.T5Encoder, tt.T5Config,
                       T5, ids, seed=3)
    jva, pva, tva = _both(jv.AutoencoderKL, jv.VAEConfig, tv.AutoencoderKL,
                          tv.VAEConfig, VA, np.zeros((1, 16, 16, 3),
                                                     np.float32), seed=4)
    vpath, mpath, _ = _clip_fixture(tmp_path)
    spm = _spm_fixture(tmp_path)
    jp = jpipe.SD3Pipeline.from_parts(
        mmdit=jmm, mmdit_params=jmp, vae=jva, vae_params=pva, clip_l=jl,
        clip_l_params=pl, clip_g=jg, clip_g_params=pg, t5=j5, t5_params=p5,
        tokenizer_clip=jtext.CLIPBPETokenizer.from_files(vpath, mpath),
        tokenizer_t5=jtext.SentencePieceUnigram.from_file(spm))
    tp = tpipe.SD3Pipeline.from_parts(
        mmdit=tmm, vae=tva, clip_l=tl, clip_g=tg, t5=t5,
        tokenizer_clip=ttext.CLIPBPETokenizer.from_files(vpath, mpath),
        tokenizer_t5=ttext.SentencePieceUnigram.from_file(spm))
    n = 5
    noises = np.random.default_rng(7).standard_normal(
        (2, 8, 8, 16)).astype(np.float32)
    kw = dict(prompt=["hello low", "LOWER hello!"], negative_prompt="low",
              num_steps=n, weights=_sharp(n) if sharp else None)
    jlat = np.asarray(jp(noises=jnp.asarray(noises), decode=False, **kw))
    tlat = tp(noises=_t(noises), decode=False, **kw)
    assert tlat.dtype == torch.float32 and tlat.shape == (2, 8, 8, 16)
    assert np.abs(jlat).max() > 0.1
    assert rel_l2(tlat.numpy(), jlat) < RUN_TOL
    jimg = np.asarray(jp(noises=jnp.asarray(noises), **kw))
    timg = tp(noises=_t(noises), **kw)
    assert timg.shape == jimg.shape == (2, 16, 16, 3)
    assert rel_l2(timg.numpy(), jimg) < RUN_TOL
    # the encoders alone, from the ids JAX's tokenizers give
    ids = jp.tokenize(kw["prompt"], "low")
    want = jp.encode_prompt(ids["ids_l"], ids["ids_g"], ids["ids_t5"])
    got = tp.encode_prompt(ids["ids_l"], ids["ids_g"], ids["ids_t5"])
    assert got[0].shape == (2, 12 + 256, 96)
    for a, b in zip(got, want):
        assert rel_l2(a.numpy(), np.asarray(b)) < 1e-5


def test_pipeline_without_encoders_takes_embeddings(mmdits):
    _, _, tmm = mmdits
    tp = tpipe.SD3Pipeline.from_parts(mmdit=tmm)
    noises = torch.randn(1, 8, 8, 16, generator=torch.Generator()
                         .manual_seed(0))
    with pytest.raises(ValueError, match="prompt= or the four"):
        tp(noises=noises, num_steps=2)
    with pytest.raises(ValueError, match="no tokenizer"):
        tp(noises=noises, prompt="a", num_steps=2)
    ctx, pooled, nctx, npooled = (_t(a[:1]) for a in _cond(0))
    out = tp(noises=noises, context=ctx, pooled=pooled, neg_context=nctx,
             neg_pooled=npooled, num_steps=2)
    assert out.shape == noises.shape and torch.isfinite(out).all()


@pytest.mark.parametrize("mods", [True, False])
def test_sd3_natural_inference_matches_host_loop_and_jax(mmdits, mods):
    """6 steps of the sharp matrix: the engine (K1's plain version, the
    modulations hoisted or not) against the port's reference-shaped loop
    and against JAX's engine run."""
    jmm, jmp, tmm = mmdits
    n = 6
    w = _sharp(n, seed=5)
    ctx, pooled, nctx, npooled = _cond(1)
    noises = np.random.default_rng(8).standard_normal(
        (2, 8, 8, 16)).astype(np.float32)
    cond = dict(context=_t(ctx), pooled=_t(pooled), neg_context=_t(nctx),
                neg_pooled=_t(npooled))
    got = sd3_ni.sd3_natural_inference(tmm, _t(noises), w, num_step=n,
                                       precompute_mods=mods, **cond)
    host = sd3_ni.sd3_natural_inference_host(tmm, _t(noises), w,
                                             num_step=n, **cond)
    want = np.asarray(jsd3.sd3_natural_inference(
        jmm, jmp, jnp.asarray(noises), w, context=jnp.asarray(ctx),
        pooled=jnp.asarray(pooled), neg_context=jnp.asarray(nctx),
        neg_pooled=jnp.asarray(npooled), num_step=n, unroll=True,
        precompute_mods=mods))
    assert np.abs(want).max() > 0.1
    assert rel_l2(got.numpy(), host.numpy()) < RUN_TOL
    assert rel_l2(got.numpy(), want) < RUN_TOL


def test_load_weight_csv(tmp_path):
    """A header row and an index column, as pandas writes a DataFrame."""
    w = _sharp(4) * 1.25
    path = tmp_path / "w.csv"
    lines = [",0,1,2,3"] + [f"{i}," + ",".join(repr(float(v)) for v in row)
                            for i, row in enumerate(w)]
    path.write_text("\n".join(lines) + "\n")
    got = sd3_ni.load_weight_csv(str(path))
    np.testing.assert_array_equal(got, w)
    # pandas' default parser may round the last bit differently
    pd = pytest.importorskip("pandas")
    np.testing.assert_allclose(got, pd.read_csv(path, index_col=0)
                               .to_numpy(), rtol=1e-15, atol=0)


@pytest.mark.parametrize("mods", [True, False])
def test_bench_sd3_toy_on_the_cpu(capsys, mods):
    argv = ["--toy", "--latent", "8", "--steps", "2", "--ctx", "9",
            "--device", "cpu"] + ([] if mods else ["--no-mods"])
    assert bench_sd3.main(argv) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["device"] == "cpu" and out["card"] is None
    assert out["mfu"] is None and out["mods"] is mods
    assert out["sec_per_image"] > 0 and out["latent"] == 8
    cfg = bench_sd3.toy_config(8)
    assert out["flops_per_fwd"] == bench_sd3.flops_per_forward(cfg, 1, 8, 9,
                                                               mods)
    assert bench_sd3.main(argv + ["--flops-only"]) == 0
    counted = int(capsys.readouterr().out.strip().splitlines()[-1])
    assert counted == out["flops_per_fwd"]


def test_flops_per_forward_of_sd3_medium():
    """SD3-medium at one 1024^2 image (model batch 2) with CLIP + T5
    context (333 tokens): the blocks' 12 d^2 products a row over 8,192
    latent rows (11.13 TFLOP) and 666 context rows (0.88), and 24 joint
    attentions at t = 4429 (5.79): 17.8 TFLOP."""
    cfg = tm.SD3_MEDIUM
    f = bench_sd3.flops_per_forward(cfg, 1, 128, 333, True)
    d, t = cfg.hidden_size, 4096 + 333
    attn = 24 * 4 * 2 * t * t * d
    assert abs(attn / 5.79e12 - 1) < 0.01
    assert abs(2 * 8192 * 12 * d * d * 24 / 11.13e12 - 1) < 0.01
    assert abs(f / 17.80e12 - 1) < 0.01


def test_degradation_posterior_stats_match_jax():
    rng = np.random.default_rng(0)
    feats = rng.standard_normal((24, 16)).astype(np.float32)
    for kind, t in (("vp", 300), ("vp", 900), ("flow", 500)):
        with jax.enable_x64(False):
            noise = np.asarray(jax.random.normal(jax.random.PRNGKey(200),
                                                 feats.shape))
            wd, wm = (np.asarray(a) for a in jdeg.posterior_stats(
                jnp.asarray(feats), t, kind=kind))
        gd, gm = degradation.posterior_stats(feats, t, kind=kind,
                                             noise=noise, device="cpu")
        np.testing.assert_allclose(gd.numpy(), wd, atol=1e-5, rtol=0)
        np.testing.assert_allclose(gm.numpy(), wm, atol=1e-5, rtol=0)


def test_degradation_study_and_features_on_the_cpu(tmp_path, capsys):
    from PIL import Image
    assert degradation.main(["--n", "32", "--dim", "8", "--t", "200,800",
                             "--outdir", str(tmp_path / "h"),
                             "--device", "cpu"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 2 and lines[0].startswith("vp t=200")
    with np.load(tmp_path / "h" / "vp_800.npz") as f:
        assert f["hist_x0"].sum() == 32
    # VAE-encoded features of an image folder: the posterior means
    img_dir = tmp_path / "imgs"
    img_dir.mkdir()
    rng = np.random.default_rng(1)
    for i in range(3):
        Image.fromarray(rng.integers(0, 255, (20, 24, 3), np.uint8)).save(
            img_dir / f"{i}.png")
    vae = tv.AutoencoderKL(tv.VAEConfig(**dict(VA, latent_channels=4)),
                           device="cpu")
    feats = degradation.features_from_images(str(img_dir), image_size=16,
                                             batch=2, device="cpu", vae=vae)
    assert feats.shape == (3, 8 * 8 * 4) and np.isfinite(feats).all()


def test_sd3_ni_small_on_the_cpu(tmp_path, monkeypatch, capsys):
    """``sd3_ni --small`` (the JAX app's small MMDiT) at an 8 x 8 latent,
    with ``--vae`` through the twin's weights at a small SD3-layout VAE."""
    from torch_vae_twin import TorchAutoencoderKL
    twin = TorchAutoencoderKL(cin=3, ch=32, mults=(1, 2), layers=1, zc=16)
    torch.save(twin.state_dict(), tmp_path / "vae.pth")
    monkeypatch.setattr(tv, "SD3_VAE", tv.VAEConfig(**VA))
    out = tmp_path / "out"
    assert sd3_ni.main(["--small", "--latent", "8", "--steps", "3",
                        "--vae", str(tmp_path / "vae.pth"), "--outdir",
                        str(out), "--device", "cpu"]) == 0
    lat = np.load(out / "latents_random.npy")
    assert lat.shape == (1, 8, 8, 16) and np.isfinite(lat).all()
    assert (out / "grid_random.png").exists()
    meta = json.loads((out / "meta.json").read_text())
    assert meta["weights"] == "random" and meta["steps"] == 3
    assert "finite=True" in capsys.readouterr().out
    assert dataclasses.asdict(sd3_ni.SMALL) == dataclasses.asdict(
        jm.MMDiTConfig(hidden_size=128, depth=2, num_heads=4,
                       joint_attention_dim=64, pooled_projection_dim=64))


def test_validate_dit_vae_matches_jax_decode(tmp_path, monkeypatch, capsys):
    """``validate_dit --vae``: both trajectories decoded by the VAE of the
    given torch weights (a small SD-layout twin), against JAX's VAE with
    the same state dict through JAX's converter on the same latents."""
    from torch_vae_twin import TorchAutoencoderKL
    torch.manual_seed(0)
    twin = TorchAutoencoderKL(cin=3, ch=32, mults=(1, 2), layers=2, zc=4)
    torch.save(twin.state_dict(), tmp_path / "vae.pth")
    small = tv.VAEConfig(base_channels=32, ch_mult=(1, 2), layers_per_block=2)
    monkeypatch.setattr(tv, "SD_VAE", small)
    model = validate_dit.build_model(validate_dit.SMALL, device="cpu")
    diff, scale, direct, ni = validate_dit.validate(model, steps=3, batch=2)
    assert direct.shape == ni.shape == (4, 8, 8, 4)
    vae = validate_dit.load_vae(str(tmp_path / "vae.pth"), "cpu")
    jcfg = jv.VAEConfig(**dataclasses.asdict(small))
    jmod = jv.AutoencoderKL(config=jcfg)
    jp, _ = jfill(jax_params(jmod, np.zeros((1, 16, 16, 3), np.float32)),
                  twin.state_dict(), path_map=jv.vae_torch_path_map)
    for lat in (direct, ni):
        got = validate_dit.decode_latents(vae, lat, 2)
        want = np.asarray(jmod.apply(
            {"params": jp}, jmod.unscale_latents(jnp.asarray(lat[:2])),
            method=jv.AutoencoderKL.decode))
        assert got.shape == want.shape == (2, 16, 16, 3)
        assert rel_l2(got.numpy(), want) < 1e-5
    out = tmp_path / "val"
    assert validate_dit.main(["--small", "--steps", "3", "--vae",
                              str(tmp_path / "vae.pth"), "--outdir",
                              str(out), "--device", "cpu"]) == 0
    assert "[OK ]" in capsys.readouterr().out
    for name in ("original", "natural"):
        assert (out / f"ddim_003__seed_0__{name}.png").exists()
