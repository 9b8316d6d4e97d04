"""The JAX package's config zoo (``naturaldiffusion_tpu/configs_zoo.py``) as
preset data: all 39 entries of the reference's ``configs/{vp,ve,subvp}/``
tree, each with its model ``family`` (a name of ``models.create_model``'s
registry) and the model, SDE and sampling fields that the port reads,
copied value for value (a test holds them to
``naturaldiffusion_tpu.configs.get_config`` field by field).
The JAX entries' ``dropout`` and ``num_train_timesteps`` are left out (the
port runs inference and never reads the latter), and of the training
fields only the seven of ``configs.SDEConfig`` are kept.  JAX's quirk of
the ``ve/ncsn/*`` entries stays: their files never set ``training.sde``
(NCSN v1 predates the SDE framing), and they read ``sde="vesde",
continuous=False``.
"""

# fmt: off
ZOO = {
    'subvp/cifar10_ddpm_continuous': dict(
        family='ddpm',
        model=dict(nf=128, ch_mult=(1, 2, 2, 2), num_res_blocks=2, attn_resolutions=(16,), resamp_with_conv=True, conditional=True, scale_by_sigma=False, image_size=32, num_channels=3, centered=True, sigma_min=0.01, sigma_max=50, num_scales=1000),
        sde=dict(sde='subvpsde', continuous=True, sigma_min=0.01, sigma_max=50, beta_min=0.1, beta_max=20.0, num_scales=1000),
        sampling=dict(method='pc', predictor='euler_maruyama', corrector='none', snr=0.16, n_steps_each=1, noise_removal=True, probability_flow=False),
    ),
    'subvp/cifar10_ddpmpp_continuous': dict(
        family='ncsnpp',
        model=dict(nf=128, ch_mult=(1, 2, 2, 2), num_res_blocks=4, attn_resolutions=(16,), resamp_with_conv=True, conditional=True, fir=False, fir_kernel=(1, 3, 3, 1), skip_rescale=True, resblock_type='biggan', progressive='none', progressive_input='none', progressive_combine='sum', embedding_type='positional', fourier_scale=16, init_scale=0.0, scale_by_sigma=False, image_size=32, num_channels=3, centered=True),
        sde=dict(sde='subvpsde', continuous=True, sigma_min=0.01, sigma_max=50, beta_min=0.1, beta_max=20.0, num_scales=1000),
        sampling=dict(method='pc', predictor='euler_maruyama', corrector='none', snr=0.16, n_steps_each=1, noise_removal=True, probability_flow=False),
    ),
    'subvp/cifar10_ddpmpp_deep_continuous': dict(
        family='ncsnpp',
        model=dict(nf=128, ch_mult=(1, 2, 2, 2), num_res_blocks=8, attn_resolutions=(16,), resamp_with_conv=True, conditional=True, fir=False, fir_kernel=(1, 3, 3, 1), skip_rescale=True, resblock_type='biggan', progressive='none', progressive_input='none', progressive_combine='sum', embedding_type='positional', fourier_scale=16, init_scale=0.0, scale_by_sigma=False, image_size=32, num_channels=3, centered=True),
        sde=dict(sde='subvpsde', continuous=True, sigma_min=0.01, sigma_max=50, beta_min=0.1, beta_max=20.0, num_scales=1000),
        sampling=dict(method='pc', predictor='euler_maruyama', corrector='none', snr=0.16, n_steps_each=1, noise_removal=True, probability_flow=False),
    ),
    'subvp/cifar10_ncsnpp_continuous': dict(
        family='ncsnpp',
        model=dict(nf=128, ch_mult=(1, 2, 2, 2), num_res_blocks=4, attn_resolutions=(16,), resamp_with_conv=True, conditional=True, fir=True, fir_kernel=(1, 3, 3, 1), skip_rescale=True, resblock_type='biggan', progressive='none', progressive_input='residual', progressive_combine='sum', embedding_type='positional', fourier_scale=16, init_scale=0.0, scale_by_sigma=False, image_size=32, num_channels=3, centered=True),
        sde=dict(sde='subvpsde', continuous=True, sigma_min=0.01, sigma_max=50, beta_min=0.1, beta_max=20.0, num_scales=1000),
        sampling=dict(method='pc', predictor='euler_maruyama', corrector='none', snr=0.16, n_steps_each=1, noise_removal=True, probability_flow=False),
    ),
    'subvp/cifar10_ncsnpp_deep_continuous': dict(
        family='ncsnpp',
        model=dict(nf=128, ch_mult=(1, 2, 2, 2), num_res_blocks=8, attn_resolutions=(16,), resamp_with_conv=True, conditional=True, fir=True, fir_kernel=(1, 3, 3, 1), skip_rescale=True, resblock_type='biggan', progressive='none', progressive_input='residual', progressive_combine='sum', embedding_type='positional', fourier_scale=16, init_scale=0.0, scale_by_sigma=False, image_size=32, num_channels=3, centered=True),
        sde=dict(sde='subvpsde', continuous=True, sigma_min=0.01, sigma_max=50, beta_min=0.1, beta_max=20.0, num_scales=1000),
        sampling=dict(method='pc', predictor='euler_maruyama', corrector='none', snr=0.16, n_steps_each=1, noise_removal=True, probability_flow=False),
    ),
    've/bedroom_ncsnpp_continuous': dict(
        family='ncsnpp',
        model=dict(nf=128, ch_mult=(1, 1, 2, 2, 2, 2, 2), num_res_blocks=2, attn_resolutions=(16,), resamp_with_conv=True, conditional=True, fir=True, fir_kernel=(1, 3, 3, 1), skip_rescale=True, resblock_type='biggan', progressive='output_skip', progressive_input='input_skip', progressive_combine='sum', embedding_type='fourier', fourier_scale=16, init_scale=0.0, scale_by_sigma=True, image_size=256, num_channels=3, centered=False),
        sde=dict(sde='vesde', continuous=True, sigma_min=0.01, sigma_max=378, beta_min=0.1, beta_max=20.0, num_scales=2000),
        sampling=dict(method='pc', predictor='reverse_diffusion', corrector='langevin', snr=0.075, n_steps_each=1, noise_removal=True, probability_flow=False),
    ),
    've/celeba_ncsnpp': dict(
        family='ncsnpp',
        model=dict(nf=128, ch_mult=(1, 2, 2, 2), num_res_blocks=4, attn_resolutions=(16,), resamp_with_conv=True, conditional=True, fir=True, fir_kernel=(1, 3, 3, 1), skip_rescale=True, resblock_type='biggan', progressive='none', progressive_input='residual', progressive_combine='sum', embedding_type='positional', init_scale=0.0, scale_by_sigma=True, image_size=64, num_channels=3, centered=False),
        sde=dict(sde='vesde', continuous=False, sigma_min=0.01, sigma_max=90.0, beta_min=0.1, beta_max=20.0, num_scales=1000),
        sampling=dict(method='pc', predictor='reverse_diffusion', corrector='langevin', snr=0.17, n_steps_each=1, noise_removal=True, probability_flow=False),
    ),
    've/celebahq_256_ncsnpp_continuous': dict(
        family='ncsnpp',
        model=dict(nf=128, ch_mult=(1, 1, 2, 2, 2, 2, 2), num_res_blocks=2, attn_resolutions=(16,), resamp_with_conv=True, conditional=True, fir=True, fir_kernel=(1, 3, 3, 1), skip_rescale=True, resblock_type='biggan', progressive='output_skip', progressive_input='input_skip', progressive_combine='sum', embedding_type='fourier', fourier_scale=16, init_scale=0.0, scale_by_sigma=True, image_size=256, num_channels=3, centered=False),
        sde=dict(sde='vesde', continuous=True, sigma_min=0.01, sigma_max=348, beta_min=0.1, beta_max=20.0, num_scales=2000),
        sampling=dict(method='pc', predictor='reverse_diffusion', corrector='langevin', snr=0.075, n_steps_each=1, noise_removal=True, probability_flow=False),
    ),
    've/celebahq_ncsnpp_continuous': dict(
        family='ncsnpp',
        model=dict(nf=16, ch_mult=(1, 2, 4, 8, 16, 32, 32, 32), num_res_blocks=1, attn_resolutions=(16,), resamp_with_conv=True, conditional=True, fir=True, fir_kernel=(1, 3, 3, 1), skip_rescale=True, resblock_type='biggan', progressive='output_skip', progressive_input='input_skip', progressive_combine='sum', embedding_type='fourier', fourier_scale=16, init_scale=0.0, scale_by_sigma=True, image_size=1024, num_channels=3, centered=False),
        sde=dict(sde='vesde', continuous=True, sigma_min=0.01, sigma_max=1348, beta_min=0.1, beta_max=20.0, num_scales=2000),
        sampling=dict(method='pc', predictor='reverse_diffusion', corrector='langevin', snr=0.15, n_steps_each=1, noise_removal=True, probability_flow=False),
    ),
    've/church_ncsnpp_continuous': dict(
        family='ncsnpp',
        model=dict(nf=128, ch_mult=(1, 1, 2, 2, 2, 2, 2), num_res_blocks=2, attn_resolutions=(16,), resamp_with_conv=True, conditional=True, fir=True, fir_kernel=(1, 3, 3, 1), skip_rescale=True, resblock_type='biggan', progressive='output_skip', progressive_input='input_skip', progressive_combine='sum', embedding_type='fourier', fourier_scale=16, init_scale=0.0, scale_by_sigma=True, image_size=256, num_channels=3, centered=False),
        sde=dict(sde='vesde', continuous=True, sigma_min=0.01, sigma_max=380, beta_min=0.1, beta_max=20.0, num_scales=2000),
        sampling=dict(method='pc', predictor='reverse_diffusion', corrector='langevin', snr=0.075, n_steps_each=1, noise_removal=True, probability_flow=False),
    ),
    've/cifar10_ddpm': dict(
        family='ddpm',
        model=dict(nf=128, ch_mult=(1, 2, 2, 2), num_res_blocks=2, attn_resolutions=(16,), resamp_with_conv=True, conditional=True, scale_by_sigma=True, image_size=32, num_channels=3, centered=False, sigma_min=0.01, sigma_max=50, num_scales=1000),
        sde=dict(sde='vesde', continuous=False, sigma_min=0.01, sigma_max=50, beta_min=0.1, beta_max=20.0, num_scales=1000),
        sampling=dict(method='pc', predictor='reverse_diffusion', corrector='langevin', snr=0.16, n_steps_each=1, noise_removal=True, probability_flow=False),
    ),
    've/cifar10_ncsnpp': dict(
        family='ncsnpp',
        model=dict(nf=128, ch_mult=(1, 2, 2, 2), num_res_blocks=4, attn_resolutions=(16,), resamp_with_conv=True, conditional=True, fir=True, fir_kernel=(1, 3, 3, 1), skip_rescale=True, resblock_type='biggan', progressive='none', progressive_input='residual', progressive_combine='sum', embedding_type='positional', init_scale=0.0, scale_by_sigma=True, image_size=32, num_channels=3, centered=False),
        sde=dict(sde='vesde', continuous=False, sigma_min=0.01, sigma_max=50, beta_min=0.1, beta_max=20.0, num_scales=1000),
        sampling=dict(method='pc', predictor='reverse_diffusion', corrector='langevin', snr=0.16, n_steps_each=1, noise_removal=True, probability_flow=False),
    ),
    've/cifar10_ncsnpp_continuous': dict(
        family='ncsnpp',
        model=dict(nf=128, ch_mult=(1, 2, 2, 2), num_res_blocks=4, attn_resolutions=(16,), resamp_with_conv=True, conditional=True, fir=True, fir_kernel=(1, 3, 3, 1), skip_rescale=True, resblock_type='biggan', progressive='none', progressive_input='residual', progressive_combine='sum', embedding_type='fourier', fourier_scale=16, init_scale=0.0, scale_by_sigma=True, image_size=32, num_channels=3, centered=False),
        sde=dict(sde='vesde', continuous=True, sigma_min=0.01, sigma_max=50, beta_min=0.1, beta_max=20.0, num_scales=1000),
        sampling=dict(method='pc', predictor='reverse_diffusion', corrector='langevin', snr=0.16, n_steps_each=1, noise_removal=True, probability_flow=False),
    ),
    've/cifar10_ncsnpp_deep_continuous': dict(
        family='ncsnpp',
        model=dict(nf=128, ch_mult=(1, 2, 2, 2), num_res_blocks=8, attn_resolutions=(16,), resamp_with_conv=True, conditional=True, fir=True, fir_kernel=(1, 3, 3, 1), skip_rescale=True, resblock_type='biggan', progressive='none', progressive_input='residual', progressive_combine='sum', embedding_type='fourier', fourier_scale=16, init_scale=0.0, scale_by_sigma=True, image_size=32, num_channels=3, centered=False),
        sde=dict(sde='vesde', continuous=True, sigma_min=0.01, sigma_max=50, beta_min=0.1, beta_max=20.0, num_scales=1000),
        sampling=dict(method='pc', predictor='reverse_diffusion', corrector='langevin', snr=0.16, n_steps_each=1, noise_removal=True, probability_flow=False),
    ),
    've/ffhq_256_ncsnpp_continuous': dict(
        family='ncsnpp',
        model=dict(nf=128, ch_mult=(1, 1, 2, 2, 2, 2, 2), num_res_blocks=2, attn_resolutions=(16,), resamp_with_conv=True, conditional=True, fir=True, fir_kernel=(1, 3, 3, 1), skip_rescale=True, resblock_type='biggan', progressive='output_skip', progressive_input='input_skip', progressive_combine='sum', embedding_type='fourier', fourier_scale=16, init_scale=0.0, scale_by_sigma=True, image_size=256, num_channels=3, centered=False),
        sde=dict(sde='vesde', continuous=True, sigma_min=0.01, sigma_max=348, beta_min=0.1, beta_max=20.0, num_scales=2000),
        sampling=dict(method='pc', predictor='reverse_diffusion', corrector='langevin', snr=0.075, n_steps_each=1, noise_removal=True, probability_flow=False),
    ),
    've/ffhq_ncsnpp_continuous': dict(
        family='ncsnpp',
        model=dict(nf=16, ch_mult=(1, 2, 4, 8, 16, 32, 32, 32), num_res_blocks=1, attn_resolutions=(16,), resamp_with_conv=True, conditional=True, fir=True, fir_kernel=(1, 3, 3, 1), skip_rescale=True, resblock_type='biggan', progressive='output_skip', progressive_input='input_skip', progressive_combine='sum', embedding_type='fourier', fourier_scale=16, init_scale=0.0, scale_by_sigma=True, image_size=1024, num_channels=3, centered=False),
        sde=dict(sde='vesde', continuous=True, sigma_min=0.01, sigma_max=1348, beta_min=0.1, beta_max=20.0, num_scales=2000),
        sampling=dict(method='pc', predictor='reverse_diffusion', corrector='langevin', snr=0.15, n_steps_each=1, noise_removal=True, probability_flow=False),
    ),
    've/ncsn/celeba': dict(
        family='ncsn',
        model=dict(nf=128, image_size=64, num_channels=3, centered=False, sigma_min=0.01, sigma_max=1.0, num_scales=10),
        sde=dict(sde='vesde', continuous=False, sigma_min=0.01, sigma_max=1.0, beta_min=0.1, beta_max=20.0, num_scales=10),
        sampling=dict(method='pc', predictor='none', corrector='ald', snr=0.316, n_steps_each=100, noise_removal=True, probability_flow=False),
    ),
    've/ncsn/celeba_124': dict(
        family='ncsn',
        model=dict(nf=128, image_size=64, num_channels=3, centered=False, sigma_min=0.01, sigma_max=90.0, num_scales=500),
        sde=dict(sde='vesde', continuous=False, sigma_min=0.01, sigma_max=90.0, beta_min=0.1, beta_max=20.0, num_scales=500),
        sampling=dict(method='pc', predictor='none', corrector='ald', snr=0.128, n_steps_each=5, noise_removal=True, probability_flow=False),
    ),
    've/ncsn/celeba_1245': dict(
        family='ncsn',
        model=dict(nf=128, image_size=64, num_channels=3, centered=False, sigma_min=0.01, sigma_max=90.0, num_scales=500),
        sde=dict(sde='vesde', continuous=False, sigma_min=0.01, sigma_max=90.0, beta_min=0.1, beta_max=20.0, num_scales=500),
        sampling=dict(method='pc', predictor='none', corrector='ald', snr=0.128, n_steps_each=5, noise_removal=True, probability_flow=False),
    ),
    've/ncsn/celeba_5': dict(
        family='ncsn',
        model=dict(nf=128, image_size=64, num_channels=3, centered=False, sigma_min=0.01, sigma_max=1.0, num_scales=10),
        sde=dict(sde='vesde', continuous=False, sigma_min=0.01, sigma_max=1.0, beta_min=0.1, beta_max=20.0, num_scales=10),
        sampling=dict(method='pc', predictor='none', corrector='ald', snr=0.316, n_steps_each=100, noise_removal=True, probability_flow=False),
    ),
    've/ncsn/cifar10': dict(
        family='ncsn',
        model=dict(nf=128, image_size=32, num_channels=3, centered=False, sigma_min=0.01, sigma_max=1, num_scales=10),
        sde=dict(sde='vesde', continuous=False, sigma_min=0.01, sigma_max=1, beta_min=0.1, beta_max=20.0, num_scales=10),
        sampling=dict(method='pc', predictor='none', corrector='ald', snr=0.316, n_steps_each=100, noise_removal=True, probability_flow=False),
    ),
    've/ncsn/cifar10_124': dict(
        family='ncsn',
        model=dict(nf=128, image_size=32, num_channels=3, centered=False, sigma_min=0.01, sigma_max=50, num_scales=232),
        sde=dict(sde='vesde', continuous=False, sigma_min=0.01, sigma_max=50, beta_min=0.1, beta_max=20.0, num_scales=232),
        sampling=dict(method='pc', predictor='none', corrector='ald', snr=0.176, n_steps_each=5, noise_removal=True, probability_flow=False),
    ),
    've/ncsn/cifar10_1245': dict(
        family='ncsn',
        model=dict(nf=128, image_size=32, num_channels=3, centered=False, sigma_min=0.01, sigma_max=50, num_scales=232),
        sde=dict(sde='vesde', continuous=False, sigma_min=0.01, sigma_max=50, beta_min=0.1, beta_max=20.0, num_scales=232),
        sampling=dict(method='pc', predictor='none', corrector='ald', snr=0.176, n_steps_each=5, noise_removal=True, probability_flow=False),
    ),
    've/ncsn/cifar10_5': dict(
        family='ncsn',
        model=dict(nf=128, image_size=32, num_channels=3, centered=False, sigma_min=0.01, sigma_max=1, num_scales=10),
        sde=dict(sde='vesde', continuous=False, sigma_min=0.01, sigma_max=1, beta_min=0.1, beta_max=20.0, num_scales=10),
        sampling=dict(method='pc', predictor='none', corrector='ald', snr=0.316, n_steps_each=100, noise_removal=True, probability_flow=False),
    ),
    've/ncsnv2/bedroom': dict(
        family='ncsnv2_128',
        model=dict(nf=128, image_size=128, num_channels=3, centered=False, sigma_min=0.01, sigma_max=190, num_scales=1086),
        sde=dict(sde='vesde', continuous=True, sigma_min=0.01, sigma_max=190, beta_min=0.1, beta_max=20.0, num_scales=1086),
        sampling=dict(method='pc', predictor='none', corrector='ald', snr=0.095, n_steps_each=3, noise_removal=True, probability_flow=False),
    ),
    've/ncsnv2/celeba': dict(
        family='ncsnv2_64',
        model=dict(nf=128, image_size=64, num_channels=3, centered=False, sigma_min=0.01, sigma_max=90.0, num_scales=500),
        sde=dict(sde='vesde', continuous=False, sigma_min=0.01, sigma_max=90.0, beta_min=0.1, beta_max=20.0, num_scales=500),
        sampling=dict(method='pc', predictor='none', corrector='ald', snr=0.128, n_steps_each=5, noise_removal=True, probability_flow=False),
    ),
    've/ncsnv2/cifar10': dict(
        family='ncsnv2_64',
        model=dict(nf=128, image_size=32, num_channels=3, centered=False, sigma_min=0.01, sigma_max=50, num_scales=232),
        sde=dict(sde='vesde', continuous=False, sigma_min=0.01, sigma_max=50, beta_min=0.1, beta_max=20.0, num_scales=232),
        sampling=dict(method='pc', predictor='none', corrector='ald', snr=0.176, n_steps_each=5, noise_removal=True, probability_flow=False),
    ),
    'vp/cifar10_ddpmpp': dict(
        family='ncsnpp',
        model=dict(nf=128, ch_mult=(1, 2, 2, 2), num_res_blocks=4, attn_resolutions=(16,), resamp_with_conv=True, conditional=True, fir=False, fir_kernel=(1, 3, 3, 1), skip_rescale=True, resblock_type='biggan', progressive='none', progressive_input='none', progressive_combine='sum', embedding_type='positional', fourier_scale=16, init_scale=0.0, scale_by_sigma=False, image_size=32, num_channels=3, centered=True),
        sde=dict(sde='vpsde', continuous=False, sigma_min=0.01, sigma_max=50, beta_min=0.1, beta_max=20.0, num_scales=1000),
        sampling=dict(method='pc', predictor='ancestral_sampling', corrector='none', snr=0.16, n_steps_each=1, noise_removal=True, probability_flow=False),
    ),
    'vp/cifar10_ddpmpp_continuous': dict(
        family='ncsnpp',
        model=dict(nf=128, ch_mult=(1, 2, 2, 2), num_res_blocks=4, attn_resolutions=(16,), resamp_with_conv=True, conditional=True, fir=False, fir_kernel=(1, 3, 3, 1), skip_rescale=True, resblock_type='biggan', progressive='none', progressive_input='none', progressive_combine='sum', embedding_type='positional', fourier_scale=16, init_scale=0.0, scale_by_sigma=False, image_size=32, num_channels=3, centered=True),
        sde=dict(sde='vpsde', continuous=True, sigma_min=0.01, sigma_max=50, beta_min=0.1, beta_max=20.0, num_scales=1000),
        sampling=dict(method='pc', predictor='euler_maruyama', corrector='none', snr=0.16, n_steps_each=1, noise_removal=True, probability_flow=False),
    ),
    'vp/cifar10_ddpmpp_deep_continuous': dict(
        family='ncsnpp',
        model=dict(nf=128, ch_mult=(1, 2, 2, 2), num_res_blocks=8, attn_resolutions=(16,), resamp_with_conv=True, conditional=True, fir=False, fir_kernel=(1, 3, 3, 1), skip_rescale=True, resblock_type='biggan', progressive='none', progressive_input='none', progressive_combine='sum', embedding_type='positional', fourier_scale=16, init_scale=0.0, scale_by_sigma=False, image_size=32, num_channels=3, centered=True),
        sde=dict(sde='vpsde', continuous=True, sigma_min=0.01, sigma_max=50, beta_min=0.1, beta_max=20.0, num_scales=1000),
        sampling=dict(method='pc', predictor='euler_maruyama', corrector='none', snr=0.16, n_steps_each=1, noise_removal=True, probability_flow=False),
    ),
    'vp/cifar10_ncsnpp': dict(
        family='ncsnpp',
        model=dict(nf=128, ch_mult=(1, 2, 2, 2), num_res_blocks=4, attn_resolutions=(16,), resamp_with_conv=True, conditional=True, fir=True, fir_kernel=(1, 3, 3, 1), skip_rescale=True, resblock_type='biggan', progressive='none', progressive_input='residual', progressive_combine='sum', embedding_type='positional', init_scale=0.0, scale_by_sigma=False, image_size=32, num_channels=3, centered=True),
        sde=dict(sde='vpsde', continuous=False, sigma_min=0.01, sigma_max=50, beta_min=0.1, beta_max=20.0, num_scales=1000),
        sampling=dict(method='pc', predictor='reverse_diffusion', corrector='none', snr=0.16, n_steps_each=1, noise_removal=True, probability_flow=False),
    ),
    'vp/cifar10_ncsnpp_continuous': dict(
        family='ncsnpp',
        model=dict(nf=128, ch_mult=(1, 2, 2, 2), num_res_blocks=4, attn_resolutions=(16,), resamp_with_conv=True, conditional=True, fir=True, fir_kernel=(1, 3, 3, 1), skip_rescale=True, resblock_type='biggan', progressive='none', progressive_input='residual', progressive_combine='sum', embedding_type='positional', fourier_scale=16, init_scale=0.0, scale_by_sigma=False, image_size=32, num_channels=3, centered=True),
        sde=dict(sde='vpsde', continuous=True, sigma_min=0.01, sigma_max=50, beta_min=0.1, beta_max=20.0, num_scales=1000),
        sampling=dict(method='pc', predictor='euler_maruyama', corrector='none', snr=0.16, n_steps_each=1, noise_removal=True, probability_flow=False),
    ),
    'vp/cifar10_ncsnpp_deep_continuous': dict(
        family='ncsnpp',
        model=dict(nf=128, ch_mult=(1, 2, 2, 2), num_res_blocks=8, attn_resolutions=(16,), resamp_with_conv=True, conditional=True, fir=True, fir_kernel=(1, 3, 3, 1), skip_rescale=True, resblock_type='biggan', progressive='none', progressive_input='residual', progressive_combine='sum', embedding_type='positional', fourier_scale=16, init_scale=0.0, scale_by_sigma=False, image_size=32, num_channels=3, centered=True),
        sde=dict(sde='vpsde', continuous=True, sigma_min=0.01, sigma_max=50, beta_min=0.1, beta_max=20.0, num_scales=1000),
        sampling=dict(method='pc', predictor='euler_maruyama', corrector='none', snr=0.16, n_steps_each=1, noise_removal=True, probability_flow=False),
    ),
    'vp/ddpm/bedroom': dict(
        family='ddpm',
        model=dict(nf=128, ch_mult=(1, 1, 2, 2, 4, 4), num_res_blocks=2, attn_resolutions=(16,), resamp_with_conv=True, conditional=True, scale_by_sigma=False, image_size=256, num_channels=3, centered=True, sigma_min=0.01, sigma_max=378, num_scales=1000),
        sde=dict(sde='vpsde', continuous=False, sigma_min=0.01, sigma_max=378, beta_min=0.1, beta_max=20.0, num_scales=1000),
        sampling=dict(method='pc', predictor='ancestral_sampling', corrector='none', snr=0.075, n_steps_each=1, noise_removal=True, probability_flow=False),
    ),
    'vp/ddpm/celebahq': dict(
        family='ddpm',
        model=dict(nf=128, ch_mult=(1, 1, 2, 2, 4, 4), num_res_blocks=2, attn_resolutions=(16,), resamp_with_conv=True, conditional=True, scale_by_sigma=False, image_size=256, num_channels=3, centered=True, sigma_min=0.01, sigma_max=378, num_scales=1000),
        sde=dict(sde='vpsde', continuous=False, sigma_min=0.01, sigma_max=378, beta_min=0.1, beta_max=20.0, num_scales=1000),
        sampling=dict(method='pc', predictor='ancestral_sampling', corrector='none', snr=0.075, n_steps_each=1, noise_removal=True, probability_flow=False),
    ),
    'vp/ddpm/church': dict(
        family='ddpm',
        model=dict(nf=128, ch_mult=(1, 1, 2, 2, 4, 4), num_res_blocks=2, attn_resolutions=(16,), resamp_with_conv=True, conditional=True, scale_by_sigma=False, image_size=256, num_channels=3, centered=True, sigma_min=0.01, sigma_max=378, num_scales=1000),
        sde=dict(sde='vpsde', continuous=False, sigma_min=0.01, sigma_max=378, beta_min=0.1, beta_max=20.0, num_scales=1000),
        sampling=dict(method='pc', predictor='ancestral_sampling', corrector='none', snr=0.075, n_steps_each=1, noise_removal=True, probability_flow=False),
    ),
    'vp/ddpm/cifar10': dict(
        family='ddpm',
        model=dict(nf=128, ch_mult=(1, 2, 2, 2), num_res_blocks=2, attn_resolutions=(16,), resamp_with_conv=True, conditional=True, scale_by_sigma=False, image_size=32, num_channels=3, centered=True, sigma_min=0.01, sigma_max=50, num_scales=1000),
        sde=dict(sde='vpsde', continuous=False, sigma_min=0.01, sigma_max=50, beta_min=0.1, beta_max=20.0, num_scales=1000),
        sampling=dict(method='pc', predictor='ancestral_sampling', corrector='none', snr=0.16, n_steps_each=1, noise_removal=True, probability_flow=False),
    ),
    'vp/ddpm/cifar10_continuous': dict(
        family='ddpm',
        model=dict(nf=128, ch_mult=(1, 2, 2, 2), num_res_blocks=2, attn_resolutions=(16,), resamp_with_conv=True, conditional=True, scale_by_sigma=False, image_size=32, num_channels=3, centered=True, sigma_min=0.01, sigma_max=50, num_scales=1000),
        sde=dict(sde='vpsde', continuous=True, sigma_min=0.01, sigma_max=50, beta_min=0.1, beta_max=20.0, num_scales=1000),
        sampling=dict(method='pc', predictor='euler_maruyama', corrector='none', snr=0.16, n_steps_each=1, noise_removal=True, probability_flow=False),
    ),
    'vp/ddpm/cifar10_unconditional': dict(
        family='ddpm',
        model=dict(nf=128, ch_mult=(1, 2, 2, 2), num_res_blocks=2, attn_resolutions=(16,), resamp_with_conv=True, conditional=False, scale_by_sigma=False, image_size=32, num_channels=3, centered=True, sigma_min=0.01, sigma_max=50, num_scales=1000),
        sde=dict(sde='vpsde', continuous=False, sigma_min=0.01, sigma_max=50, beta_min=0.1, beta_max=20.0, num_scales=1000),
        sampling=dict(method='pc', predictor='ancestral_sampling', corrector='none', snr=0.16, n_steps_each=1, noise_removal=True, probability_flow=False),
    ),
}
# fmt: on
