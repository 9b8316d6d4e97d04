"""The NCSN++ entries of the JAX package's config zoo
(``naturaldiffusion_tpu/configs_zoo.py``): the six VE ones and the ten VP
and sub-VP CIFAR-10 ones, as preset data: the model, SDE and sampling
fields that the port reads, copied value for value (a test holds them to
``naturaldiffusion_tpu.configs.get_config`` field by field).  The
``ddpm``-family entries wait for the DDPM backbone.
The JAX entries' ``dropout`` and ``num_train_timesteps`` are left out (the
port runs inference and never reads the latter), and of the training
fields only the SDE's are kept.
"""

# fmt: off
ZOO = {
    've/celebahq_256_ncsnpp_continuous': dict(
        model=dict(nf=128, ch_mult=(1, 1, 2, 2, 2, 2, 2), num_res_blocks=2, attn_resolutions=(16,), resamp_with_conv=True, conditional=True, fir=True, fir_kernel=(1, 3, 3, 1), skip_rescale=True, resblock_type='biggan', progressive='output_skip', progressive_input='input_skip', progressive_combine='sum', embedding_type='fourier', fourier_scale=16, init_scale=0.0, scale_by_sigma=True, image_size=256, num_channels=3, centered=False),
        sde=dict(sde='vesde', continuous=True, sigma_min=0.01, sigma_max=348, num_scales=2000),
        sampling=dict(method='pc', predictor='reverse_diffusion', corrector='langevin', snr=0.075, n_steps_each=1, noise_removal=True, probability_flow=False),
    ),
    've/ffhq_256_ncsnpp_continuous': dict(
        model=dict(nf=128, ch_mult=(1, 1, 2, 2, 2, 2, 2), num_res_blocks=2, attn_resolutions=(16,), resamp_with_conv=True, conditional=True, fir=True, fir_kernel=(1, 3, 3, 1), skip_rescale=True, resblock_type='biggan', progressive='output_skip', progressive_input='input_skip', progressive_combine='sum', embedding_type='fourier', fourier_scale=16, init_scale=0.0, scale_by_sigma=True, image_size=256, num_channels=3, centered=False),
        sde=dict(sde='vesde', continuous=True, sigma_min=0.01, sigma_max=348, num_scales=2000),
        sampling=dict(method='pc', predictor='reverse_diffusion', corrector='langevin', snr=0.075, n_steps_each=1, noise_removal=True, probability_flow=False),
    ),
    've/church_ncsnpp_continuous': dict(
        model=dict(nf=128, ch_mult=(1, 1, 2, 2, 2, 2, 2), num_res_blocks=2, attn_resolutions=(16,), resamp_with_conv=True, conditional=True, fir=True, fir_kernel=(1, 3, 3, 1), skip_rescale=True, resblock_type='biggan', progressive='output_skip', progressive_input='input_skip', progressive_combine='sum', embedding_type='fourier', fourier_scale=16, init_scale=0.0, scale_by_sigma=True, image_size=256, num_channels=3, centered=False),
        sde=dict(sde='vesde', continuous=True, sigma_min=0.01, sigma_max=380, num_scales=2000),
        sampling=dict(method='pc', predictor='reverse_diffusion', corrector='langevin', snr=0.075, n_steps_each=1, noise_removal=True, probability_flow=False),
    ),
    've/bedroom_ncsnpp_continuous': dict(
        model=dict(nf=128, ch_mult=(1, 1, 2, 2, 2, 2, 2), num_res_blocks=2, attn_resolutions=(16,), resamp_with_conv=True, conditional=True, fir=True, fir_kernel=(1, 3, 3, 1), skip_rescale=True, resblock_type='biggan', progressive='output_skip', progressive_input='input_skip', progressive_combine='sum', embedding_type='fourier', fourier_scale=16, init_scale=0.0, scale_by_sigma=True, image_size=256, num_channels=3, centered=False),
        sde=dict(sde='vesde', continuous=True, sigma_min=0.01, sigma_max=378, num_scales=2000),
        sampling=dict(method='pc', predictor='reverse_diffusion', corrector='langevin', snr=0.075, n_steps_each=1, noise_removal=True, probability_flow=False),
    ),
    've/celeba_ncsnpp': dict(
        model=dict(nf=128, ch_mult=(1, 2, 2, 2), num_res_blocks=4, attn_resolutions=(16,), resamp_with_conv=True, conditional=True, fir=True, fir_kernel=(1, 3, 3, 1), skip_rescale=True, resblock_type='biggan', progressive='none', progressive_input='residual', progressive_combine='sum', embedding_type='positional', init_scale=0.0, scale_by_sigma=True, image_size=64, num_channels=3, centered=False),
        sde=dict(sde='vesde', continuous=False, sigma_min=0.01, sigma_max=90.0, num_scales=1000),
        sampling=dict(method='pc', predictor='reverse_diffusion', corrector='langevin', snr=0.17, n_steps_each=1, noise_removal=True, probability_flow=False),
    ),
    've/cifar10_ncsnpp_continuous': dict(
        model=dict(nf=128, ch_mult=(1, 2, 2, 2), num_res_blocks=4, attn_resolutions=(16,), resamp_with_conv=True, conditional=True, fir=True, fir_kernel=(1, 3, 3, 1), skip_rescale=True, resblock_type='biggan', progressive='none', progressive_input='residual', progressive_combine='sum', embedding_type='fourier', fourier_scale=16, init_scale=0.0, scale_by_sigma=True, image_size=32, num_channels=3, centered=False),
        sde=dict(sde='vesde', continuous=True, sigma_min=0.01, sigma_max=50, num_scales=1000),
        sampling=dict(method='pc', predictor='reverse_diffusion', corrector='langevin', snr=0.16, n_steps_each=1, noise_removal=True, probability_flow=False),
    ),
    'vp/cifar10_ddpmpp': dict(
        model=dict(nf=128, ch_mult=(1, 2, 2, 2), num_res_blocks=4, attn_resolutions=(16,), resamp_with_conv=True, conditional=True, fir=False, fir_kernel=(1, 3, 3, 1), skip_rescale=True, resblock_type='biggan', progressive='none', progressive_input='none', progressive_combine='sum', embedding_type='positional', fourier_scale=16, init_scale=0.0, scale_by_sigma=False, image_size=32, num_channels=3, centered=True),
        sde=dict(sde='vpsde', continuous=False, beta_min=0.1, beta_max=20.0, num_scales=1000),
        sampling=dict(method='pc', predictor='ancestral_sampling', corrector='none', snr=0.16, n_steps_each=1, noise_removal=True, probability_flow=False),
    ),
    'vp/cifar10_ncsnpp': dict(
        model=dict(nf=128, ch_mult=(1, 2, 2, 2), num_res_blocks=4, attn_resolutions=(16,), resamp_with_conv=True, conditional=True, fir=True, fir_kernel=(1, 3, 3, 1), skip_rescale=True, resblock_type='biggan', progressive='none', progressive_input='residual', progressive_combine='sum', embedding_type='positional', init_scale=0.0, scale_by_sigma=False, image_size=32, num_channels=3, centered=True),
        sde=dict(sde='vpsde', continuous=False, beta_min=0.1, beta_max=20.0, num_scales=1000),
        sampling=dict(method='pc', predictor='reverse_diffusion', corrector='none', snr=0.16, n_steps_each=1, noise_removal=True, probability_flow=False),
    ),
    'vp/cifar10_ddpmpp_continuous': dict(
        model=dict(nf=128, ch_mult=(1, 2, 2, 2), num_res_blocks=4, attn_resolutions=(16,), resamp_with_conv=True, conditional=True, fir=False, fir_kernel=(1, 3, 3, 1), skip_rescale=True, resblock_type='biggan', progressive='none', progressive_input='none', progressive_combine='sum', embedding_type='positional', fourier_scale=16, init_scale=0.0, scale_by_sigma=False, image_size=32, num_channels=3, centered=True),
        sde=dict(sde='vpsde', continuous=True, beta_min=0.1, beta_max=20.0, num_scales=1000),
        sampling=dict(method='pc', predictor='euler_maruyama', corrector='none', snr=0.16, n_steps_each=1, noise_removal=True, probability_flow=False),
    ),
    'vp/cifar10_ncsnpp_continuous': dict(
        model=dict(nf=128, ch_mult=(1, 2, 2, 2), num_res_blocks=4, attn_resolutions=(16,), resamp_with_conv=True, conditional=True, fir=True, fir_kernel=(1, 3, 3, 1), skip_rescale=True, resblock_type='biggan', progressive='none', progressive_input='residual', progressive_combine='sum', embedding_type='positional', fourier_scale=16, init_scale=0.0, scale_by_sigma=False, image_size=32, num_channels=3, centered=True),
        sde=dict(sde='vpsde', continuous=True, beta_min=0.1, beta_max=20.0, num_scales=1000),
        sampling=dict(method='pc', predictor='euler_maruyama', corrector='none', snr=0.16, n_steps_each=1, noise_removal=True, probability_flow=False),
    ),
    'vp/cifar10_ddpmpp_deep_continuous': dict(
        model=dict(nf=128, ch_mult=(1, 2, 2, 2), num_res_blocks=8, attn_resolutions=(16,), resamp_with_conv=True, conditional=True, fir=False, fir_kernel=(1, 3, 3, 1), skip_rescale=True, resblock_type='biggan', progressive='none', progressive_input='none', progressive_combine='sum', embedding_type='positional', fourier_scale=16, init_scale=0.0, scale_by_sigma=False, image_size=32, num_channels=3, centered=True),
        sde=dict(sde='vpsde', continuous=True, beta_min=0.1, beta_max=20.0, num_scales=1000),
        sampling=dict(method='pc', predictor='euler_maruyama', corrector='none', snr=0.16, n_steps_each=1, noise_removal=True, probability_flow=False),
    ),
    'vp/cifar10_ncsnpp_deep_continuous': dict(
        model=dict(nf=128, ch_mult=(1, 2, 2, 2), num_res_blocks=8, attn_resolutions=(16,), resamp_with_conv=True, conditional=True, fir=True, fir_kernel=(1, 3, 3, 1), skip_rescale=True, resblock_type='biggan', progressive='none', progressive_input='residual', progressive_combine='sum', embedding_type='positional', fourier_scale=16, init_scale=0.0, scale_by_sigma=False, image_size=32, num_channels=3, centered=True),
        sde=dict(sde='vpsde', continuous=True, beta_min=0.1, beta_max=20.0, num_scales=1000),
        sampling=dict(method='pc', predictor='euler_maruyama', corrector='none', snr=0.16, n_steps_each=1, noise_removal=True, probability_flow=False),
    ),
    'subvp/cifar10_ddpmpp_continuous': dict(
        model=dict(nf=128, ch_mult=(1, 2, 2, 2), num_res_blocks=4, attn_resolutions=(16,), resamp_with_conv=True, conditional=True, fir=False, fir_kernel=(1, 3, 3, 1), skip_rescale=True, resblock_type='biggan', progressive='none', progressive_input='none', progressive_combine='sum', embedding_type='positional', fourier_scale=16, init_scale=0.0, scale_by_sigma=False, image_size=32, num_channels=3, centered=True),
        sde=dict(sde='subvpsde', continuous=True, beta_min=0.1, beta_max=20.0, num_scales=1000),
        sampling=dict(method='pc', predictor='euler_maruyama', corrector='none', snr=0.16, n_steps_each=1, noise_removal=True, probability_flow=False),
    ),
    'subvp/cifar10_ncsnpp_continuous': dict(
        model=dict(nf=128, ch_mult=(1, 2, 2, 2), num_res_blocks=4, attn_resolutions=(16,), resamp_with_conv=True, conditional=True, fir=True, fir_kernel=(1, 3, 3, 1), skip_rescale=True, resblock_type='biggan', progressive='none', progressive_input='residual', progressive_combine='sum', embedding_type='positional', fourier_scale=16, init_scale=0.0, scale_by_sigma=False, image_size=32, num_channels=3, centered=True),
        sde=dict(sde='subvpsde', continuous=True, beta_min=0.1, beta_max=20.0, num_scales=1000),
        sampling=dict(method='pc', predictor='euler_maruyama', corrector='none', snr=0.16, n_steps_each=1, noise_removal=True, probability_flow=False),
    ),
    'subvp/cifar10_ddpmpp_deep_continuous': dict(
        model=dict(nf=128, ch_mult=(1, 2, 2, 2), num_res_blocks=8, attn_resolutions=(16,), resamp_with_conv=True, conditional=True, fir=False, fir_kernel=(1, 3, 3, 1), skip_rescale=True, resblock_type='biggan', progressive='none', progressive_input='none', progressive_combine='sum', embedding_type='positional', fourier_scale=16, init_scale=0.0, scale_by_sigma=False, image_size=32, num_channels=3, centered=True),
        sde=dict(sde='subvpsde', continuous=True, beta_min=0.1, beta_max=20.0, num_scales=1000),
        sampling=dict(method='pc', predictor='euler_maruyama', corrector='none', snr=0.16, n_steps_each=1, noise_removal=True, probability_flow=False),
    ),
    'subvp/cifar10_ncsnpp_deep_continuous': dict(
        model=dict(nf=128, ch_mult=(1, 2, 2, 2), num_res_blocks=8, attn_resolutions=(16,), resamp_with_conv=True, conditional=True, fir=True, fir_kernel=(1, 3, 3, 1), skip_rescale=True, resblock_type='biggan', progressive='none', progressive_input='residual', progressive_combine='sum', embedding_type='positional', fourier_scale=16, init_scale=0.0, scale_by_sigma=False, image_size=32, num_channels=3, centered=True),
        sde=dict(sde='subvpsde', continuous=True, beta_min=0.1, beta_max=20.0, num_scales=1000),
        sampling=dict(method='pc', predictor='euler_maruyama', corrector='none', snr=0.16, n_steps_each=1, noise_removal=True, probability_flow=False),
    ),
}
# fmt: on
