"""Toy sizes of the configurations for the CPU rehearsals (published
widths stay in ``benchmark/configs``; these only shrink them)."""

import copy

from benchmark.harness.core import BENCH, read_json

CIFAR_SPEC = dict(nf=32, ch_mult=[1, 2], num_res_blocks=1,
                  attn_resolutions=[8], image_size=16, steps=3)
# at these sizes the port in bfloat16 reads 0.5e-2 to 2e-2 against the
# float32 reference (CPU); the cells' own limits are for their own sizes
TOY_LIMIT = 0.05
CIFAR_TRAFFIC = dict(sweep=8, micro=4, check_answers=2,
                     limits={"sample_rel_l2": TOY_LIMIT})


def sd3_spec():
    s = read_json(BENCH / "configs" / "sd3-medium.json")
    return dict(
        mmdit=dict(s["mmdit"], sample_size=16, hidden_size=64, depth=2,
                   num_heads=4, caption_projection_dim=64,
                   joint_attention_dim=96, pooled_projection_dim=48,
                   pos_embed_max_size=24),
        clip_l=dict(s["clip_l"], hidden_size=32, num_layers=2, num_heads=2,
                    intermediate_size=64, projection_dim=16),
        clip_g=dict(s["clip_g"], hidden_size=32, num_layers=2, num_heads=2,
                    intermediate_size=64, projection_dim=32),
        t5=dict(s["t5"], d_model=96, d_kv=8, d_ff=64, num_layers=2,
                num_heads=4),
        vae=dict(s["vae"], base_channels=32, ch_mult=[1, 2]),
        clip_tokens=8, t5_tokens=8, steps=4)


SD3_LIMITS = {"cond_rel_l2": TOY_LIMIT, "latent_rel_l2": TOY_LIMIT,
              "image_rel_l2": TOY_LIMIT}
SD3_TRAFFIC = {"sd3m-1024-t2i": dict(latent=16, limits=SD3_LIMITS),
               "sd3m-512-b4": dict(latent=8, batch=2, limits=SD3_LIMITS)}


def overrides(cell):
    """``(spec_override, traffic_override)`` of ``cell`` at toy size."""
    if cell.startswith("cifar"):
        return copy.deepcopy(CIFAR_SPEC), copy.deepcopy(CIFAR_TRAFFIC)
    return sd3_spec(), copy.deepcopy(SD3_TRAFFIC[cell])
