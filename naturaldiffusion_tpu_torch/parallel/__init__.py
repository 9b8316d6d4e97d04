"""Parallelism over ``torch.distributed``: meshes, shardings and the
multi-rank dry run (port of ``naturaldiffusion_tpu/parallel``)."""

from .mesh import (make_mesh, named, replicated, batch_sharding, shard_batch,
                   fold_in_shard)
from .shardings import (dit_tp_sharding, mmdit_tp_sharding, tp_sharding,
                        replicate_tree, constrain_tokens, fsdp_sharding)

__all__ = ["make_mesh", "named", "replicated", "batch_sharding",
           "shard_batch", "fold_in_shard", "dit_tp_sharding",
           "mmdit_tp_sharding", "tp_sharding", "replicate_tree",
           "constrain_tokens", "fsdp_sharding"]
