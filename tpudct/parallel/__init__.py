"""Multi-chip parallelism.

The reference is strictly single-GPU/single-process — its only parallelism
is the CUDA grid of independent 8x8 blocks and its only "communication" is
cudaMemcpy (SURVEY.md §2 rows 19-20; no NCCL/MPI symbol exists in the
tree).  Here distribution is first-class: images shard as row-bands of
8-row multiples over a `jax.sharding.Mesh`, compute runs under
`jax.shard_map` with zero halo (blocks are independent), metrics reduce
with `psum`, and reassembly is an XLA `all_gather` (NCCL on the GPU) kept
off the critical path.
"""

from tpudct.parallel.mesh import band_mesh, band_spec, distributed_init, grid_mesh, grid_spec
from tpudct.parallel.sharding import (
    save_color_sharded,
    save_sharded,
    shard_batch,
    shard_image,
    shard_image_grid,
    shard_rgb,
    shard_rgb_grid,
    sharded_color_encode,
    sharded_color_step,
    sharded_color_step_grid,
    sharded_roundtrip,
    sharded_codec_step,
    sharded_serving_step,
    sharded_codec_step_grid,
    gather,
)
from tpudct.parallel.scaling import scaling_table

__all__ = [
    "band_mesh",
    "distributed_init",
    "band_spec",
    "grid_mesh",
    "grid_spec",
    "save_color_sharded",
    "save_sharded",
    "shard_batch",
    "shard_image",
    "shard_image_grid",
    "shard_rgb",
    "shard_rgb_grid",
    "sharded_color_encode",
    "sharded_color_step",
    "sharded_color_step_grid",
    "sharded_roundtrip",
    "sharded_codec_step",
    "sharded_serving_step",
    "sharded_codec_step_grid",
    "gather",
    "scaling_table",
]
