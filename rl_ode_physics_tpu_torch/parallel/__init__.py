"""Batches of independent worlds, and their world axis split over cards."""

from rl_ode_physics_tpu_torch.parallel.batch import (
    replicate, batched_step, make_batched_step_fn,
)
from rl_ode_physics_tpu_torch.parallel.mesh import (
    make_mesh, batch_sharding, shard_batch, gather_batch,
    make_sharded_step_fn, make_shard_map_step_fn, WORLD_AXIS,
)
