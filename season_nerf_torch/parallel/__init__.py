from season_nerf_torch.parallel.mesh import (  # noqa: F401
    Mesh, make_mesh, batch_sharding, replicated_sharding, shard_batch,
    launch,
)
