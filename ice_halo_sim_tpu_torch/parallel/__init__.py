from ice_halo_sim_tpu_torch.parallel.sharding import ShardedEngine, make_mesh  # noqa: F401
