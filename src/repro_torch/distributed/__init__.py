from repro_torch.distributed.sharding import (  # noqa: F401
    MeshShape, cache_needs_seq_shard, constrain, distribute,
    distribute_tree, full_host, is_axes, local_kernel, logical_sharding,
    make_rules, placements_of, resolve, resolve_axes,
    suspend_logical_sharding, tree_placements,
)
