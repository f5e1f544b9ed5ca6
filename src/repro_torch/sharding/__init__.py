"""Sharding policies and named shardings over the port's slot meshes."""
from repro_torch.sharding.policy import (  # noqa: F401
    POLICIES,
    NamedSharding,
    PartitionSpec,
    ShardingPolicy,
    cache_policy,
    fit_sharding,
    fit_shardings_tree,
    fit_spec,
    get_policy,
    logical_spec,
    state_shardings,
)
