"""Shared helpers: parameter declarations, the default device, the
runtime guards and the sharding rules."""
from .guards import (CompileGuard, device_get, global_compile_count,
                     no_host_sync, record_compile, strict_numerics)
from .params import (ParamDecl, cast_tree, default_device, gather_tree,
                     init_params, param_specs, param_structs, shard_tree,
                     tree_bytes)
from .sharding import (ShardingRules, active_mesh, active_rules, base_rules,
                       logical_shard, query_axis_info, query_mesh,
                       query_rules, use_mesh)

__all__ = ["CompileGuard", "ParamDecl", "ShardingRules", "active_mesh",
           "active_rules", "base_rules", "cast_tree", "default_device",
           "device_get", "gather_tree", "global_compile_count",
           "init_params", "logical_shard", "no_host_sync", "param_specs",
           "param_structs", "query_axis_info", "query_mesh", "query_rules",
           "record_compile", "shard_tree", "strict_numerics", "tree_bytes",
           "use_mesh"]
