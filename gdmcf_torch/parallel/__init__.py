"""The (dp, mp) mesh on torch.distributed: the mesh, the sharding rules, the
sharded lookup, the mesh forms of the sharded ops, the multi-process
runtime."""

from gdmcf_torch.parallel.mesh import make_mesh
from gdmcf_torch.parallel.sharding import (DEFAULT_RULES, batch_spec,
                                           param_specs, shard_params)

__all__ = ["make_mesh", "DEFAULT_RULES", "batch_spec", "param_specs",
           "shard_params"]
