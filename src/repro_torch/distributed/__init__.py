"""Distribution: sharding rules on DTensor placements, collectives,
pipeline parallelism and the mesh backend (the port of
``src/repro/distributed``)."""
from .mesh_backend import (DEFAULT_PLACEMENTS, MeshBackend,
                           mesh_cost_terms, placement_specs)
from .sharding import (AbstractMesh, MeshPolicy, NamedSharding,
                       ShardingRules, abstract_mesh, batch_axes, batch_specs,
                       cache_shardings, distribute, make_rules, placements,
                       spec_for_axes, tree_shardings)

__all__ = ["DEFAULT_PLACEMENTS", "MeshBackend", "mesh_cost_terms",
           "placement_specs", "AbstractMesh", "MeshPolicy", "NamedSharding", "ShardingRules",
           "abstract_mesh", "batch_axes", "batch_specs", "cache_shardings",
           "distribute", "make_rules", "placements", "spec_for_axes",
           "tree_shardings"]
