"""Tensor-parallel serving's mesh and placements.

Counterpart of the serving part of paddle_tpu/parallel: `Mesh`,
`serving_mesh`, `replica_submeshes` (parallel/mesh.py) and `SpecLayout`
(parallel/compat.py). The training meshes (`init_mesh`, `ProcessMesh`,
`current_mesh`, `mesh_scope`) and the parallelize plans are ROADMAP.md
'Still to port' item 13.
"""

from paddle_tpu_torch.parallel.compat import PartitionSpec, SpecLayout
from paddle_tpu_torch.parallel.mesh import (
    Mesh, all_gather, psum, replica_submeshes, serving_mesh,
)

__all__ = ["Mesh", "PartitionSpec", "SpecLayout", "all_gather", "psum",
           "replica_submeshes", "serving_mesh"]
