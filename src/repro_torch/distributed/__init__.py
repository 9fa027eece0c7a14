"""Distribution: logical-axis sharding over a device mesh
(``sharding.py``, the mesh itself in ``launch/mesh.py``), elastic
re-meshing of training after a failure (``ElasticRunner``) and elastic
serving groups (``ElasticServeGroups``)."""
from repro_torch.distributed.elastic import (  # noqa: F401
    ElasticRunner,
    ElasticServeGroups,
    MeshPlan,
    plan_remesh,
)
from repro_torch.distributed.sharding import (  # noqa: F401
    batch_axes,
    current_mesh,
    maybe_axis,
    set_current_mesh,
    shard,
    shard_map,
)
