"""Distribution: elastic serving groups (``ElasticServeGroups``).  The
reference's mesh sharding and training elasticity come with ROADMAP.md
item A11."""
from repro_torch.distributed.elastic import ElasticServeGroups  # noqa: F401
