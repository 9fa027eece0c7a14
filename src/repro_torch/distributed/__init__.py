"""Distribution: elastic serving groups (``ElasticServeGroups``).  The
reference's mesh sharding and training elasticity come with ROADMAP.md
items A10 and A11."""
from repro_torch.distributed.elastic import ElasticServeGroups  # noqa: F401
