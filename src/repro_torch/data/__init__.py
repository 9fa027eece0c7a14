from repro_torch.data.pipeline import (  # noqa: F401
    DeviceLoader,
    ShardedLoader,
    SyntheticTokens,
    rank_batch,
    to_device,
)
